"""``python -m repro_torch.launch.serve``: the closed-loop serving driver."""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
