"""``python -m repro_torch.launch.serve``: the serving driver (closed loop, or
the open-loop gateway with ``--gateway``)."""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
