"""``python -m repro_torch.core.tracesim``: the five-model comparison."""
from repro_torch.core.tracesim import main

if __name__ == "__main__":
    main()
