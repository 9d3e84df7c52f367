"""``python -m repro_torch.gateway.validate``: the sim-vs-live report."""
import sys

from repro_torch.gateway.validate import main

if __name__ == "__main__":
    sys.exit(main())
