"""``python -m repro_torch.core.tracing --check PATH``: validate a Chrome
trace export."""
import sys

from repro_torch.core.tracing import main

if __name__ == "__main__":
    sys.exit(main())
