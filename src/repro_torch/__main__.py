"""``python -m repro_torch verify|store ...`` (see :mod:`repro_torch.compiler.cli`)."""
import sys

from repro_torch.compiler.cli import main

if __name__ == "__main__":
    sys.exit(main())
