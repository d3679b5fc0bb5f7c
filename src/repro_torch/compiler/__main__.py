"""``python -m repro_torch.compiler`` -> the port's plaid-compile CLI (the
same as ``python -m repro_torch``; :mod:`repro_torch.compiler.cli`)."""
import sys

from repro_torch.compiler.cli import main

if __name__ == "__main__":
    sys.exit(main())
