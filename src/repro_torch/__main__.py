"""``python -m repro_torch list|compile|inspect|diff|verify|store ...`` (see
:mod:`repro_torch.compiler.cli`)."""
import sys

from repro_torch.compiler.cli import main

if __name__ == "__main__":
    sys.exit(main())
