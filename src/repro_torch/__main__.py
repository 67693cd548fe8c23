"""``python -m repro_torch`` — the umbrella CLI (:mod:`repro_torch.launch.cli`)."""

import sys

from repro_torch.launch.cli import main

if __name__ == "__main__":
    sys.exit(main())
