# `python -m aiko_services_tpu_torch.analysis ...` — the graft-check CLI.

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
