# `python -m aiko_services_tpu_torch ...` — the port's command line
# (cli.py).

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
