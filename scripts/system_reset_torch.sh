#!/usr/bin/env bash
# Clear durable bootstrap state (the retained registrar boot topic) through
# the PyTorch port (the port's twin of system_reset.sh).
#
# Usage: system_reset_torch.sh [--transport memory|mqtt]
set -euo pipefail
exec python -m aiko_services_tpu_torch system reset "$@"
