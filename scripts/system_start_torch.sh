#!/usr/bin/env bash
# One-command control-plane bring-up on the PyTorch port: mosquitto (when
# --transport mqtt and available) + registrar + recorder + storage, each a
# `python -m aiko_services_tpu_torch` child.  The port's twin of
# system_start.sh.
#
# Usage: system_start_torch.sh [--transport memory|mqtt] [--services a,b,c]
#                              [--state-file PATH]
set -euo pipefail
exec python -m aiko_services_tpu_torch system start "$@"
