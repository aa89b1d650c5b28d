#!/usr/bin/env bash
# Stop everything system_start_torch.sh spawned (the port's twin of
# system_stop.sh).
#
# Usage: system_stop_torch.sh [--state-file PATH]
set -euo pipefail
exec python -m aiko_services_tpu_torch system stop "$@"
