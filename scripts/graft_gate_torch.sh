#!/bin/sh
# graft_gate_torch.sh: the PyTorch port's one-command static-analysis gate.
#
# Runs every graft-check layer of the port (syntactic lint, effect
# analysis, metric/wire drift, example pipelines, stale-waiver audit) over
# aiko_services_tpu_torch/ and chip_smoke.py, in strict mode against the
# port's committed baseline, so only NEW findings fail.
#
# Exit 0 = clean at HEAD (tests/test_torch_graft_gate.py asserts this),
# 1 = new findings, 2 = usage/setup error.
set -eu
cd "$(dirname "$0")/.."
exec python -m aiko_services_tpu_torch.analysis --self-check --strict \
    --baseline aiko_services_tpu_torch/analysis/baseline.json "$@"
