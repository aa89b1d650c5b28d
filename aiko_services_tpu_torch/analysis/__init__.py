# graft-check for the PyTorch port: static analysis for the port's
# pipeline framework, its host plane and its kernel seams.
#
# The port's own copy of the JAX package's graft-check, with its own
# baseline and wire-schema lock.  The rules that match a JAX idiom
# match its torch counterpart here (the `--rules` catalog names each
# pair); every other rule is carried over as it is.
#
# Five layers, one CLI (`python -m aiko_services_tpu_torch.analysis`):
#   * graph_check — contract-check a PipelineDefinition without
#     instantiating elements (dataflow, name mappings, dtype/shape/codec
#     contracts, remote-hop wire codec legality);
#   * lint — AST rules over package and user element files (blocking
#     calls in event-loop handlers, raw locks, validation asserts,
#     publish-under-lock, compile/graph-capture-in-frame, kernel
#     wrappers without their plain version);
#   * effects — whole-package call graph (callgraph.py) with per-function
#     effect sets propagated transitively, so a blocking/allocating/
#     transferring leaf is reported at every event-loop or hot-path root
#     that can reach it, with the root-to-leaf provenance chain;
#   * drift — metric families consumed vs created (lint-metric-drift)
#     and the wire envelope vs the committed wire_schema.lock
#     (lint-wire-schema);
#   * baseline — committed findings fingerprints so `--strict` can gate
#     on NEW findings without a big-bang cleanup of acknowledged debt.
# The runtime lock-order detector lives in utils/lock.py (opt-in via
# AIKO_LOCK_CHECK=1) — the dynamic complement to these static layers.
#
# Findings are structured (rule id, severity, file:line, provenance
# chain) so CI gates on them; `--rules` prints the rule catalog.

from .findings import (                                     # noqa: F401
    ERROR, WARNING, INFO, Finding, format_findings, has_errors,
)
from .contracts import (                                    # noqa: F401
    Alt, ContractError, compatible, parse_contract,
)
from .graph_check import (                                  # noqa: F401
    check_definition, check_pipeline_file,
)
from .lint import (                                         # noqa: F401
    LINT_RULES, WaiverLog, lint_file, lint_paths, lint_source,
    rule_catalog,
)
from .callgraph import build_graph, iter_python_files       # noqa: F401
from .effects import EFFECT_RULES, effect_findings          # noqa: F401
from .drift import (                                        # noqa: F401
    METRIC_DRIFT_ALLOWLIST, metric_drift_findings,
    wire_schema_findings, wire_schema_snapshot, write_wire_lock,
)
from .baseline import (                                     # noqa: F401
    apply_baseline, fingerprint, load_baseline, write_baseline,
)
from .cli import main, self_check_findings                  # noqa: F401

__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "format_findings",
    "has_errors", "Alt", "ContractError", "compatible", "parse_contract",
    "check_definition", "check_pipeline_file",
    "LINT_RULES", "WaiverLog", "lint_file", "lint_paths", "lint_source",
    "rule_catalog", "build_graph", "iter_python_files",
    "EFFECT_RULES", "effect_findings",
    "METRIC_DRIFT_ALLOWLIST", "metric_drift_findings",
    "wire_schema_findings", "wire_schema_snapshot", "write_wire_lock",
    "apply_baseline", "fingerprint", "load_baseline", "write_baseline",
    "main", "self_check_findings",
]
