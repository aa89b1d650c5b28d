# graft-check CLI for the port: `python -m aiko_services_tpu_torch.analysis`
#
#   --pipeline DEF.json    contract-check pipeline definitions (repeat)
#   --lint PATH            lint files/directories (repeat)
#   --self-check           the port's own CI gate: lint the port package
#                          + chip_smoke.py, run the
#                          interprocedural effect analysis, the
#                          metric-drift and wire-schema checkers, the
#                          bundled example pipelines, and the stale-
#                          waiver audit
#   --codec KEY=CODEC      wire codec hints for --pipeline checks
#   --format text|json     output format
#   --strict               treat warnings as errors
#   --baseline FILE        subtract acknowledged findings (see
#                          analysis/baseline.py); new findings still
#                          gate
#   --update-baseline      regenerate the baseline file from the
#                          current findings and exit 0
#   --update-wire-lock     regenerate analysis/wire_schema.lock from
#                          the declared wire constants and exit 0
#   --rules                print the lint rule catalog (each rule
#                          beside its JAX counterpart) and exit
#
# Exit status: 0 = clean (warnings allowed unless --strict), 1 = findings
# at gating severity, 2 = usage error.

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .baseline import apply_baseline, load_baseline, write_baseline
from .drift import (metric_drift_findings, wire_schema_findings,
                    write_wire_lock)
from .effects import effect_findings
from .findings import ERROR, format_findings
from .graph_check import check_pipeline_file
from .lint import WaiverLog, lint_paths, rule_catalog

__all__ = ["main", "self_check_findings"]


def _package_root() -> Path:
    return Path(__file__).resolve().parents[1]


def _repo_root() -> Path:
    return _package_root().parent


def _looks_like_pipeline(pathname: Path) -> bool:
    try:
        data = json.loads(pathname.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return False
    return isinstance(data, dict) and "graph" in data and \
        "elements" in data


def _self_check_paths() -> list:
    """The port's own lint surface: the port package and
    chip_smoke.py, the script that drives it on the card."""
    paths = [_package_root()]
    candidate = _repo_root() / "chip_smoke.py"
    if candidate.exists():
        paths.append(candidate)
    return paths


def self_check_findings(waiver_log: WaiverLog | None = None) -> list:
    """The port's own gate, all layers sharing one waiver log: the
    syntactic lint, the interprocedural effect analysis (call-graph
    propagation of blocking/transfer/alloc/wall-clock reach), the
    metric-drift and wire-schema drift checkers, the declared wire
    transfer schemas, the bundled example pipelines, and finally the
    stale-waiver audit over everything the passes recorded."""
    from .callgraph import iter_python_files
    from .graph_check import check_wire_schemas
    waiver_log = waiver_log if waiver_log is not None else WaiverLog()
    root = _repo_root()
    paths = _self_check_paths()
    findings = lint_paths(paths, waiver_log=waiver_log)
    findings.extend(effect_findings(paths, root=root,
                                    waiver_log=waiver_log))
    files = list(iter_python_files(paths))
    findings.extend(metric_drift_findings(files, root,
                                          waiver_log=waiver_log))
    findings.extend(wire_schema_findings(root))
    findings.extend(check_wire_schemas())
    examples = root / "examples"
    if examples.is_dir():
        for pathname in sorted(examples.rglob("*.json")):
            if _looks_like_pipeline(pathname):
                findings.extend(check_pipeline_file(str(pathname)))
    findings.extend(waiver_log.stale_findings())
    return findings


def _parse_codecs(entries) -> dict:
    hints = {}
    for entry in entries or []:
        key, _, codec = entry.partition("=")
        if not key or not codec:
            raise ValueError(f"--codec wants KEY=CODEC, got {entry!r}")
        hints[key] = codec
    return hints


def _resolve_baseline(argument: str) -> Path:
    """A relative --baseline resolves against the cwd first, then the
    package root — so the documented invocation
    `--baseline analysis/baseline.json` works from the repo root."""
    path = Path(argument)
    if path.is_absolute() or path.exists():
        return path
    fallback = _package_root() / argument
    return fallback if fallback.exists() else path


def _print_rule_catalog() -> None:
    for rule_id, severity, doc, example, jax in rule_catalog():
        print(f"{rule_id:<24} {severity:<8} {doc}")  # graft: disable=lint-print
        if example:
            print(f"{'':<24} example: {example}")  # graft: disable=lint-print
        print(f"{'':<24} JAX: {jax or 'none (port only)'}")  # graft: disable=lint-print


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m aiko_services_tpu_torch.analysis",
        description="graft-check for the PyTorch port: static pipeline "
                    "contract checker and event-loop lint")
    parser.add_argument("--pipeline", action="append", default=[],
                        metavar="DEF.json",
                        help="pipeline definition to contract-check")
    parser.add_argument("--lint", action="append", default=[],
                        metavar="PATH",
                        help="file or directory to lint (recursive)")
    parser.add_argument("--self-check", action="store_true",
                        help="run every analysis layer over the repo "
                             "(lint, effects, drift, examples)")
    parser.add_argument("--codec", action="append", default=[],
                        metavar="KEY=CODEC",
                        help="wire codec hint for --pipeline checks")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--strict", action="store_true",
                        help="warnings gate too")
    parser.add_argument("--baseline", metavar="FILE",
                        help="subtract acknowledged findings; new "
                             "findings still gate")
    parser.add_argument("--update-baseline", action="store_true",
                        help="regenerate --baseline FILE from the "
                             "current findings and exit 0")
    parser.add_argument("--update-wire-lock", action="store_true",
                        help="regenerate analysis/wire_schema.lock "
                             "and exit 0")
    parser.add_argument("--rules", action="store_true",
                        help="print the lint rule catalog and exit")
    args = parser.parse_args(argv)
    if args.rules:
        _print_rule_catalog()
        return 0
    if args.update_wire_lock:
        lock_path = write_wire_lock()
        # CLI user-facing output: graft: disable=lint-print
        print(f"graft-check: wrote {lock_path}")
        return 0
    if args.update_baseline and not args.baseline:
        print("--update-baseline needs --baseline FILE",
              file=sys.stderr)                # graft: disable=lint-print
        return 2
    if not (args.pipeline or args.lint or args.self_check):
        parser.print_usage(sys.stderr)
        # CLI user-facing output, not telemetry: graft: disable=lint-print
        print("nothing to do: give --pipeline, --lint, or --self-check",
              file=sys.stderr)
        return 2
    try:
        wire_codecs = _parse_codecs(args.codec)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)    # graft: disable=lint-print
        return 2

    findings = []
    for pathname in args.pipeline:
        findings.extend(check_pipeline_file(pathname,
                                            wire_codecs=wire_codecs))
    if args.lint:
        findings.extend(lint_paths(args.lint))
    if args.self_check:
        findings.extend(self_check_findings())

    if args.baseline:
        baseline_path = _resolve_baseline(args.baseline)
        if args.update_baseline:
            write_baseline(baseline_path, findings, _repo_root())
            # CLI user-facing output: graft: disable=lint-print
            print(f"graft-check: wrote {len(findings)} finding(s) to "
                  f"{baseline_path}")
            return 0
        try:
            entries = load_baseline(baseline_path)
        except (OSError, ValueError) as exc:
            print(f"graft-check: {exc}",
                  file=sys.stderr)            # graft: disable=lint-print
            return 2
        findings = apply_baseline(findings, entries, _repo_root(),
                                  baseline_path)

    if findings or args.format == "json":
        # json mode always emits a document ("[]" when clean) so
        # machine consumers can parse it — graft: disable=lint-print
        print(format_findings(findings, args.format))
    gating = [f for f in findings
              if f.severity == ERROR or args.strict]
    summary = f"graft-check: {len(findings)} finding(s), " \
              f"{len([f for f in findings if f.severity == ERROR])} " \
              f"error(s)"
    if args.format == "text":
        print(summary)                      # graft: disable=lint-print
    return 1 if gating else 0
