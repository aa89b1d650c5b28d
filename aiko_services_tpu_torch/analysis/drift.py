# Drift checkers: metric names and the wire envelope.
#
# Two surfaces no import or test checks on its own:
#
#   * metric family names consumed by chip_smoke.py, the autoscaler,
#     the dashboard and observe/ with no cross-check against their
#     registry creation sites — a renamed `serving_itl_seconds` ships
#     silently and every consumer reads 0 forever.
#     `lint-metric-drift` cross-references the two sides over the
#     port's own creators and consumers.  The mention corpus adds
#     every tests/*.py file, the JAX package's tests included: a
#     family a test reads is consumed, whichever package the test
#     drives (the JAX package's drift counts the same files).
#
#   * a wire envelope whose field list (buffer marker, trace marker,
#     tenant marker, the ninth "chunk" param, codec tables, hop entry
#     arity) is kept compatible only by convention.
#     `lint-wire-schema` snapshots the declared constants from
#     transport/wire.py and compares them against a COMMITTED lock
#     file (analysis/wire_schema.lock), so any envelope change is an
#     explicit two-sided diff: change the constant AND regenerate the
#     lock (`python -m aiko_services_tpu_torch.analysis
#     --update-wire-lock`).  The port speaks the JAX package's wire, so
#     its lock is the JAX package's, byte for byte.
#
# Both checkers emit the same Finding records as the syntactic lint,
# honor `# graft: disable=<rule>` waivers at the reported line, and run
# from the CLI's --self-check pass.

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

from .findings import ERROR, Finding, WARNING
from .lint import WaiverIndex, WaiverLog, _func_tail, _is_test_path

__all__ = [
    "METRIC_DRIFT_ALLOWLIST", "metric_drift_findings",
    "wire_schema_snapshot", "wire_schema_findings", "write_wire_lock",
    "WIRE_LOCK_NAME",
]

WIRE_LOCK_NAME = "wire_schema.lock"

# -- lint-metric-drift --------------------------------------------------------

# registry factory method tails: a call `<...registry...>.counter(
# "name", ...)` CREATES the family
_FACTORY_TAILS = {"counter", "gauge", "histogram", "sketch"}
# consumer method tails whose first string argument names a family:
# registry reads (value/series), the metrics-store selector API
# (observe/series.py), and the autoscaler's signal helpers
_CONSUMER_TAILS = {
    "value", "series", "merged_sketch", "sketch_window",
    "selector_delta", "selector_exemplars", "selector_level",
    "_worst", "_merged_p95",
}
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]{3,}$")

# Families consumed (or created) on one side only ON PURPOSE.  Keep
# this list justified: every entry is a family whose creation site or
# consumer lives outside the port (an external scraper).  None yet.
METRIC_DRIFT_ALLOWLIST = frozenset()


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstring_pattern(node) -> str | None:
    """An f-string first argument becomes a match pattern: literal
    fragments kept, every interpolation matches one identifier run."""
    if not isinstance(node, ast.JoinedStr):
        return None
    parts = []
    for value in node.values:
        if isinstance(value, ast.Constant) and \
                isinstance(value.value, str):
            parts.append(re.escape(value.value))
        else:
            parts.append(r"[A-Za-z0-9_.\-]+")
    return "".join(parts)


def _receiver_text(func) -> str:
    if not isinstance(func, ast.Attribute):
        return ""
    try:
        return ast.unparse(func.value)
    except Exception:
        return ""


def _strip_selector(name: str) -> str:
    """'family{label=v}:p95' -> 'family' (store selector syntax)."""
    return name.split("{", 1)[0].split(":", 1)[0]


class _MetricScan(ast.NodeVisitor):
    """One file's creation and consumption sites."""

    def __init__(self, path: str, consumer: bool):
        self.path = path
        self.consumer = consumer
        self.created: list = []       # (name, lineno)
        self.patterns: list = []      # (regex, lineno) f-string creates
        self.consumed: list = []      # (name, lineno)

    def visit_Call(self, node: ast.Call) -> None:
        tail = _func_tail(node.func)
        receiver = _receiver_text(node.func)
        if tail in _FACTORY_TAILS and "registry" in receiver.lower() \
                and node.args:
            name = _const_str(node.args[0])
            if name is not None and _NAME_RE.match(name):
                self.created.append((name, node.lineno))
            else:
                pattern = _fstring_pattern(node.args[0])
                if pattern:
                    self.patterns.append((pattern, node.lineno))
        elif tail == "MirroredStats":
            for keyword in node.keywords:
                if keyword.arg == "metric":
                    name = _const_str(keyword.value)
                    if name:
                        self.created.append((name, node.lineno))
        elif self.consumer and tail in _CONSUMER_TAILS and node.args:
            name = _const_str(node.args[0])
            if name is not None:
                name = _strip_selector(name)
                if _NAME_RE.match(name):
                    self.consumed.append((name, node.lineno))
        elif self.consumer and tail == "add" and \
                "famil" in receiver.lower() and node.args:
            name = _const_str(node.args[0])
            if name is not None and _NAME_RE.match(name):
                self.consumed.append((name, node.lineno))
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        # `family == "name"` / `family in ("a", "b")`: the journey and
        # snapshot mergers dispatch on family names this way
        if self.consumer:
            sides = [node.left, *node.comparators]
            texts = []
            for side in sides:
                try:
                    texts.append(ast.unparse(side))
                except Exception:
                    texts.append("")
            if any("family" in text or "name" == text
                   for text in texts):
                for side in sides:
                    for name in self._names_in(side):
                        self.consumed.append((name, node.lineno))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # tuples of family names assigned to *FAMILIES* / *SIGNAL*
        # constants (the autoscaler's signal list)
        if self.consumer:
            for target in node.targets:
                label = getattr(target, "id",
                                getattr(target, "attr", "")) or ""
                if "FAMILIES" in label or "SIGNAL" in label or \
                        "famil" in label:
                    for name in self._names_in(node.value):
                        self.consumed.append((name, node.lineno))
        self.generic_visit(node)

    @staticmethod
    def _names_in(node) -> list:
        names = []
        value = _const_str(node)
        if value is not None and _NAME_RE.match(value):
            names.append(value)
        elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for element in node.elts:
                value = _const_str(element)
                if value is not None and _NAME_RE.match(value):
                    names.append(value)
        return names


def _is_consumer_path(path: Path, root: Path) -> bool:
    """Files whose metric-name strings count as CONSUMPTION:
    chip_smoke.py (the port's bench), the autoscaler, the dashboard,
    and observe/ (journey merging, export)."""
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return False
    parts = rel.parts
    return (
        rel.name == "chip_smoke.py"
        or rel.name in ("autoscaler.py", "dashboard.py",
                        "dashboard_plugins.py")
        or (len(parts) > 1 and parts[-2] == "observe")
    )


def metric_drift_findings(files, root: Path,
                          waiver_log: WaiverLog | None = None) -> list:
    """Cross-reference metric families: consumed-but-never-created is
    an ERROR (the consumer reads zeros forever); created-but-never-
    mentioned-anywhere-else is a WARNING (a dead family, or its
    consumer was renamed away)."""
    waiver_log = waiver_log or WaiverLog()
    scans = []
    sources = {}
    for file_path in files:
        file_path = Path(file_path)
        if _is_test_path(str(file_path)):
            continue
        try:
            source = file_path.read_text()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            continue
        scan = _MetricScan(str(file_path),
                           _is_consumer_path(file_path, root))
        scan.visit(tree)
        scans.append((scan, source, tree))
        sources[str(file_path)] = source
    # the mention corpus includes tests: a family consumed only by a
    # regression test is still consumed
    for test_file in sorted(root.glob("tests/*.py")):
        try:
            sources[str(test_file)] = test_file.read_text()
        except OSError:
            continue

    created = {}                     # name -> first (path, lineno)
    patterns = []                    # (compiled, path, lineno)
    consumed = []                    # (name, path, lineno)
    for scan, _source, _tree in scans:
        for name, lineno in scan.created:
            created.setdefault(name, (scan.path, lineno))
        for pattern, lineno in scan.patterns:
            patterns.append((re.compile(pattern), scan.path, lineno))
        for name, lineno in scan.consumed:
            consumed.append((name, scan.path, lineno))

    findings = []
    waivers = {}

    def _waived(path: str, lineno: int) -> bool:
        index = waivers.get(path)
        if index is None:
            index = waivers[path] = WaiverIndex(sources.get(path, ""))
        match = index.match("lint-metric-drift", lineno)
        if match is not None:
            waiver_log.mark_used(path, match)
            return True
        return False

    consumed_names = {name for name, _path, _line in consumed}
    for name, path, lineno in consumed:
        if name in created or name in METRIC_DRIFT_ALLOWLIST:
            continue
        if any(pattern.fullmatch(name) for pattern, _p, _l in patterns):
            continue
        if _waived(path, lineno):
            continue
        findings.append(Finding(
            "lint-metric-drift", ERROR, path, lineno,
            f"metric family {name!r} is consumed here but no registry "
            f"creation site defines it — renamed or never created "
            f"(add to METRIC_DRIFT_ALLOWLIST only for families an "
            f"external exporter creates)"))
    for name, (path, lineno) in sorted(created.items()):
        if name in consumed_names or name in METRIC_DRIFT_ALLOWLIST:
            continue
        mentions = sum(text.count(name)
                       for text in sources.values())
        if mentions > sources.get(path, "").count(name):
            # the name appears beyond its own defining file — some
            # consumer (test, script, doc string) still reads it
            continue
        if _waived(path, lineno):
            continue
        findings.append(Finding(
            "lint-metric-drift", WARNING, path, lineno,
            f"metric family {name!r} is created here but nothing in "
            f"the repo consumes or even mentions it — dead family, or "
            f"its consumer drifted"))
    return findings


# -- lint-wire-schema ---------------------------------------------------------

def wire_schema_snapshot() -> dict:
    """The envelope contract as one JSON-stable dict, built from the
    DECLARED constants in transport/wire.py (+ the trace marker's home
    in observe/tracing.py).  Committed as analysis/wire_schema.lock;
    lint-wire-schema fails on any difference."""
    from ..observe.tracing import TRACE_MARKER
    from ..transport import wire
    return {
        "version": 1,
        "magic": wire.MAGIC.decode("ascii"),
        "wire_version": wire.WIRE_VERSION,
        "buffer_marker": wire.BUFFER_MARKER,
        "buffer_marker_arity": wire.BUFFER_MARKER_ARITY,
        "trace_marker": TRACE_MARKER,
        "trace_fields_arity": wire.TRACE_FIELDS_ARITY,
        "tenant_marker": wire.TENANT_MARKER,
        "tenant_fields_arity": wire.TENANT_FIELDS_ARITY,
        "hop_entry_fields": list(wire.HOP_ENTRY_FIELDS),
        "hop_entry_optional": list(wire.HOP_ENTRY_OPTIONAL),
        "codecs": {
            name: {
                "dtypes": list(wire.WIRE_CODEC_DTYPES[name]),
                "rank": wire.WIRE_CODEC_RANK.get(name),
            } for name in sorted(wire.WIRE_CODECS)},
        "kv_transfer": {
            "command": wire.KV_TRANSFER_COMMAND,
            "batch_command": wire.KV_BATCH_COMMAND,
            "required_params": wire.KV_TRANSFER_PARAMS,
            "optional_params": ["chunk"],
            "schema": dict(wire.KV_TRANSFER_SCHEMA),
            "dtypes": {key: list(value) for key, value in
                       sorted(wire.KV_TRANSFER_DTYPES.items())},
            "rank": dict(sorted(wire.KV_TRANSFER_RANK.items())),
        },
        # session migration control legs: the offer + its
        # ack/done replies; the KV payload itself rides kv_transfer
        # above, so only the new commands and the offer arity lock
        "kv_migrate": {
            "command": wire.KV_MIGRATE_COMMAND,
            "ack_command": wire.KV_MIGRATE_ACK_COMMAND,
            "done_command": wire.KV_MIGRATE_DONE_COMMAND,
            "required_params": wire.KV_MIGRATE_PARAMS,
            "arrays": ["tokens", "history"],
        },
    }


def _runtime_consistency() -> list:
    """Cross-check the declared arities against what the encode paths
    actually build — the lock is only worth committing if the
    declaration cannot drift from the runtime either."""
    import numpy as np
    from ..transport import wire
    problems = []
    tenant = wire.tenant_fields("t", 2)
    if len(tenant) != wire.TENANT_FIELDS_ARITY:
        problems.append(
            f"tenant_fields() builds {len(tenant)} fields, declared "
            f"TENANT_FIELDS_ARITY={wire.TENANT_FIELDS_ARITY}")
    buffers: list = []
    marker = wire._extract(np.zeros((2,), np.int32), buffers)
    if len(marker) != wire.BUFFER_MARKER_ARITY:
        problems.append(
            f"_extract() builds a {len(marker)}-element buffer marker, "
            f"declared BUFFER_MARKER_ARITY={wire.BUFFER_MARKER_ARITY}")
    try:
        from ..observe.tracing import TraceContext
        fields = TraceContext(trace_id="t" * 32,
                              span_id="s" * 16).to_fields(0.0)
        if len(fields) != wire.TRACE_FIELDS_ARITY:
            problems.append(
                f"TraceContext.to_fields() builds {len(fields)} "
                f"fields, declared TRACE_FIELDS_ARITY="
                f"{wire.TRACE_FIELDS_ARITY}")
    except TypeError:
        problems.append("TraceContext signature changed — update the "
                        "wire-schema consistency probe")
    return problems


def _flatten(value, prefix: str = "") -> dict:
    if isinstance(value, dict):
        flat = {}
        for key in value:
            flat.update(_flatten(value[key],
                                 f"{prefix}.{key}" if prefix else key))
        return flat
    if isinstance(value, list):
        return {prefix: json.dumps(value)}
    return {prefix: value}


def wire_schema_findings(root: Path, lock_path: Path | None = None) \
        -> list:
    """Compare the runtime wire schema against the committed lock.
    Every divergent key is its own ERROR, so the failure names exactly
    which envelope field moved."""
    lock_path = lock_path or \
        Path(__file__).resolve().parent / WIRE_LOCK_NAME
    wire_path = str(root / "aiko_services_tpu_torch" / "transport" /
                    "wire.py")
    findings = []
    for problem in _runtime_consistency():
        findings.append(Finding("lint-wire-schema", ERROR, wire_path, 0,
                                problem))
    snapshot = wire_schema_snapshot()
    try:
        locked = json.loads(lock_path.read_text())
    except FileNotFoundError:
        findings.append(Finding(
            "lint-wire-schema", ERROR, str(lock_path), 0,
            "wire schema lock missing — run `python -m "
            "aiko_services_tpu_torch.analysis --update-wire-lock` and commit "
            "the result"))
        return findings
    except (OSError, json.JSONDecodeError) as exc:
        findings.append(Finding(
            "lint-wire-schema", ERROR, str(lock_path), 0,
            f"wire schema lock unreadable: {exc}"))
        return findings
    flat_now, flat_locked = _flatten(snapshot), _flatten(locked)
    for key in sorted(set(flat_now) | set(flat_locked)):
        now, was = flat_now.get(key), flat_locked.get(key)
        if now == was:
            continue
        if key not in flat_locked:
            message = (f"wire schema field {key!r} = {now!r} is not in "
                       f"the lock — an envelope change must be a "
                       f"two-sided diff (--update-wire-lock)")
        elif key not in flat_now:
            message = (f"locked wire schema field {key!r} = {was!r} "
                       f"no longer exists in transport/wire.py")
        else:
            message = (f"wire schema drift at {key!r}: locked {was!r}, "
                       f"runtime {now!r} — changing the envelope "
                       f"requires regenerating the lock "
                       f"(--update-wire-lock)")
        findings.append(Finding("lint-wire-schema", ERROR, wire_path, 0,
                                message))
    return findings


def write_wire_lock(lock_path: Path | None = None) -> Path:
    lock_path = lock_path or \
        Path(__file__).resolve().parent / WIRE_LOCK_NAME
    lock_path.write_text(
        json.dumps(wire_schema_snapshot(), indent=2, sort_keys=True)
        + "\n")
    return lock_path
