# Findings baseline: land strict-on-new without a big-bang cleanup.
#
# A baseline is a committed JSON file mapping finding FINGERPRINTS to
# occurrence counts.  `--baseline FILE` subtracts baselined findings
# from the gate: pre-existing debt stays visible in the file (one
# reviewable line per acknowledged finding) while any NEW finding —
# or any extra occurrence of a baselined one — still fails CI.  A
# baseline entry that no longer matches anything becomes a
# `baseline-stale` warning, so paid-down debt is removed from the file
# instead of rotting (`--update-baseline` regenerates it).
#
# Fingerprints are `rule|relative-path|message` with every `:<line>`
# inside the message normalized to `:*`, so a pure line-number shift
# (code added above a finding) neither breaks the suppression nor
# lets a second, genuinely new occurrence hide.  Provenance chains are
# NOT part of the fingerprint — interprocedural call routes shift with
# any refactor; the root finding's identity is rule + file + message.

from __future__ import annotations

import json
import re
from pathlib import Path

from .findings import Finding, WARNING

__all__ = [
    "BASELINE_VERSION", "fingerprint", "load_baseline",
    "apply_baseline", "write_baseline",
]

BASELINE_VERSION = 1
_LINE_RE = re.compile(r":\d+")


def fingerprint(finding: Finding, root: Path) -> str:
    try:
        rel = str(Path(finding.path).resolve()
                  .relative_to(Path(root).resolve()))
    except (ValueError, OSError):
        rel = finding.path
    message = _LINE_RE.sub(":*", finding.message)
    return f"{finding.rule}|{rel}|{message}"


def load_baseline(path: Path) -> dict:
    """{fingerprint: count} from a baseline file.  Raises OSError /
    ValueError on unreadable or malformed input — a broken baseline
    must fail the gate, not silently suppress nothing (or everything)."""
    data = json.loads(Path(path).read_text())
    if not isinstance(data, dict) or \
            not isinstance(data.get("entries"), dict):
        raise ValueError(f"baseline {path}: want "
                         f'{{"version": .., "entries": {{..}}}}')
    entries = {}
    for key, count in data["entries"].items():
        if not isinstance(key, str) or not isinstance(count, int) \
                or count < 1:
            raise ValueError(f"baseline {path}: bad entry {key!r}")
        entries[key] = count
    return entries


def apply_baseline(findings, entries: dict, root: Path,
                   baseline_path: Path) -> list:
    """Subtract baselined findings; returns the survivors PLUS one
    `baseline-stale` warning per entry that matched fewer findings
    than its count (the debt was paid down — regenerate the file)."""
    remaining = dict(entries)
    survivors = []
    for finding in findings:
        key = fingerprint(finding, root)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
        else:
            survivors.append(finding)
    for key in sorted(key for key, count in remaining.items()
                      if count > 0):
        rule = key.split("|", 1)[0]
        survivors.append(Finding(
            "baseline-stale", WARNING, str(baseline_path), 0,
            f"baseline entry no longer matches any finding "
            f"(rule {rule}, {remaining[key]} unmatched): regenerate "
            f"with --update-baseline", ))
    return survivors


def write_baseline(path: Path, findings, root: Path) -> Path:
    entries: dict = {}
    for finding in findings:
        key = fingerprint(finding, root)
        entries[key] = entries.get(key, 0) + 1
    document = {
        "version": BASELINE_VERSION,
        "entries": {key: entries[key] for key in sorted(entries)},
    }
    path = Path(path)
    path.write_text(json.dumps(document, indent=2) + "\n")
    return path
