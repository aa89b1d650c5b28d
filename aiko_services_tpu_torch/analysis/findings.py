# Structured findings: the one record every graft-check layer emits.
#
# A finding is machine-gateable (rule id + severity) and human-locatable
# (file:line + message).  CI gates on error-severity findings; warnings
# surface design smells (dead outputs, unreachable elements) without
# failing the build.  Interprocedural findings (effects.py) additionally
# carry a provenance `chain`: the root-to-leaf call path, one
# "path:line qualname" frame per hop, so a finding at an event-handler
# root names the exact helper route to the offending leaf call.

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

__all__ = ["Finding", "ERROR", "WARNING", "INFO", "has_errors",
           "format_findings"]

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclass(frozen=True)
class Finding:
    rule: str               # stable rule id, e.g. "graph-missing-input"
    severity: str           # error | warning | info
    path: str               # file pathname or definition name
    line: int               # 1-based; 0 = whole-file / whole-definition
    message: str
    # provenance frames root→leaf ("path:line qualname"); None for
    # syntactic findings, so pre-chain consumers see an unchanged record
    chain: tuple = field(default=None, compare=False)

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def __str__(self) -> str:
        text = f"{self.severity:<7} {self.rule:<24} {self.location}: " \
               f"{self.message}"
        if self.chain:
            text += "".join(f"\n        via {frame}"
                            for frame in self.chain)
        return text


def has_errors(findings) -> bool:
    return any(f.severity == ERROR for f in findings)


def format_findings(findings, fmt: str = "text") -> str:
    """Render findings for the CLI: stable order (severity, path, line)."""
    ordered = sorted(findings,
                     key=lambda f: (_SEVERITY_ORDER.get(f.severity, 3),
                                    f.path, f.line, f.rule))
    if fmt == "json":
        return json.dumps([asdict(f) for f in ordered], indent=2)
    return "\n".join(str(f) for f in ordered)
