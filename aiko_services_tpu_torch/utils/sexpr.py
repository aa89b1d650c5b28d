# Parameter coercion.
#
# The port's own copy of parse_bool from aiko_services_tpu/utils/sexpr.py
# (the S-expression codec itself arrives with the host-plane slice).

from __future__ import annotations

__all__ = ["parse_bool"]


def parse_bool(value, default=False) -> bool:
    """Coerce a wire-delivered parameter to bool.

    S-expression parameters arrive as strings, so bare truthiness is a
    trap: "false"/"0" are truthy Python strings."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return bool(value)
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered in ("true", "t", "yes", "on", "1"):
            return True
        if lowered in ("false", "f", "no", "off", "0", ""):
            return False
        return default
    if value is None:
        return default
    return bool(value)
