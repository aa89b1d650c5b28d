# Per-edge dtype/shape/codec contract grammar.
#
# An element may declare, per input/output name, what it produces or
# accepts:
#
#     "f32[*,80]"                  float32 array, any leading dim, 80 mels
#     "f32[*] | i16[*]"            either dtype, rank-1 any length
#     "f32[*] | mulaw-u8[*]"       raw float audio OR µ-law codes (uint8)
#     "str"                        a python string
#     "any"                        no constraint (explicit opt-out)
#
#     contract  := alt ("|" alt)*
#     alt       := [codec "-"] dtype [ "[" dims "]" ]
#     dims      := dim ("," dim)*     dim := integer | "*"
#
# Codec prefixes name the wire codecs from transport/wire.py (mulaw, i8,
# dct8): "mulaw-u8" reads "uint8 values that are µ-law codes".  Producer
# and consumer are compatible when ANY producer alternative matches ANY
# consumer alternative (same codec, dtype equal or `any`, shapes
# unifiable dim-by-dim with `*` as wildcard; a missing shape suffix
# matches every shape).

from __future__ import annotations

from dataclasses import dataclass

from ..transport.wire import WIRE_CODECS

__all__ = ["Alt", "ContractError", "parse_contract", "compatible",
           "DTYPE_ALIASES"]

DTYPE_ALIASES = {
    "f16": "float16", "f32": "float32", "f64": "float64",
    "bf16": "bfloat16",
    "i8": "int8", "i16": "int16", "i32": "int32", "i64": "int64",
    "u8": "uint8", "u16": "uint16", "u32": "uint32", "u64": "uint64",
    "bool": "bool", "str": "str", "bytes": "bytes", "any": "any",
}
_CANONICAL = set(DTYPE_ALIASES.values())


class ContractError(ValueError):
    """Raised when a contract string does not parse."""


@dataclass(frozen=True)
class Alt:
    """One alternative of a contract: optional codec + dtype + shape.

    shape is None (unconstrained) or a tuple whose entries are ints or
    the wildcard string "*"."""
    codec: str              # "" = uncoded
    dtype: str              # canonical numpy-style name, "str", or "any"
    shape: tuple | None

    def __str__(self) -> str:
        text = f"{self.codec}-{self.dtype}" if self.codec else self.dtype
        if self.shape is not None:
            text += "[" + ",".join(str(d) for d in self.shape) + "]"
        return text


def _parse_alt(token: str) -> Alt:
    text = token.strip()
    if not text:
        raise ContractError("empty contract alternative")
    codec = ""
    if "-" in text:
        codec, rest = text.split("-", 1)
        codec = codec.strip()
        if codec not in WIRE_CODECS:
            raise ContractError(
                f"unknown wire codec {codec!r} in {token!r} "
                f"(known: {sorted(WIRE_CODECS)})")
        text = rest.strip()
    shape: tuple | None = None
    if "[" in text:
        if not text.endswith("]"):
            raise ContractError(f"unterminated shape in {token!r}")
        text, dims_text = text[:-1].split("[", 1)
        text = text.strip()
        dims = []
        for dim in dims_text.split(","):
            dim = dim.strip()
            if dim == "*":
                dims.append("*")
            elif dim.isdigit():
                dims.append(int(dim))
            else:
                raise ContractError(
                    f"bad shape dim {dim!r} in {token!r} "
                    f"(expected integer or *)")
        shape = tuple(dims)
    dtype = DTYPE_ALIASES.get(text, text if text in _CANONICAL else None)
    if dtype is None:
        raise ContractError(
            f"unknown dtype {text!r} in {token!r} "
            f"(expected one of {sorted(DTYPE_ALIASES)})")
    if codec and dtype in ("str", "any"):
        raise ContractError(
            f"codec {codec!r} cannot qualify dtype {dtype!r} in {token!r}")
    return Alt(codec, dtype, shape)


def parse_contract(text: str) -> list[Alt]:
    """Parse "alt | alt | ..." into its alternatives; raises
    ContractError on any syntax problem."""
    if not isinstance(text, str) or not text.strip():
        raise ContractError(f"contract must be a non-empty string, "
                            f"got {text!r}")
    return [_parse_alt(token) for token in text.split("|")]


def _shapes_unify(a: tuple | None, b: tuple | None) -> bool:
    if a is None or b is None:
        return True
    if len(a) != len(b):
        return False
    return all(x == "*" or y == "*" or x == y for x, y in zip(a, b))


def _alts_match(produced: Alt, accepted: Alt) -> bool:
    if produced.codec != accepted.codec:
        return False
    if "any" not in (produced.dtype, accepted.dtype) and \
            produced.dtype != accepted.dtype:
        return False
    return _shapes_unify(produced.shape, accepted.shape)


def compatible(producer: list[Alt], consumer: list[Alt]) -> bool:
    """True when some producer alternative satisfies some consumer
    alternative."""
    return any(_alts_match(p, c) for p in producer for c in consumer)
