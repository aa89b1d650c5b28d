# S-expression wire format: the canonical control-plane payload encoding.
#
# Capability parity with the reference parser/generator
# (reference: aiko_services/utilities/parser.py:74-202): lists, nested lists,
# "key: value" association lists, length-prefixed binary-safe tokens "N:raw",
# and the (command param...) RPC framing used by every service protocol.
#
# This is a fresh implementation: a single-pass tokenizer + recursive-descent
# reader, with symmetric generate() that round-trips every parse() result.
#
# The port's own copy of aiko_services_tpu/utils/sexpr.py: the pure-Python
# reader only (the JAX package's optional C extension is not ported).

from __future__ import annotations

__all__ = [
    "ParseError", "parse", "parse_sexpr", "generate", "generate_sexpr",
    "parse_int", "parse_float", "parse_number", "parse_bool",
    "list_to_dict", "dict_to_list",
]


class ParseError(ValueError):
    """Raised when a payload is not a well-formed S-expression."""


_WHITESPACE = " \t\r\n"
_DELIMITERS = "()" + _WHITESPACE


def _tokenize(text: str):
    """Yield tokens: '(', ')', or atom strings.

    Atoms may be length-prefixed for binary safety: "7:a b (c)" is the single
    7-character atom "a b (c)".  A trailing ':' marks a dict key ("key:"),
    which is preserved on the token so the reader can build association lists.
    """
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in _WHITESPACE:
            i += 1
        elif ch in "()":
            yield ch
            i += 1
        else:
            j = i
            while j < n and text[j] not in _DELIMITERS:
                # length-prefixed atom: digits then ':' then exactly L chars
                if text[j] == ":" and j > i and text[i:j].isdigit():
                    length = int(text[i:j])
                    start = j + 1
                    if start + length > n:
                        raise ParseError(
                            f"length-prefixed token overruns payload at {i}")
                    yield _Raw(text[start:start + length])
                    i = start + length
                    break
                j += 1
            else:
                yield text[i:j]
                i = j
                continue
            # inner break (length-prefixed token) already advanced i
            if i > j:
                continue


class _Raw(str):
    """An atom produced from a length-prefixed token (never a dict key)."""


def parse_sexpr(payload: str):
    """Parse a payload into nested Python lists/dicts of strings.

    A parenthesised group whose members all look like "key:" value pairs is
    returned as a dict (insertion-ordered); otherwise a list.  Top level must
    be a single expression; bare atoms are returned as-is."""
    tokens = list(_tokenize(payload))
    if not tokens:
        return []
    expr, rest = _read(tokens, 0)
    if rest != len(tokens):
        raise ParseError(f"trailing tokens after expression: {tokens[rest:]}")
    return expr


def _read(tokens, pos):
    token = tokens[pos]
    if token == "(":
        items = []
        pos += 1
        while pos < len(tokens) and tokens[pos] != ")":
            item, pos = _read(tokens, pos)
            items.append(item)
        if pos >= len(tokens):
            raise ParseError("unbalanced '(' in payload")
        return _maybe_dict(items), pos + 1
    if token == ")":
        raise ParseError("unbalanced ')' in payload")
    return token, pos + 1


def _maybe_dict(items):
    """(a: 1 b: (c d)) → {"a": "1", "b": ["c", "d"]}; else keep the list."""
    if not items or len(items) % 2:
        return items
    keys = items[0::2]
    if all(isinstance(k, str) and not isinstance(k, _Raw)
           and k.endswith(":") and len(k) > 1 for k in keys):
        return {k[:-1]: v for k, v in zip(keys, items[1::2])}
    return items


def parse(payload: str):
    """Parse an RPC payload "(command param...)" → (command, [params]).

    Bare "command" (no parens) is accepted.  Returns ("", []) for empty input.
    """
    expr = parse_sexpr(payload)
    if isinstance(expr, str):
        return expr, []
    if isinstance(expr, dict):
        return "", [expr]
    if not expr:
        return "", []
    command = expr[0]
    if not isinstance(command, str):
        raise ParseError(f"command must be an atom, got {command!r}")
    return command, expr[1:]


def _needs_quoting(atom: str) -> bool:
    if atom == "":
        return True
    return any(c in _DELIMITERS for c in atom) or \
        atom.endswith(":") or \
        (":" in atom and atom.split(":", 1)[0].isdigit())


def _safe_dict_key(key) -> bool:
    return isinstance(key, str) and key != "" and ":" not in key and \
        not any(c in _DELIMITERS for c in key)


def generate_sexpr(obj) -> str:
    """Inverse of parse_sexpr for str / list / tuple / dict / scalars.

    Dicts whose keys contain delimiters or ':' cannot be expressed in the
    "key: value" association form; they are emitted as a flat alternating
    list (data preserved, dict-ness not)."""
    if isinstance(obj, dict):
        if all(_safe_dict_key(k) for k in obj):
            inner = " ".join(
                f"{k}: {generate_sexpr(v)}" for k, v in obj.items())
            return f"({inner})"
        return generate_sexpr(dict_to_list(obj))
    if isinstance(obj, (list, tuple)):
        return "(" + " ".join(generate_sexpr(i) for i in obj) + ")"
    if isinstance(obj, bool):
        return "true" if obj else "false"
    if obj is None:
        return "()"
    atom = str(obj)
    if _needs_quoting(atom):
        return f"{len(atom)}:{atom}"
    return atom


def generate(command: str, parameters=()) -> str:
    """Generate an RPC payload: generate("aloha", ["Pele"]) → "(aloha Pele)"."""
    parts = [command] + [generate_sexpr(p) for p in parameters]
    return "(" + " ".join(parts) + ")"


def parse_int(value, default=0) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def parse_float(value, default=0.0) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def parse_bool(value, default=False) -> bool:
    """Coerce a wire-delivered parameter to bool.

    S-expression parameters arrive as strings, so bare truthiness is a
    trap: "false"/"0" are truthy Python strings.  Reference parameters
    have the same string-over-MQTT shape
    (reference share.py ECProducer payloads)."""
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


def parse_number(value, default=0):
    """int if possible, else float, else default."""
    try:
        return int(value)
    except (TypeError, ValueError):
        try:
            return float(value)
        except (TypeError, ValueError):
            return default


def list_to_dict(items) -> dict:
    """Flat ["a", "1", "b", "2"] → {"a": "1", "b": "2"}."""
    if len(items) % 2:
        raise ParseError(f"odd item count for dict: {items}")
    return dict(zip(items[0::2], items[1::2]))


def dict_to_list(mapping: dict) -> list:
    out = []
    for k, v in mapping.items():
        out.extend((k, v))
    return out
