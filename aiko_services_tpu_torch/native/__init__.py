# Native extension loader: compiles aiko_native.cpp (a CPython extension
# module) at first use with g++ into aiko_services_tpu_torch/_build/
# (gitignored, never beside the source), and degrades gracefully when no
# host toolchain is present — callers keep their pure-Python plain
# versions (transport/message.py _py_topic_matches, utils/sexpr.py
# _parse_sexpr_py).  This is host-side parsing, not a device kernel: the
# Python versions are the same function, not a fallback for the card.
#
# Nothing is built at import: `NATIVE_AVAILABLE` is resolved (and the
# extension built) the first time it is read.  Disable with
# AIKO_TPU_NATIVE=0 (e.g. to time the plain versions).

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

__all__ = ["load", "native_topic_matches", "native_parse_sexpr",
           "NATIVE_AVAILABLE", "build_path", "parity_corpus"]

_SOURCE = Path(__file__).resolve().parent / "aiko_native.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC")
_module = None
_load_attempted = False


def build_path() -> Path:
    """The extension's library: named by a hash of the source and the
    flags, so an edit builds a new one beside any stale one."""
    tag = sysconfig.get_config_var("SOABI") or "native"
    digest = hashlib.sha256(_SOURCE.read_bytes() +
                            " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"_aiko_native-{digest}.{tag}.so"


def _build(so_path: Path) -> None:
    """Compile to a private temporary name and rename it into place, so
    processes building at once never import a half-written library
    (the rename is atomic; the last writer wins)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    partial = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *_FLAGS, f"-I{sysconfig.get_path('include')}",
             "-o", str(partial), str(_SOURCE)],
            check=True, capture_output=True, timeout=180)
        os.replace(partial, so_path)
    finally:
        partial.unlink(missing_ok=True)


def load():
    """Build (if needed) and import the extension; None when it cannot
    be built or loaded, or AIKO_TPU_NATIVE=0."""
    global _module, _load_attempted
    if _module is not None or _load_attempted:
        return _module
    _load_attempted = True
    if os.environ.get("AIKO_TPU_NATIVE", "1") == "0":
        return None
    try:
        so_path = build_path()
        if not so_path.exists():
            _build(so_path)
        spec = importlib.util.spec_from_file_location("_aiko_native",
                                                      so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        from ..utils.sexpr import ParseError
        module.set_parse_error(ParseError)
        _module = module
    except Exception:
        _module = None
    return _module


def native_topic_matches(pattern: str, topic: str) -> bool:
    module = load()
    if module is None:
        raise RuntimeError("native extension unavailable")
    return module.topic_matches(pattern, topic)


def native_parse_sexpr(payload: str):
    """Parse via the C extension.  Raises RuntimeError for payloads the
    native path does not cover (non-ASCII: length prefixes count
    characters, the native scanner counts bytes)."""
    module = load()
    if module is None:
        raise RuntimeError("native extension unavailable")
    if not payload.isascii():
        raise RuntimeError("non-ascii payload")
    return module.parse_sexpr(payload)


def parity_corpus(seed: int, topics: int, payloads: int) -> tuple:
    """The seeded corpus the extension is held against its plain
    versions on (tests/test_torch_native.py, chip_smoke.py's native
    phase): ([(pattern, topic)] registrar-shaped
    `aiko/<host>/<pid>/<sid>/<leaf>` topics against patterns with `+`,
    `#`, empty and missing levels; [payload] nested S-expressions from
    generate_sexpr, with length-prefixed atoms, "key:" atoms and dicts,
    and a share cut short so that they do not parse).  ASCII only."""
    import random

    from ..utils.sexpr import generate_sexpr
    rng = random.Random(seed)
    hosts = ("edge", "gpu-0", "h100", "tpu_v5e", "")
    leaves = ("state", "log", "in", "out", "control", "0")

    def topic() -> list:
        levels = ["aiko", rng.choice(hosts),
                  f"{rng.randrange(1, 99999)}-{rng.randrange(4)}",
                  str(rng.randrange(8)), rng.choice(leaves)]
        return levels[:rng.choice((5, 5, 5, 4, 6))] if rng.random() < 0.2 \
            else levels

    pairs = []
    for _ in range(topics):
        levels = topic()
        pattern = list(levels) if rng.random() < 0.7 else topic()
        for index in range(len(pattern)):
            if rng.random() < 0.25:
                pattern[index] = "+"
        if rng.random() < 0.2:
            pattern = pattern[:rng.randrange(len(pattern) + 1)] + ["#"]
        elif rng.random() < 0.1:
            pattern.append(rng.choice(leaves))
        pairs.append(("/".join(pattern), "/".join(levels)))

    def value(depth: int):
        kind = rng.randrange(5 if depth < 3 else 2)
        if kind == 0:
            return "".join(rng.choice("abcXYZ019_=.-")
                           for _ in range(rng.randrange(1, 9)))
        if kind == 1:
            # length-prefixed on the wire: delimiters, "key:" shapes,
            # digits before a colon, the empty atom
            return rng.choice(("needs quoting ()", "key:", "12:34", "",
                               "(", "a b", "x:y")) + str(rng.randrange(10))
        if kind == 2:
            return [value(depth + 1) for _ in range(rng.randrange(4))]
        if kind == 3:
            return {f"k{i}": value(depth + 1)
                    for i in range(rng.randrange(1, 4))}
        return rng.randrange(-1000, 1000)

    texts = []
    for _ in range(payloads):
        # mostly the control plane's (command parameter ...) shape
        text = generate_sexpr(
            [rng.choice(("add", "share", "remove", "history")),
             *(value(1) for _ in range(rng.randrange(1, 5)))]
            if rng.random() < 0.8 else value(0))
        if rng.random() < 0.1 and len(text) > 1:
            text = text[:rng.randrange(1, len(text))]
        texts.append(text)
    return pairs, texts


def __getattr__(name: str):
    # NATIVE_AVAILABLE builds at first read, not at import
    if name == "NATIVE_AVAILABLE":
        return load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
