# The port's native host extension against its plain versions and the
# JAX package's: topic matching and S-expression parsing agree on the
# JAX package's tricky cases and on a seeded corpus of registrar-shaped
# topics and nested payloads; non-ASCII payloads go to Python; the
# extension builds into the port's _build/ and honours AIKO_TPU_NATIVE=0.

import os
import subprocess
import sys
from pathlib import Path

import pytest

from aiko_services_tpu.transport.message import \
    _py_topic_matches as jax_topic_matches
from aiko_services_tpu.utils.sexpr import _parse_sexpr_py as jax_parse
from aiko_services_tpu_torch import native
from aiko_services_tpu_torch.transport import message
from aiko_services_tpu_torch.transport.message import _py_topic_matches
from aiko_services_tpu_torch.utils import sexpr
from aiko_services_tpu_torch.utils.sexpr import ParseError, _parse_sexpr_py
from test_native import SEXPR_CASES, TOPIC_CASES

REPO_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def built():
    # the machine running tier-1 has g++: the extension must build
    assert native.NATIVE_AVAILABLE


@pytest.mark.parametrize("pattern, topic", TOPIC_CASES)
def test_topic_matches_parity(pattern, topic):
    plain = _py_topic_matches(pattern, topic)
    assert native.native_topic_matches(pattern, topic) == plain
    assert jax_topic_matches(pattern, topic) == plain


@pytest.mark.parametrize("payload", SEXPR_CASES)
def test_parse_sexpr_parity(payload):
    plain = _parse_sexpr_py(payload)
    assert native.native_parse_sexpr(payload) == plain
    assert jax_parse(payload) == plain


@pytest.mark.parametrize("payload", ["(a 99:short)", "(a (b)", "a)",
                                     "(a) b"])
def test_parse_error_parity(payload):
    for parse in (native.native_parse_sexpr, _parse_sexpr_py):
        with pytest.raises(ParseError):
            parse(payload)


def _outcome(parse, payload):
    try:
        return "ok", parse(payload)
    except ValueError as exc:      # each package's ParseError
        return "error", type(exc).__name__


def test_seeded_corpus_parity():
    """About 5,000 cases: the extension, the port's plain versions and
    the JAX package's plain versions agree on every one."""
    pairs, payloads = native.parity_corpus(0, topics=4000, payloads=1000)
    matched = 0
    for pattern, topic in pairs:
        plain = _py_topic_matches(pattern, topic)
        assert native.native_topic_matches(pattern, topic) == plain, \
            (pattern, topic)
        assert jax_topic_matches(pattern, topic) == plain
        matched += plain
    assert 0 < matched < len(pairs)
    errors = 0
    for payload in payloads:
        plain = _outcome(_parse_sexpr_py, payload)
        assert _outcome(native.native_parse_sexpr, payload) == plain, \
            payload
        assert _outcome(jax_parse, payload) == plain
        errors += plain[0] == "error"
    assert 0 < errors < len(payloads)


def test_the_dispatch_goes_native():
    assert message.topic_matches("aiko/+/+/+/state",
                                 "aiko/h/1-0/0/state")
    assert message._impl_topic_matches is native.native_topic_matches
    assert sexpr.parse_sexpr("(a b)") == ["a", "b"]
    assert sexpr._native_parse is native.native_parse_sexpr


def test_non_ascii_goes_to_python():
    with pytest.raises(RuntimeError):
        native.native_parse_sexpr("(héllo wörld)")
    assert sexpr.parse_sexpr("(héllo wörld)") == ["héllo", "wörld"]
    # a length prefix counts characters, not bytes
    assert sexpr.parse_sexpr("(3:héé x)") == _parse_sexpr_py("(3:héé x)")


def test_builds_into_the_ports_build_directory():
    path = native.build_path()
    assert path.parent == REPO_ROOT / "aiko_services_tpu_torch" / "_build"
    assert path.exists()
    source_dir = REPO_ROOT / "aiko_services_tpu_torch" / "native"
    assert not list(source_dir.glob("*.so"))
    assert not list(path.parent.glob("_aiko_native-*.tmp"))


def test_disabled_by_the_environment():
    script = ("from aiko_services_tpu_torch import native\n"
              "from aiko_services_tpu_torch.transport import message\n"
              "assert native.load() is None\n"
              "assert not native.NATIVE_AVAILABLE\n"
              "assert message.topic_matches('a/#', 'a/b')\n"
              "assert message._impl_topic_matches is "
              "message._py_topic_matches\n")
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO_ROOT, timeout=120,
        capture_output=True, text=True,
        env={**os.environ, "AIKO_TPU_NATIVE": "0"})
    assert result.returncode == 0, result.stderr


def test_importing_builds_nothing():
    script = ("import aiko_services_tpu_torch.native as native\n"
              "import aiko_services_tpu_torch.transport.message\n"
              "print(native._load_attempted)\n")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                            timeout=120, capture_output=True, text=True)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "False"
