"""The port's session-wide lock-order gate (tests/torch_lock_gate.py).

The `pytest_plugins` line below registers the gate in every process
that collects this file, so under the suite's AIKO_LOCK_CHECK=1 a port
lock-order violation left behind by any test fails the run.  The
self-tests run pytest in a subprocess on a file of their own: one that
inverts two port Locks must fail at the gate's teardown, one that
resets the checker after its inversion must pass."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest_plugins = ["torch_lock_gate"]

TESTS = Path(__file__).resolve().parent

ABBA = """
    {plugin}
    from aiko_services_tpu_torch.utils import Lock, lock_check_reset


    def test_inverts_two_locks():
        lock_a, lock_b = Lock("gate_A"), Lock("gate_B")
        with lock_a:
            with lock_b:
                pass
        with lock_b:
            with lock_a:        # the inversion
                pass
        {reset}
"""


def run_pytest(tmp_path, reset: bool, workers: int = 0):
    """pytest on test_abba.py, which loads the gate itself; with
    workers, under xdist with the gate loaded by a later file (as the
    suite loads it), so the inverting test is collected first."""
    source = textwrap.dedent(ABBA).format(
        plugin="" if workers else 'pytest_plugins = ["torch_lock_gate"]',
        reset="lock_check_reset()" if reset else "")
    (tmp_path / "test_abba.py").write_text(source)
    files = ["test_abba.py"]
    xdist = []
    if workers:
        (tmp_path / "test_gate.py").write_text(
            'pytest_plugins = ["torch_lock_gate"]\n\n\n'
            'def test_nothing():\n    pass\n')
        files.append("test_gate.py")
        xdist = ["-p", "xdist", "-n", str(workers), "--dist", "loadfile"]
    env = dict(os.environ, AIKO_LOCK_CHECK="1",
               PYTHONPATH=os.pathsep.join(
                   [str(TESTS), str(TESTS.parent),
                    os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *xdist, *files],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)


@pytest.mark.parametrize("reset,workers", [(False, 0), (True, 0),
                                            (False, 2)],
                         ids=["abba_fails", "reset_passes",
                              "earlier_file_under_xdist_fails"])
def test_gate_fails_a_left_violation(tmp_path, reset, workers):
    result = run_pytest(tmp_path, reset, workers)
    output = result.stdout + result.stderr
    passed = 2 if workers else 1
    if reset:
        assert result.returncode == 0, output
        assert f"{passed} passed" in output and "error" not in output
        return
    assert result.returncode == 1, output
    assert f"{passed} passed, 1 error" in output
    assert "port lock-order violations detected during the test run" \
        in output
    assert "gate_A" in output and "gate_B" in output


def test_gate_is_registered_here(request):
    # the plugin's fixture is in this session, so the suite's run is
    # gated on the port's report
    assert request.config.pluginmanager.has_plugin("torch_lock_gate")
    assert "_torch_lock_order_gate" in request.fixturenames
