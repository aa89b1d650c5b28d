"""The port's console names and shell wrappers: each reaches the port's
CLI and nothing of JAX.

  - pyproject.toml registers aiko_tpu_torch, aiko_tpu_torch_registrar and
    aiko_tpu_torch_dashboard beside the JAX package's unchanged aiko_tpu
    names, each naming a function of aiko_services_tpu_torch.cli;
  - each console entry function, called with an argv (and with none,
    reading sys.argv), runs its command: `aiko_tpu_torch pipeline show`
    prints the JAX CLI's lines, the registrar prints the JAX registrar's
    line, the dashboard draws its pages;
  - scripts/system_{start,stop,reset}_torch.sh and graft_gate_torch.sh,
    run with the memory transport and a state file under tmp_path: a
    `sitecustomize` on PYTHONPATH logs every process's imports of the
    port, jax, the JAX package, click and paho, and the log shows the
    port's CLI in the wrappers, the port's registrar in the spawned
    child, and no JAX module anywhere."""

import curses
import importlib
import os
import pathlib
import re
import subprocess
import sys
import time
import tomllib

import pytest
from click.testing import CliRunner

from aiko_services_tpu import cli as JCli
from aiko_services_tpu import process as JProcess
from aiko_services_tpu_torch import cli as TCli
from aiko_services_tpu_torch import process as TProcess
from test_torch_dashboard import ScriptedScreen

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
WATCHED = ("jax", "jaxlib", "aiko_services_tpu", "aiko_services_tpu_torch",
           "click", "paho")
FORBIDDEN = ("jax", "jaxlib", "aiko_services_tpu", "click", "paho")


def _scripts() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as handle:
        return tomllib.load(handle)["project"]["scripts"]


def test_pyproject_registers_the_port_names_beside_the_jax_ones():
    scripts = _scripts()
    assert {name: scripts[name] for name in
            ("aiko_tpu", "aiko_tpu_registrar", "aiko_tpu_dashboard")} == {
        "aiko_tpu": "aiko_services_tpu.cli:main",
        "aiko_tpu_registrar": "aiko_services_tpu.cli:registrar",
        "aiko_tpu_dashboard": "aiko_services_tpu.cli:dashboard"}
    ours = {name: target for name, target in scripts.items()
            if name.startswith("aiko_tpu_torch")}
    assert ours == {
        "aiko_tpu_torch": "aiko_services_tpu_torch.cli:main",
        "aiko_tpu_torch_registrar":
            "aiko_services_tpu_torch.cli:registrar_main",
        "aiko_tpu_torch_dashboard":
            "aiko_services_tpu_torch.cli:dashboard_main"}
    for target in ours.values():
        module, _, function = target.partition(":")
        assert callable(getattr(importlib.import_module(module), function))


def _entry(name):
    module, _, function = _scripts()[name].partition(":")
    return getattr(importlib.import_module(module), function)


def test_aiko_tpu_torch_prints_the_jax_clis_lines(capsys, monkeypatch):
    argv = ["pipeline", "show", "examples/pipeline/pipeline_local.json"]
    reference = CliRunner().invoke(JCli.main, argv)
    assert _entry("aiko_tpu_torch")(argv) == 0
    assert capsys.readouterr().out == reference.output
    monkeypatch.setattr(sys, "argv", ["aiko_tpu_torch", *argv])
    assert _entry("aiko_tpu_torch")() == 0
    assert capsys.readouterr().out == reference.output


def _run_once(runtimes):
    """A ProcessRuntime.run that records its runtime and returns at once
    (its terminate detaches the runtime from the process's broker)."""
    def run(self, loop_when_no_handlers=False):
        runtimes.append((self, loop_when_no_handlers))
        self.terminate()
    return run


@pytest.mark.parametrize("argv", [["--transport", "memory"], None],
                         ids=["argv", "sys.argv"])
def test_registrar_entry_runs_the_registrar(argv, capsys, monkeypatch):
    runtimes = []
    monkeypatch.setattr(TProcess.ProcessRuntime, "run", _run_once(runtimes))
    monkeypatch.setattr(JProcess.ProcessRuntime, "run", _run_once(runtimes))
    monkeypatch.setattr(sys, "argv", ["aiko_tpu_torch_registrar",
                                      "--transport", "memory"])
    assert _entry("aiko_tpu_torch_registrar")(argv) == 0
    port_line = capsys.readouterr().out
    reference = CliRunner().invoke(JCli.registrar, ["--transport", "memory"])
    assert reference.exit_code == 0
    assert len(runtimes) == 2 and all(loop for _, loop in runtimes)
    assert type(runtimes[0][0]) is TProcess.ProcessRuntime
    topic = re.compile(r"registrar on \S+ \(memory\)\n")
    assert topic.fullmatch(port_line) and topic.fullmatch(reference.output)


@pytest.mark.parametrize("argv", [["--transport", "memory"], None],
                         ids=["argv", "sys.argv"])
def test_dashboard_entry_draws_the_dashboard(argv, monkeypatch):
    screen = ScriptedScreen([-1])
    monkeypatch.setattr(curses, "wrapper", lambda loop: loop(screen))
    monkeypatch.setattr(curses, "curs_set", lambda visibility: None)
    monkeypatch.setattr("time.sleep", lambda seconds: None)
    monkeypatch.setattr(sys, "argv", ["aiko_tpu_torch_dashboard",
                                      "--transport", "memory"])
    assert _entry("aiko_tpu_torch_dashboard")(argv) == 0
    assert screen.frames and screen.frames[0][0].startswith(
        " aiko_services_tpu_torch dashboard — services — ")


# -- the shell wrappers -------------------------------------------------------

SITECUSTOMIZE = f'''
import atexit
import os
import sys

_LOG = os.environ["AIKO_IMPORT_LOG"]
_WATCHED = {WATCHED!r}


_loaded = set()


def _write(lines):
    with open(_LOG, "a") as handle:
        handle.writelines(f"{{os.getpid()}} {{line}}\\n" for line in lines)


def _newly_loaded():
    now = {{name for name in list(sys.modules)
           if name.split(".")[0] in _WATCHED}}
    fresh = sorted(now - _loaded)
    _loaded.update(fresh)
    return [f"+{{name}}" for name in fresh]


class _ImportLog:
    """Logs each watched name looked up (a probe or an import) and each
    watched module that has entered sys.modules since the last lookup."""

    def find_spec(self, name, path=None, target=None):
        lines = _newly_loaded()
        if name.split(".")[0] in _WATCHED:
            lines.append(name)
        if lines:
            _write(lines)
        return None


sys.meta_path.insert(0, _ImportLog())
atexit.register(lambda: _write(_newly_loaded()))
'''


@pytest.fixture
def watched(tmp_path):
    """(environment, log reader): a PYTHONPATH sitecustomize logging, per
    process, each watched name looked up ("pid module") and each watched
    module loaded ("pid +module")."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    log = tmp_path / "imports.log"
    log.touch()
    env = dict(os.environ, PYTHONPATH=str(site), AIKO_IMPORT_LOG=str(log),
               AIKO_TPU_TRANSPORT="memory")

    def read():
        return [line.split(" ", 1) for line in
                log.read_text().splitlines() if line]
    return env, read


def _wrapper(name, env, *argv, timeout=120):
    return subprocess.run([str(SCRIPTS / name), *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as handle:
            return handle.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def test_system_wrappers_run_the_ports_cli_and_load_no_jax(tmp_path,
                                                           watched):
    env, read = watched
    state_file = str(tmp_path / "system.json")
    started = _wrapper("system_start_torch.sh", env, "--transport", "memory",
                       "--services", "registrar", "--state-file", state_file)
    assert started.returncode == 0, started.stderr
    match = re.match(r"registrar: pid (\d+)\n", started.stdout)
    assert match, started.stdout
    child = match.group(1)
    try:
        deadline = time.monotonic() + 90
        while ([child, "aiko_services_tpu_torch.registrar"] not in read()
               and time.monotonic() < deadline):
            time.sleep(0.1)
    finally:
        stopped = _wrapper("system_stop_torch.sh", env, "--state-file",
                           state_file)
    assert stopped.returncode == 0, stopped.stderr
    assert stopped.stdout == f"registrar: stopped pid {child}\n"
    deadline = time.monotonic() + 30
    while not _gone(int(child)) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gone(int(child))
    reset = _wrapper("system_reset_torch.sh", env, "--transport", "memory")
    assert reset.returncode == 0, reset.stderr
    assert reset.stdout == ("memory transport keeps no retained state "
                            "outside processes; nothing to reset\n")
    imports = read()
    assert [child, "aiko_services_tpu_torch.registrar"] in imports
    clis = {pid for pid, module in imports
            if module == "aiko_services_tpu_torch.cli"}
    assert len(clis) == 4 and child in clis     # start, stop, reset, child
    assert _loaded_forbidden(imports) == []


def _loaded_forbidden(imports) -> list:
    loaded = [entry for entry in imports if entry[1].startswith("+")]
    assert loaded
    return [entry for entry in loaded
            if entry[1][1:].split(".")[0] in FORBIDDEN]


def test_graft_gate_wrapper_runs_the_ports_strict_gate(watched):
    env, read = watched
    result = _wrapper("graft_gate_torch.sh", env, timeout=300)
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.strip().endswith(
        "graft-check: 0 finding(s), 0 error(s)")
    imports = read()
    assert any(module == "aiko_services_tpu_torch.analysis"
               for _, module in imports)
    assert _loaded_forbidden(imports) == []
