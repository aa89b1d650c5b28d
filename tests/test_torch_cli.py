"""The port's argparse command line held against the JAX package's click
CLI (driven through click's CliRunner): `pipeline show` (pretty and
--dump json, to stdout and to a file) and `pipeline params` print the
same lines for every example definition, element flags parse to the same
overrides (both spellings, `=` values, the longest prefix) and fail with
the same messages; `system start` / `status` / `stop` spawns, reports
and stops a real `python -m aiko_services_tpu_torch registrar` child;
`pipeline create --device cpu` is built by build_pipeline on the test's
own engine and driven to its frames, also over a --mesh of one device;
--mesh in two processes launched as torchrun launches them (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT) joins both ranks in one mesh;
the parts that wait for other ROADMAP items raise NotImplementedError
naming them."""

import glob
import json
import os
import subprocess
import sys
import time

import click
import pytest
from click.testing import CliRunner

from aiko_services_tpu import cli as JCli
from aiko_services_tpu.pipeline import (
    parse_pipeline_definition as jparse)
from aiko_services_tpu_torch import cli as TCli
from aiko_services_tpu_torch.event import EventEngine, VirtualClock
from aiko_services_tpu_torch.pipeline import (
    parse_pipeline_definition as tparse)

EXAMPLES = sorted(glob.glob("examples/*/*.json"))


def port(argv, capsys):
    """Run the port's CLI; (exit code, stdout, stderr)."""
    code = TCli.main(argv)
    captured = capsys.readouterr()
    return code, captured.out, captured.err


def reference(argv):
    result = CliRunner().invoke(JCli.main, argv)
    return result.exit_code, result.output


@pytest.mark.parametrize("command", [
    ["pipeline", "show"], ["pipeline", "show", "--dump", "json"],
    ["pipeline", "params"]])
def test_show_and_params_print_the_jax_lines(command, capsys):
    assert len(EXAMPLES) >= 6
    for path in EXAMPLES:
        code, out, err = port(command[:2] + [path] + command[2:], capsys)
        assert (code, out) == reference(command[:2] + [path] + command[2:])
        assert code == 0 and out and not err


def test_show_dump_to_a_file_and_its_usage_error(tmp_path, capsys):
    path = "examples/speech/pipeline_transcription_remote.json"
    outputs = {}
    for name, run in (("torch", lambda argv: port(argv, capsys)[:2]),
                      ("jax", reference)):
        target = tmp_path / f"{name}.json"
        code, out = run(["pipeline", "show", path, "--dump", "json",
                         "--output", str(target)])
        outputs[name] = (code, out.replace(name, "X"), target.read_text())
    assert outputs["torch"] == outputs["jax"]
    code, out, err = port(["pipeline", "show", path, "--output", "x"],
                          capsys)
    assert code == 1 and not out
    assert err == "Error: --output requires --dump json|yaml\n"
    assert "--output requires --dump json|yaml" in reference(
        ["pipeline", "show", path, "--output", "x"])[1]


def test_element_flags_parse_as_jax_parses_them():
    spec = {
        "version": 0, "name": "p", "runtime": "python",
        "graph": ["(PE_Microphone (PE_MicrophoneSim (PE_WhisperASR)))"],
        "parameters": {"PE_WhisperASR.max_tokens": 24},
        "elements": [
            {"name": "PE_Microphone", "input": [],
             "output": [{"name": "audio"}]},
            {"name": "PE_MicrophoneSim", "input": [{"name": "audio"}],
             "output": [{"name": "audio2"}]},
            {"name": "PE_WhisperASR", "input": [{"name": "audio2"}],
             "output": [{"name": "text"}]}]}
    port_definition, jax_definition = tparse(spec), jparse(spec)
    flags = ["--PE_WhisperASR.max_tokens", "8",
             "--pe-whisper-asr-wire=int16", "--pe_whisper_asr-max-wait",
             "0.25", "--pe-microphone-sim-rate", "10",
             "--pe-microphone-rate", "20", "--PE_WhisperASR.gates",
             '{"a": [1, 2]}']
    overrides = TCli.parse_element_flags(port_definition, flags)
    assert overrides == JCli.parse_element_flags(jax_definition, flags)
    assert overrides["PE_MicrophoneSim.rate"] == 10
    assert overrides["PE_Microphone.rate"] == 20
    for bad in (["--PE_Nope.x", "1"], ["--PE_WhisperASR.x"], ["stray"]):
        with pytest.raises(TCli.CliError) as port_error:
            TCli.parse_element_flags(port_definition, bad)
        with pytest.raises(click.ClickException) as jax_error:
            JCli.parse_element_flags(jax_definition, bad)
        assert str(port_error.value) == jax_error.value.message


def test_the_parts_left_for_later_items_raise_naming_them(capsys):
    # --mesh parses as JAX's does; its mesh spans the process group's
    # ranks, one device each: a one-process CPU run has one device, so a
    # mesh of two raises (a mesh of n ranks is n processes, each running
    # `pipeline create`: test_mesh_joins_the_ranks_its_launcher_describes)
    for bad in ("model", "=2", "model=2,model=2", "model=x", "model=0"):
        with pytest.raises(TCli.CliError) as port_error:
            TCli.parse_mesh_spec(bad, "cpu")
        with pytest.raises(click.ClickException) as jax_error:
            JCli.parse_mesh_spec(bad)
        assert str(port_error.value) == jax_error.value.message
    code, _, err = port(["pipeline", "create", EXAMPLES[0], "--device",
                         "cpu", "--mesh", "model=2"], capsys)
    assert code == 1 and err.startswith(
        "Error: --mesh 'model=2': mesh {'model': 2} wants 2 devices, have 1")
    # the commands that need nothing spawned print the JAX lines
    for argv in (["system", "reset", "--transport", "memory"],
                 ["system", "status", "--state-file", "/nonexistent/s"],
                 ["system", "stop", "--state-file", "/nonexistent/s"]):
        code, out, _ = port(argv, capsys)
        assert (code, out) == reference(argv)
    with pytest.raises(SystemExit):
        TCli.main(["pipeline", "show", EXAMPLES[0], "--bogus"])


def test_system_start_status_stop_cycle(tmp_path, capsys):
    """`system start` spawns a real registrar child (`python -m
    aiko_services_tpu_torch registrar`), records (pid, start time) and
    refuses a second start; `status` sees it alive; `stop` ends it."""
    state_file = str(tmp_path / "system.json")
    argv = ["system", "start", "--transport", "memory", "--services",
            "registrar", "--state-file", state_file]
    code, out, _ = port(argv, capsys)
    state = json.loads(open(state_file).read())
    pid = state["registrar"][0]
    try:
        assert code == 0 and out.startswith(f"registrar: pid {pid}\n")
        assert "memory transport is per-process" in out
        assert state["registrar"][1] is not None        # start time
        code, _, err = port(argv, capsys)
        assert code == 1 and "system already running (registrar)" in err
        code, out, _ = port(["system", "status", "--state-file",
                             state_file], capsys)
        assert out == f"registrar: pid {pid} alive\n"
    finally:
        code, out, _ = port(["system", "stop", "--state-file",
                             state_file], capsys)
    assert out == f"registrar: stopped pid {pid}\n"
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            reaped, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            break
        if reaped == pid:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"registrar pid {pid} survived system stop")
    code, out, _ = port(["system", "status", "--state-file", state_file],
                        capsys)
    assert out == "not running\n"


def test_module_entry_point_runs_the_cli():
    result = subprocess.run(
        [sys.executable, "-m", "aiko_services_tpu_torch", "pipeline",
         "show", "examples/pipeline/pipeline_local.json"],
        capture_output=True, text=True, timeout=60)
    assert result.returncode == 0, result.stderr
    assert result.stdout == reference(
        ["pipeline", "show", "examples/pipeline/pipeline_local.json"])[1]


def _create_and_drive(tmp_path, **kwargs):
    """build_pipeline on the test's own engine (virtual clock), driven
    until the stream's three frames complete; returns the compute
    runtime."""
    with open("examples/speech/pipeline_transcription.json") as handle:
        definition = json.load(handle)
    definition["parameters"].update({
        "PE_WhisperASR.preset": "test", "PE_WhisperASR.max_batch": 2,
        "PE_WhisperASR.max_tokens": 4, "PE_LogMel.device": "cpu"})
    path = tmp_path / "transcription.json"
    path.write_text(json.dumps(definition))
    engine = EventEngine(VirtualClock())
    runtime, pipeline = TCli.build_pipeline(
        str(path), name="p_cli", device="cpu", engine=engine,
        element_flags=["--PE_MicrophoneSim.limit", "3"], **kwargs)
    done = []
    pipeline.add_frame_handler(done.append)
    try:
        while len(done) < 3 and engine.clock.now() < 20.0:
            while engine.step():
                pass
            engine.clock.advance(0.01)
        compute = runtime.service_by_name("compute")
        assert compute.device.type == "cpu" and pipeline.name == "p_cli"
        assert [(f.stream_id, f.frame_id) for f in done] == \
            [("*", 0), ("*", 1), ("*", 2)]
        assert pipeline.recovery_stats["frames_failed"] == 0
        return compute
    finally:
        for stream_id in list(pipeline.streams):
            pipeline.destroy_stream(stream_id)
        runtime.terminate()


def test_pipeline_create_builds_on_the_given_engine_and_device(tmp_path):
    """`pipeline create --device cpu`: build_pipeline is what the command
    builds before it runs its loop; here the test drives it on its own
    engine (virtual clock) until the stream's three frames complete."""
    compute = _create_and_drive(tmp_path)
    assert compute.ec_producer.get("mesh") == {}


def test_pipeline_create_over_a_mesh_of_one_device(tmp_path):
    """`--mesh data=1 --device cpu`: a one-process gloo mesh of one
    device; the pipeline serves on it as on no mesh at all."""
    compute = _create_and_drive(tmp_path, mesh_spec="data=1")
    assert compute.mesh.size() == 1 and compute.mesh.device_type == "cpu"
    assert compute.ec_producer.get("mesh") == {"data": 1}
    assert compute.ec_producer.get("device_count") == 1


RANK_SCRIPT = """
import sys
from aiko_services_tpu_torch import cli
from aiko_services_tpu_torch.parallel import collectives
import torch
mesh = cli.parse_mesh_spec("model=2", "cpu")
total = collectives.psum(torch.tensor([1.0 + mesh.get_rank()]), "model",
                         mesh=mesh)
print(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), float(total[0]))
"""


def test_mesh_joins_the_ranks_its_launcher_describes(tmp_path):
    """`--mesh model=2` in two processes whose environment names their
    rank, the world and the rendezvous (as torchrun sets it): each joins
    the group and builds the same two-rank mesh, and a sum over its axis
    sees both ranks."""
    import socket
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port_number = probe.getsockname()[1]
    children = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port_number), GLOO_SOCKET_IFNAME="lo")
        children.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT], env=env, cwd=os.getcwd(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outputs = []
    try:
        for child in children:
            out, err = child.communicate(timeout=120)
            assert child.returncode == 0, err
            outputs.append(out.strip())
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
    assert outputs == ["{'model': 2} 3.0"] * 2
