# Command-line entry points, in argparse.
#
# The port's own copy of aiko_services_tpu/cli.py, with the same commands,
# options, element flags and printed lines:
#
#   python -m aiko_services_tpu_torch registrar
#   python -m aiko_services_tpu_torch pipeline create DEF.json [--device D]
#   python -m aiko_services_tpu_torch pipeline params DEF.json
#   python -m aiko_services_tpu_torch pipeline show DEF.json [--dump json]
#   python -m aiko_services_tpu_torch storage | recorder | dashboard
#   python -m aiko_services_tpu_torch system start|stop|status|reset
#
# Installed, the same commands are the console names aiko_tpu_torch
# (main), aiko_tpu_torch_registrar (registrar_main) and
# aiko_tpu_torch_dashboard (dashboard_main), beside the JAX package's
# aiko_tpu names; scripts/system_{start,stop,reset}_torch.sh wrap
# `system`.
#
# The JAX CLI is built on click, which the card's machine lacks.  Errors
# print as "Error: ..." on stderr and exit 1, as click's do.
#
# Transport selection: --transport memory|mqtt (AIKO_TPU_TRANSPORT env);
# mqtt interops with a real broker, memory is single-process.  `pipeline
# create` runs its ComputeRuntime on the card unless --device names
# another device (the tests pass cpu).

from __future__ import annotations

import argparse
import json
import os
import re
import sys

__all__ = ["main", "registrar_main", "dashboard_main", "CliError",
           "parse_element_flags", "parse_mesh_spec", "build_pipeline"]

_DEFAULT_STATE_FILE = "~/.aiko_tpu_system.json"
_CHILD_MODULE = "aiko_services_tpu_torch"


class CliError(Exception):
    """A user-facing failure: main() prints "Error: <message>" and
    exits 1."""


def echo(text: str = "", nl: bool = True) -> None:
    sys.stdout.write(text + ("\n" if nl else ""))
    sys.stdout.flush()


def _make_runtime(name, transport, engine=None):
    from .process import ProcessRuntime

    if transport == "mqtt":
        from .transport.mqtt import MQTT_AVAILABLE, MQTTMessage
        if not MQTT_AVAILABLE:
            raise CliError(
                "mqtt transport requested but paho-mqtt is not installed")

        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            from .utils.configuration import get_transport_configuration
            config = get_transport_configuration()
            return MQTTMessage(on_message=on_message, lwt_topic=lwt_topic,
                               lwt_payload=lwt_payload,
                               lwt_retain=lwt_retain,
                               host=config.host, port=config.port,
                               username=config.username,
                               password=config.password, tls=config.tls)
        runtime = ProcessRuntime(name=name, engine=engine,
                                 transport_factory=factory)
    else:
        runtime = ProcessRuntime(name=name, engine=engine)
    return runtime.initialize()


def _snake(name: str) -> str:
    """PE_WhisperASR → pe_whisper_asr (the flag naming of the element
    flags)."""
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])",
                  "_", name).lower().replace("__", "_")


def parse_element_flags(definition, extra_args) -> dict:
    """Autogenerated per-element parameter flags.  Two accepted
    spellings per parameter:

        --PE_WhisperASR.max_tokens 24     (exact names)
        --pe-whisper-asr-max-tokens 24    (snake/kebab)

    Values parse as JSON when possible, else raw strings.  Unknown
    flags raise with the discoverable flag list (`pipeline params`)."""
    elements = [e.name for e in definition.elements]
    prefixes = {_snake(name).replace("_", "-"): name
                for name in elements}
    overrides = {}
    queue = list(extra_args)
    while queue:
        flag = queue.pop(0)
        if not flag.startswith("--"):
            raise CliError(f"unexpected argument {flag!r}")
        flag = flag[2:]
        if "=" in flag:
            flag, value = flag.split("=", 1)
        elif queue:
            value = queue.pop(0)
        else:
            raise CliError(f"flag --{flag} needs a value")
        key = None
        if "." in flag:
            element, param = flag.split(".", 1)
            if element in elements:
                key = f"{element}.{param}"
        else:
            kebab = flag.replace("_", "-")
            # longest prefix first: PE_Microphone must not capture
            # PE_MicrophoneSim's flags
            for prefix in sorted(prefixes, key=len, reverse=True):
                if kebab.startswith(prefix + "-"):
                    param = kebab[len(prefix) + 1:].replace("-", "_")
                    key = f"{prefixes[prefix]}.{param}"
                    break
        if key is None:
            raise CliError(
                f"--{flag} matches no element of "
                f"{elements}; run `pipeline params` to list flags")
        try:
            overrides[key] = json.loads(value)
        except ValueError:
            overrides[key] = value
    return overrides


def parse_mesh_spec(spec: str | None, device=None):
    """'model=4,data=2' → a DeviceMesh over the ranks of the process
    group (parallel.create_mesh; None passes through: a one-device
    ComputeRuntime).  The axis names are the ones the logical-axis rules
    shard over (TP 'model', MoE 'expert', ring attention 'seq', DP
    'data').  One process is one device: a mesh of n ranks is n
    processes, each running the same `pipeline create` on the same
    inputs, launched as torchrun launches them (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT in the environment; parallel.create_mesh
    joins them); a lone process fills only axes of size 1, as one TPU
    device does under JAX."""
    if not spec:
        return None
    axes = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise CliError(f"--mesh: expected axis=N, got {part!r}")
        axis, _, count = part.partition("=")
        axis = axis.strip()
        if not axis:
            raise CliError(f"--mesh: missing axis name in {part!r}")
        if axis in axes:
            raise CliError(f"--mesh: duplicate axis {axis!r}")
        try:
            size = int(count)
        except ValueError:
            raise CliError(f"--mesh: axis size must be an integer, got "
                           f"{count!r}") from None
        if size < 1:
            raise CliError(f"--mesh: axis size must be >= 1, got {size}")
        axes[axis] = size
    from .parallel import create_mesh
    try:
        return create_mesh(axes, device)
    except ValueError as exc:
        raise CliError(
            f"--mesh {spec!r}: {exc} (the mesh spans the ranks of the "
            f"process group, one device each)") from None


# -- commands ----------------------------------------------------------------

def registrar(args) -> None:
    """Run a registrar (primary election + service discovery)."""
    from .registrar import Registrar

    runtime = _make_runtime("registrar", args.transport)
    Registrar(runtime)
    echo(f"registrar on {runtime.topic_path} ({args.transport})")
    runtime.run(loop_when_no_handlers=True)


def build_pipeline(definition_pathname, name=None, stream_id="*",
                   stream_parameters="{}", frame_json=None,
                   transport="memory", device=None, element_flags=(),
                   engine=None, mesh_spec=None):
    """What `pipeline create` builds before it runs: the runtime (on
    `engine`, a new one by default), a ComputeRuntime on `device` (None:
    the card) over the mesh `mesh_spec` names (parse_mesh_spec), the
    pipeline and its stream, and the optional first frame.  Returns
    (runtime, pipeline)."""
    from .compute import ComputeRuntime
    from .pipeline import Pipeline, load_pipeline_definition

    definition = load_pipeline_definition(definition_pathname)
    parameters = json.loads(stream_parameters)
    parameters |= parse_element_flags(definition, element_flags)
    mesh = parse_mesh_spec(mesh_spec, device)
    runtime = _make_runtime(name or definition.name, transport, engine)
    ComputeRuntime(runtime, "compute", device=device, mesh=mesh)
    pipe = Pipeline(runtime, definition, name=name,
                    definition_pathname=definition_pathname)
    pipe.create_stream(stream_id, parameters=parameters)
    if frame_json is not None:
        pipe.post("process_frame", stream_id, json.loads(frame_json))
    return runtime, pipe


def pipeline_create(args) -> None:
    """Run a pipeline from DEFINITION_PATHNAME.

    Every element parameter is additionally a flag:
    `--PE_Element.param VALUE` or `--pe-element-param VALUE`
    (see `pipeline params DEFINITION` for the list)."""
    runtime, pipe = build_pipeline(
        args.definition_pathname, args.name, args.stream_id,
        args.stream_parameters, args.frame_json, args.transport,
        args.device, args.element_flags, mesh_spec=args.mesh_spec)
    echo(f"pipeline {pipe.name} on {pipe.topic_path} "
         f"({len(pipe.graph)} elements, {args.transport})")
    runtime.run(loop_when_no_handlers=True)


def pipeline_params(args) -> None:
    """List every element parameter as its autogenerated flags."""
    from .pipeline import load_pipeline_definition

    definition = load_pipeline_definition(args.definition_pathname)
    declared: dict[str, dict] = {e.name: {} for e in definition.elements}
    for key, value in (definition.parameters or {}).items():
        element, _, param = key.partition(".")
        if param and element in declared:
            declared[element][param] = value
    for element in definition.elements:
        params = declared.get(element.name, {})
        params = {**(element.parameters or {}), **params}
        echo(f"{element.name}:")
        if not params:
            echo("  (no declared parameters; any --"
                 f"{element.name}.<param> VALUE is accepted)")
        prefix = _snake(element.name).replace("_", "-")
        for param, default in sorted(params.items()):
            echo(f"  --{element.name}.{param} / "
                 f"--{prefix}-{param.replace('_', '-')}"
                 f"  [default: {default!r}]")


def pipeline_show(args) -> None:
    """Validate and print (or --dump) a pipeline definition."""
    from .pipeline import (PipelineGraph, definition_to_dict,
                           load_pipeline_definition)

    if args.output_pathname and not args.dump_format:
        raise CliError("--output requires --dump json|yaml")
    definition = load_pipeline_definition(args.definition_pathname)
    graph = PipelineGraph.from_definition(definition)
    graph.validate(definition)
    if args.dump_format:
        data = definition_to_dict(definition)
        if args.dump_format == "yaml":
            try:
                import yaml
            except ImportError as exc:
                raise CliError(
                    "--dump yaml needs pyyaml (pip install pyyaml); "
                    "--dump json has no extra dependency") from exc
            text = yaml.safe_dump(data, sort_keys=False)
        else:
            text = json.dumps(data, indent=2) + "\n"
        if args.output_pathname:
            with open(args.output_pathname, "w") as f:
                f.write(text)
            echo(f"wrote {args.output_pathname}")
        else:
            echo(text, nl=False)
        return
    echo(f"pipeline: {definition.name} (runtime={definition.runtime})")
    for node in graph.topological_order():
        element = definition.element(node.name)
        deploy = "remote" if element.is_remote else "local"
        echo(f"  {node.name}: {element.input_names} -> "
             f"{element.output_names} [{deploy}]"
             + (f" -> {node.successors}" if node.successors else ""))
    echo("valid")


def storage(args) -> None:
    """Run a storage service (sqlite key/value)."""
    from .storage import Storage

    runtime = _make_runtime("storage", args.transport)
    database = os.environ.get("AIKO_TPU_STORAGE", "storage.db")
    Storage(runtime, database_path=database)
    echo(f"storage ({database}) on {runtime.topic_path}")
    runtime.run(loop_when_no_handlers=True)


def recorder(args) -> None:
    """Run a log recorder."""
    from .recorder import Recorder

    runtime = _make_runtime("recorder", args.transport)
    Recorder(runtime)
    echo(f"recorder on {runtime.topic_path}")
    runtime.run(loop_when_no_handlers=True)


def dashboard(args) -> None:
    """Curses dashboard: live service table + EC share browser."""
    from .dashboard import run_dashboard

    runtime = _make_runtime("dashboard", args.transport)
    run_dashboard(runtime)


# -- system bring-up ----------------------------------------------------------

def _state_path(state_file: str):
    import pathlib
    return pathlib.Path(state_file).expanduser()


def _load_state(state_file: str) -> dict:
    path = _state_path(state_file)
    if path.exists():
        try:
            return json.loads(path.read_text())
        except (ValueError, OSError):
            return {}
    return {}


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _state_entry(value):
    """State-file values are [pid, start_time] (older files: bare
    pid → start_time None)."""
    if isinstance(value, (list, tuple)):
        return int(value[0]), value[1]
    return int(value), None


def system_start(args) -> None:
    """One-command bring-up: registrar, recorder, storage (and
    mosquitto when the transport is mqtt)."""
    import shutil
    import subprocess

    from .utils.configuration import pid_start_time, pid_verified

    def still_ours(name, value):
        pid, start = _state_entry(value)
        if not _pid_alive(pid):
            return False
        # a recycled pid (different start time) is NOT our process —
        # a stale state file must not block startup forever; legacy
        # bare-pid entries fall back to the cmdline heuristic, which
        # must also try the service name (a live mosquitto never
        # matches the default "aiko" marker)
        if start is not None:
            return pid_verified(pid, start_time=start)
        return pid_verified(pid, name) or pid_verified(pid)

    state = {name: value
             for name, value in _load_state(args.state_file).items()
             if still_ours(name, value)}
    if state:
        raise CliError(
            f"system already running ({', '.join(state)}); "
            f"run `aiko_tpu system stop` first")

    if args.transport == "mqtt" and shutil.which("mosquitto"):
        from .utils.configuration import get_transport_configuration
        config = get_transport_configuration()
        if config.host in ("localhost", "127.0.0.1"):
            broker = subprocess.Popen(
                ["mosquitto", "-p", str(config.port)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            state["mosquitto"] = [broker.pid, pid_start_time(broker.pid)]
            echo(f"mosquitto: pid {broker.pid} (port {config.port})")

    for name in [s.strip() for s in args.services.split(",") if s.strip()]:
        child = subprocess.Popen(
            [sys.executable, "-m", _CHILD_MODULE, name,
             "--transport", args.transport],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        # record (pid, start_time): the exact process identity, so a
        # later `stop` can never signal a recycled pid
        state[name] = [child.pid, pid_start_time(child.pid)]
        echo(f"{name}: pid {child.pid}")
    _state_path(args.state_file).write_text(json.dumps(state))
    if args.transport == "memory":
        echo("note: memory transport is per-process — these "
             "services are isolated; use --transport mqtt for a "
             "multi-process system")


def system_stop(args) -> None:
    """Stop everything `system start` spawned."""
    import signal

    from .utils.configuration import pid_verified

    state = _load_state(args.state_file)
    if not state:
        echo("nothing recorded as running")
        return
    for name, value in state.items():
        pid, start = _state_entry(value)
        if _pid_alive(pid):
            # a stale pid file can point at a recycled pid belonging to
            # an unrelated process — only signal the exact process we
            # spawned (start-time identity when recorded; cmdline
            # heuristic for older state files)
            if start is not None:
                ok = pid_verified(pid, start_time=start)
                why = "start time changed"
            else:
                ok = pid_verified(pid, name) or pid_verified(pid)
                why = "cmdline no longer matches"
            if not ok:
                echo(f"{name}: pid {pid} alive but {why} — "
                     f"likely recycled, skipped")
                continue
            try:
                os.kill(pid, signal.SIGTERM)
                echo(f"{name}: stopped pid {pid}")
            except OSError as exc:
                echo(f"{name}: pid {pid} — {exc}")
        else:
            echo(f"{name}: pid {pid} already gone")
        try:
            # reap if the child is ours (same-process start/stop);
            # otherwise init adopts and reaps it
            os.waitpid(pid, os.WNOHANG)
        except (ChildProcessError, OSError):
            pass
    _state_path(args.state_file).unlink(missing_ok=True)


def system_status(args) -> None:
    """Show what `system start` spawned and whether it is alive."""
    state = _load_state(args.state_file)
    if not state:
        echo("not running")
        return
    for name, value in state.items():
        pid, _ = _state_entry(value)
        echo(f"{name}: pid {pid} {'alive' if _pid_alive(pid) else 'DEAD'}")


def system_reset(args) -> None:
    """Clear durable bootstrap state — the retained registrar boot
    topic on the broker."""
    if args.transport == "memory":
        echo("memory transport keeps no retained state outside "
             "processes; nothing to reset")
        return
    from .transport.mqtt import MQTT_AVAILABLE, MQTTMessage
    if not MQTT_AVAILABLE:
        raise CliError("paho-mqtt is not installed")
    from .process import REGISTRAR_BOOT_SUFFIX
    from .utils.configuration import (get_namespace,
                                      get_transport_configuration)
    config = get_transport_configuration()
    message = MQTTMessage(host=config.host, port=config.port,
                          username=config.username,
                          password=config.password, tls=config.tls)
    message.connect()
    if not message.connected():
        message.disconnect()
        error = message.stats["last_error"]
        raise CliError(f"cannot reach broker {config.host}:{config.port}"
                       f"{': ' + str(error) if error else ''}")
    boot_topic = f"{get_namespace()}/{REGISTRAR_BOOT_SUFFIX}"
    message.publish(boot_topic, "", retain=True, wait=True)
    message.disconnect()
    echo(f"cleared retained {boot_topic}")


# -- argument parsing ---------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    def transport(parser):
        parser.add_argument(
            "--transport", choices=["memory", "mqtt"],
            default=os.environ.get("AIKO_TPU_TRANSPORT", "memory"),
            help="control-plane transport")

    def state_file(parser):
        parser.add_argument("--state-file", default=_DEFAULT_STATE_FILE,
                            help="where to record the spawned pids")

    parser = argparse.ArgumentParser(
        prog="python -m aiko_services_tpu_torch",
        description="aiko_services_tpu_torch: the PyTorch/CUDA port.")
    commands = parser.add_subparsers(dest="command", required=True)
    for name, run in (("registrar", registrar), ("storage", storage),
                      ("recorder", recorder), ("dashboard", dashboard)):
        sub = commands.add_parser(name, help=run.__doc__.splitlines()[0])
        transport(sub)
        sub.set_defaults(run=run)

    pipeline = commands.add_parser("pipeline", help="Pipeline operations.")
    pipeline_commands = pipeline.add_subparsers(dest="pipeline_command",
                                                required=True)
    create = pipeline_commands.add_parser(
        "create", help="Run a pipeline from DEFINITION_PATHNAME.")
    create.add_argument("definition_pathname")
    create.add_argument("--name", default=None,
                        help="pipeline service name")
    create.add_argument("--stream", dest="stream_id", default="*",
                        help="stream id to create")
    create.add_argument("--stream-parameters", default="{}",
                        help="JSON dict of stream parameters")
    create.add_argument("--frame", dest="frame_json", default=None,
                        help="JSON swag for one immediate frame")
    create.add_argument("--mesh", dest="mesh_spec", default=None,
                        help="device mesh for the ComputeRuntime, e.g. "
                             "expert=4 (one process per rank and device, "
                             "launched as torchrun launches them)")
    create.add_argument("--device", default=None,
                        help="the ComputeRuntime's device (default: the "
                             "CUDA card; cpu runs on the CPU)")
    transport(create)
    create.set_defaults(run=pipeline_create, takes_element_flags=True)
    params = pipeline_commands.add_parser(
        "params", help="List every element parameter as its flags.")
    params.add_argument("definition_pathname")
    params.set_defaults(run=pipeline_params)
    show = pipeline_commands.add_parser(
        "show", help="Validate and print (or --dump) a definition.")
    show.add_argument("definition_pathname")
    show.add_argument("--dump", dest="dump_format", default=None,
                      choices=["json", "yaml"],
                      help="export the validated definition instead of "
                           "pretty-printing")
    show.add_argument("--output", dest="output_pathname", default=None,
                      help="write the --dump export to a file (default "
                           "stdout)")
    show.set_defaults(run=pipeline_show)

    system = commands.add_parser(
        "system", help="Bring a whole control plane up/down.")
    system_commands = system.add_subparsers(dest="system_command",
                                            required=True)
    start = system_commands.add_parser("start", help="One-command bring-up.")
    transport(start)
    state_file(start)
    start.add_argument("--services", default="registrar,recorder,storage",
                       help="comma-separated subcommands to spawn")
    start.set_defaults(run=system_start)
    for name, run in (("stop", system_stop), ("status", system_status)):
        sub = system_commands.add_parser(name,
                                         help=run.__doc__.splitlines()[0])
        state_file(sub)
        sub.set_defaults(run=run)
    reset = system_commands.add_parser("reset", help="Clear durable "
                                       "bootstrap state.")
    transport(reset)
    reset.set_defaults(run=system_reset)
    return parser


def main(argv=None) -> int:
    """Parse `argv` (default: sys.argv[1:]), run the command; returns the
    exit code."""
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    if extra and not getattr(args, "takes_element_flags", False):
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    args.element_flags = extra
    try:
        args.run(args)
    except CliError as exc:
        sys.stderr.write(f"Error: {exc}\n")
        return 1
    return 0


def registrar_main(argv=None) -> int:
    """Console entry of `registrar` (the JAX package's
    aiko_tpu_registrar): parses its own `argv` (default:
    sys.argv[1:]), e.g. ["--transport", "mqtt"]."""
    return main(["registrar", *(sys.argv[1:] if argv is None else argv)])


def dashboard_main(argv=None) -> int:
    """Console entry of `dashboard` (the JAX package's
    aiko_tpu_dashboard): parses its own `argv` (default:
    sys.argv[1:])."""
    return main(["dashboard", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    sys.exit(main())
