"""The repo's Python examples on the port (aiko_services_tpu_torch/
examples/), held against the JAX examples under examples/.

- xgo: the teleop client drives the robot across runtimes, tails its
  camera and mirrors its telemetry, and the simulated hardware moves its
  camera and drains its battery (tests/test_xgo.py's two cases).
- aloha: the RPC and share cases of tests/test_system.py (local RPC, the
  remote proxy, discovery, the share's snapshot and deltas) with the
  examples' own AlohaHonua, each scenario on both packages, with equal
  observations.
- each runner's --self-test exits 0 and prints what the JAX script
  prints.
- video_to_images writes the same images as the JAX script from a small
  seeded synthetic video (cv2 and PIL: this file's video cases run on
  the CPU only), and images_to_video reads them back into a video of
  the same frame count; the JAX images_to_video writes no frame
  (ROADMAP Queue 3 item 18).
- examples/pipeline/pipeline_remote.json runs end to end on the port
  against an inline p_remote_server; the JAX package fails its first
  frame (ROADMAP Queue 3 item 17)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch.examples.aloha_honua import aloha_honua
from aiko_services_tpu_torch.examples.xgo_robot.robot_control import (
    MOVE_STEP, RobotControl, frame_to_ascii)
from aiko_services_tpu_torch.examples.xgo_robot.xgo_robot import (
    SimulatedXgo, XgoRobot)
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.transport import memory as TM

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")


def load_example(folder: str, name: str):
    """A JAX example script as a module (it puts the repo root on
    sys.path itself)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, folder, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Host:
    """One package's engine (virtual clock), broker and runtimes."""

    def __init__(self, package: str):
        if package == "jax":
            from aiko_services_tpu import event
            from aiko_services_tpu.process import ProcessRuntime
            from aiko_services_tpu.registrar import Registrar
            from aiko_services_tpu.transport import memory
            from aiko_services_tpu import actor, service, share
            self.alohas = load_example("aloha_honua", "aloha_honua")
        else:
            event, memory = TE, TM
            ProcessRuntime, Registrar = TProcessRuntime, TRegistrar
            from aiko_services_tpu_torch import actor, service, share
            self.alohas = aloha_honua
        self.actor, self.service, self.share = actor, service, share
        self.registrar_class = Registrar
        self.runtime_class, self.memory = ProcessRuntime, memory
        self.engine = event.EventEngine(event.VirtualClock())
        self.broker = memory.MemoryBroker()

    def runtime(self, name):
        memory = self.memory

        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=self.broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain)
        return self.runtime_class(name=name, engine=self.engine,
                                  namespace="test", process_id=name,
                                  transport_factory=factory).initialize()

    def settle(self, seconds=5.0, tick=0.05):
        """Advance virtual time, stepping the engine each tick
        (tests/test_system.py's settle)."""
        for _ in range(int(seconds / tick)):
            while self.engine.step():
                pass
            self.engine.clock.advance(tick)
        while self.engine.step():
            pass


def both(scenario):
    """The scenario's observations on each package; they must agree."""
    port, reference = scenario(Host("torch")), scenario(Host("jax"))
    assert port == reference
    return port


# -- xgo (tests/test_xgo.py) ----------------------------------------------

def steps(engine, count=12):
    for _ in range(count):
        engine.step()


def test_teleop_drives_robot_across_runtimes():
    host = Host("torch")
    engine = host.engine
    TRegistrar(host.runtime("reg_host"))
    engine.clock.advance(2.1)
    steps(engine)

    robot = XgoRobot(host.runtime("robot_host"))
    control = RobotControl(host.runtime("pilot_host"))
    steps(engine, 20)
    assert control.connected

    # keyboard → RPC → hardware state
    assert control.handle_key("w")
    assert control.handle_key("q")
    assert control.handle_key("g")
    steps(engine, 10)
    assert robot.hardware.pose["x"] == MOVE_STEP
    assert robot.hardware.attitude["yaw"] == 345.0
    assert robot.hardware.claw_grip == 255
    assert not control.handle_key("?")     # unmapped key

    # video: the robot publishes tensors; the teleop tails and rasterizes
    control.start_video(rate=20.0)
    for _ in range(8):
        engine.clock.advance(0.05)
        steps(engine, 2)
    assert control.frames_seen >= 3
    assert control.last_frame.shape == (120, 160, 3)
    rows = frame_to_ascii(control.last_frame, width=32, height=10)
    assert len(rows) == 10 and any(c != " " for r in rows for c in r)
    control.stop_video()

    # telemetry mirrors over EC
    engine.clock.advance(5.1)
    steps(engine, 10)
    assert "battery" in control.telemetry
    assert "battery" in "\n".join(control.status_lines())

    # robot death → teleop detaches (drain the video-phase backlog)
    robot.runtime.message.crash()
    for _ in range(300):
        engine.step()
        if not control.connected:
            break
    assert not control.connected
    assert "searching" in control.status_lines()[0]
    control.terminate()


def test_simulated_hardware_camera_and_battery():
    sim = SimulatedXgo()
    first = sim.capture_image()
    second = sim.capture_image()
    assert first.shape == (120, 160, 3)
    assert not np.array_equal(first, second)     # phase advances
    start = sim.battery
    assert sim.read_battery() == start - 1
    sim, jax_sim = SimulatedXgo(), \
        load_example("xgo_robot", "xgo_robot").SimulatedXgo()
    for _ in range(3):
        np.testing.assert_array_equal(sim.capture_image(),
                                      jax_sim.capture_image())


def test_teleop_key_map_and_ascii_match_the_jax_client():
    reference = load_example("xgo_robot", "robot_control")
    from aiko_services_tpu_torch.examples.xgo_robot import robot_control
    assert robot_control.KEY_COMMANDS == reference.KEY_COMMANDS
    frame = np.random.default_rng(3).integers(0, 256, (120, 160, 3),
                                              dtype=np.uint8)
    for width, height in ((64, 20), (32, 10), (7, 3)):
        assert frame_to_ascii(frame, width, height) == \
            reference.frame_to_ascii(frame, width, height)
    assert frame_to_ascii(None) == reference.frame_to_ascii(None)


# -- aloha (tests/test_system.py's RPC and share cases) ---------------------

def test_local_rpc_via_topic():
    def scenario(host):
        host.registrar_class(host.runtime("registrar"))
        worker = host.runtime("worker")
        actor = host.alohas.AlohaHonua(worker)
        host.settle(3.0)
        worker.publish(actor.topic_in, "(aloha Pele)")
        host.settle(0.2)
        return actor.ec_producer.get("greetings")
    assert both(scenario) == 1


def test_remote_proxy():
    def scenario(host):
        host.registrar_class(host.runtime("registrar"))
        actor = host.alohas.AlohaHonua(host.runtime("worker"))
        client = host.runtime("client")
        host.settle(3.0)
        proxy = host.actor.get_remote_proxy(client, actor.topic_in,
                                            host.alohas.AlohaHonua)
        proxy.aloha("Hiʻiaka")
        proxy.aloha("Pele")
        host.settle(0.2)
        return actor.ec_producer.get("greetings")
    assert both(scenario) == 2


def test_discovery():
    def scenario(host):
        host.registrar_class(host.runtime("registrar"))
        host.alohas.AlohaHonua(host.runtime("worker"))
        found = []
        discovery = host.actor.ActorDiscovery(host.runtime("client"))
        discovery.add_handler(
            lambda command, fields: found.append((command, fields.name)),
            host.service.ServiceFilter(name="aloha_honua"))
        host.settle(3.0)
        return found
    assert ("add", "aloha_honua") in both(scenario)


def test_share_snapshot_and_delta():
    def scenario(host):
        host.registrar_class(host.runtime("registrar"))
        producer = host.runtime("producer")
        actor = host.alohas.AlohaHonua(producer)
        cache = {}
        consumer = host.share.ECConsumer(host.runtime("consumer"), cache,
                                         actor.topic_control)
        host.settle(3.0)
        seen = [(consumer.synchronized, cache.get("lifecycle"),
                 cache.get("greetings"))]
        producer.publish(actor.topic_in, "(aloha Pele)")
        host.settle(0.2)
        actor.ec_producer.update("custom", 42)
        host.settle(0.2)
        seen.append((cache.get("greetings"), cache.get("custom")))
        actor.ec_producer.remove("custom")
        host.settle(0.2)
        seen.append("custom" in cache)
        return seen
    assert both(scenario) == [(True, "ready", 0), (1, 42), False]


# -- the self-tests --------------------------------------------------------

SELF_TESTS = {
    "aloha_honua": ("aloha_honua", "aloha_honua"),
    "xgo_robot": ("xgo_robot", "xgo_robot"),
    "robot_control": ("xgo_robot", "robot_control"),
}


@pytest.mark.parametrize("name", sorted(SELF_TESTS))
def test_self_test_prints_what_the_jax_script_prints(name):
    folder, module = SELF_TESTS[name]
    env = {**os.environ, "PYTHONPATH": ROOT}
    port = subprocess.Popen(
        [sys.executable, "-m",
         f"aiko_services_tpu_torch.examples.{folder}.{module}",
         "--self-test"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    reference = subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, folder, f"{module}.py"),
         "--self-test"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port_out, port_err = port.communicate(timeout=120)
    reference_out, _ = reference.communicate(timeout=120)
    assert port.returncode == 0, port_err
    assert reference.returncode == 0
    assert "self-test ok" in port_out
    assert port_out == reference_out


# -- the video scripts -----------------------------------------------------

def synthetic_video(pathname: str, frames: int = 6, size=(64, 48)):
    """A seeded mp4v video of moving bars."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    writer = cv2.VideoWriter(pathname, cv2.VideoWriter_fourcc(*"mp4v"),
                             10.0, size)
    for i in range(frames):
        image = np.zeros((size[1], size[0], 3), np.uint8)
        image[:, (i * 9) % size[0]] = rng.integers(64, 256, 3)
        image[(i * 5) % size[1], :] = 200
        writer.write(image)
    writer.release()


@pytest.mark.parametrize("overlay", [False, True], ids=["plain", "overlay"])
def test_video_to_images_matches_jax_and_reads_back_to_video(tmp_path, overlay,
                                                        monkeypatch):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    from aiko_services_tpu_torch.examples.pipeline import (images_to_video,
                                                           video_to_images)
    video = str(tmp_path / "in.mp4")
    synthetic_video(video)
    flags = ["--overlay"] if overlay else []
    for side in ("port", "jax"):
        pattern = str(tmp_path / side / "image_{frame:06d}.png")
        argv = [video, pattern, *flags]
        if side == "port":
            assert video_to_images.main(argv) == 0
        else:
            monkeypatch.setattr(sys, "argv", ["video_to_images", *argv])
            assert load_example("pipeline", "video_to_images").main() == 0
    port = sorted(os.listdir(tmp_path / "port"))
    assert port == sorted(os.listdir(tmp_path / "jax")) and len(port) == 6
    for name in port:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name

    pattern = str(tmp_path / "port" / "image_{frame:06d}.png")
    out = str(tmp_path / "port.mp4")
    assert images_to_video.main([pattern, out, "--fps", "10"]) == 0
    capture = cv2.VideoCapture(out)
    assert int(capture.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    capture.release()


def test_jax_images_to_video_writes_no_frame(tmp_path, monkeypatch,
                                             capsys):
    """The JAX script's PE_ImageReadFile declares no input, so the walk
    never hands it the posted pathname and every frame fails; it then
    waits out its 600 s timeout (cut here to 1 s) and exits 1."""
    pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    from PIL import Image

    from aiko_services_tpu import event as JE

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "image_000000.png")
    run_until = JE.EventEngine.run_until
    monkeypatch.setattr(JE.EventEngine, "run_until",
                        lambda self, predicate, timeout=5.0:
                        run_until(self, predicate, min(timeout, 1.0)))
    monkeypatch.setattr(sys, "argv", [
        "images_to_video", str(tmp_path / "image_{frame:06d}.png"),
        str(tmp_path / "jax.mp4")])
    assert load_example("pipeline", "images_to_video").main() == 1
    assert "wrote 0 frames" in capsys.readouterr().out


# -- examples/pipeline/pipeline_remote.json --------------------------------

def test_remote_example_runs_against_an_inline_server():
    """The caller definition as written, discovered server
    p_remote_server squaring each decoded number: five frames come back
    with their squares on the port, none fails.  The JAX package fails
    the first frame at PE_DataEncode, which reads "data" where the
    definition declares "number", and stops the stream."""
    def scenario(host):
        if host.runtime_class is TProcessRuntime:
            from aiko_services_tpu_torch import pipeline as P
            from aiko_services_tpu_torch.share import ServicesCache
        else:
            from aiko_services_tpu import pipeline as P
            from aiko_services_tpu.share import ServicesCache

        class PE_Square(P.PipelineElement):
            def process_frame(self, frame, number=None, **_):
                return P.FrameOutput(True, {"result": int(number) ** 2})

        host.registrar_class(host.runtime("reg_host"))
        host.settle(2.2)
        P.Pipeline(host.runtime("serve_host"), P.parse_pipeline_definition({
            "version": 0, "name": "p_remote_server", "runtime": "python",
            "graph": ["(PE_DataDecode (PE_Square))"],
            "elements": [
                {"name": "PE_DataDecode", "input": [{"name": "number"}],
                 "output": [{"name": "number"}]},
                {"name": "PE_Square", "input": [{"name": "number"}],
                 "output": [{"name": "result"}]}]}),
            element_classes={"PE_Square": PE_Square},
            auto_create_streams=True, stream_lease_time=0)
        caller_runtime = host.runtime("call_host")
        caller = P.Pipeline(
            caller_runtime, P.load_pipeline_definition(
                os.path.join(EXAMPLES, "pipeline", "pipeline_remote.json")),
            services_cache=ServicesCache(caller_runtime),
            stream_lease_time=0)
        done = []
        caller.add_frame_handler(done.append)
        host.settle(1.0)
        ready = caller.remote_elements_ready()
        caller.create_stream("s0", lease_time=0)
        host.settle(2.0)
        return (ready, sorted((f.frame_id, int(f.swag["result"]))
                              for f in done),
                caller.recovery_stats["frames_failed"])

    assert scenario(Host("torch")) == \
        (True, [(i, i * i) for i in range(5)], 0)
    ready, results, failed = scenario(Host("jax"))
    assert ready and results == [] and failed == 1
