"""The vision pipelines on both packages, each in its own package's
pipeline on its own engine under a virtual clock, with the JAX elements'
weights (PRNGKey(0)) overlaid onto the port elements' models after setup
(bridge.params_from_numpy): the detect graph (PE_Detect (PE_Tracker))
at detector_test in sync, batched and batched + pipelined modes on the
raw and dct8 wires, and examples/pipeline/pipeline_classify.json as it
is (ResNet-18 at 224, PNGs written into tmp_path).  Classes, track ids
and class ids are equal; boxes and scores within 1e-3 pixels and 1e-4,
confidences within 1e-4 × max.  Also the detect example file as it is
on the port's CPU path: PE_VideoReadFile reading an OpenCV-written file,
detector_r18 at 256, batches padded to 32, pipelined."""

import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JP, JComputeRuntime),
    "torch": (TE, TM, TProcessRuntime, TP, TComputeRuntime),
}
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
SIZE = 64
STREAMS, FRAMES = 3, 4


def _runtime(package, name):
    event, memory, runtime_class, module, compute_class = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = runtime_class(name=name, engine=engine,
                            transport_factory=factory).initialize()
    compute = compute_class(runtime, "compute", **(
        {"device": "cpu"} if package == "torch" else {}))
    return engine, runtime, compute


def _element(pipeline, name):
    return next(node.element for node in pipeline.graph.nodes()
                if node.name == name)


def moving_frames(seed):
    """STREAMS x FRAMES uint8 frames with a bright rectangle each that
    moves a few pixels a frame."""
    rng = np.random.default_rng(seed)
    frames = {}
    for s in range(STREAMS):
        x, y = rng.integers(4, SIZE - 28, 2)
        for f in range(FRAMES):
            image = rng.integers(0, 60, (SIZE, SIZE, 3), dtype=np.uint8)
            image[y + 2 * f:y + 2 * f + 20, x + f:x + f + 24] = \
                rng.integers(180, 255, 3, dtype=np.uint8)
            frames[(f"s{s}", f)] = image
    return frames


def detect_run(package, parameters, frames, overlay=None):
    """Every frame posted into (PE_Detect (PE_Tracker)); returns
    ({(stream, frame): swag}, the element)."""
    engine, runtime, _ = _runtime(package, f"det_{package}")
    module = PACKAGES[package][3]
    definition = module.parse_pipeline_definition({
        "version": 0, "name": "p_det", "runtime": "jax",
        "graph": ["(PE_Detect (PE_Tracker))"],
        "parameters": {f"PE_Detect.{key}": value for key, value in {
            "preset": "detector_test", "image_size": SIZE,
            "score_threshold": 0.0, "max_batch": 4, **parameters}.items()},
        "elements": [
            {"name": "PE_Detect", "input": [{"name": "image"}],
             "output": [{"name": "boxes"}, {"name": "scores"},
                        {"name": "classes"}]},
            {"name": "PE_Tracker", "input": [{"name": "boxes"}],
             "output": [{"name": "tracks"}]}]})
    pipeline = module.Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    streams = sorted({stream for stream, _ in frames})
    for stream in streams:
        pipeline.create_stream(stream, lease_time=0)
    detector = _element(pipeline, "PE_Detect")
    if overlay is not None:
        detector.params = bridge.params_from_numpy(
            overlay, detector.config, device="cpu")
    sync = parameters.get("mode") == "sync"
    out = {}
    for stream, f in sorted(frames, key=lambda key: (key[1], key[0])):
        if sync:
            ok, swag = pipeline.process_frame(
                stream, {"image": frames[(stream, f)]})
            assert ok
            out[(stream, f)] = swag
        else:
            pipeline.post("process_frame", stream,
                          {"image": frames[(stream, f)]})
    deadline = time.monotonic() + 60.0
    while not sync and len(done) < len(frames) and \
            time.monotonic() < deadline:
        engine.clock.advance(0.01)
        engine.step()
        time.sleep(0.0005)
    for frame in done:
        out[(frame.stream_id, frame.frame_id)] = frame.swag
    assert len(out) == len(frames)
    return out, detector


@pytest.fixture(scope="module")
def jax_detector():
    """The JAX PE_Detect's weights for detector_test, drawn as the element
    draws them (eagerly, from PRNGKey(0)), as numpy leaves.  Eager init
    compiles each random op once a process: here, not in the first
    test."""
    from aiko_services_tpu.models.detector import (DETECTOR_PRESETS,
                                                   detector_init)
    return jax.tree.map(np.asarray, detector_init(
        jax.random.PRNGKey(0), DETECTOR_PRESETS["detector_test"]))


def assert_same_swag(port, reference):
    assert sorted(port) == sorted(reference)
    detections = 0
    for key, want in reference.items():
        got = port[key]
        assert got["classes"] == want["classes"], key
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   rtol=0, atol=1e-4, err_msg=str(key))
        np.testing.assert_allclose(
            np.asarray(got["boxes"]).reshape(-1, 4),
            np.asarray(want["boxes"]).reshape(-1, 4), rtol=1e-4,
            atol=1e-3, err_msg=str(key))
        assert [t["track_id"] for t in got["tracks"]] == \
            [t["track_id"] for t in want["tracks"]], key
        detections += len(want["classes"])
    assert detections > 0


@pytest.mark.parametrize("mode,pipelined", [("sync", False),
                                            ("batched", False),
                                            ("batched", True)])
@pytest.mark.parametrize("wire", ["raw", "dct8"])
def test_detect_graph_matches_jax(jax_detector, mode, pipelined, wire):
    frames = moving_frames(0)
    parameters = {"mode": mode, "pipelined": pipelined, "wire": wire,
                  "max_in_flight": 2}
    reference, _ = detect_run("jax", parameters, frames)
    port, element = detect_run("torch", parameters, frames,
                               overlay=jax_detector)
    assert_same_swag(port, reference)
    stats = element.compute.programs[element._program].scheduler.stats
    assert stats["items"] == len(frames)
    if mode == "batched":
        assert stats["batches"] < len(frames)     # streams coalesce
    program = element.compute.programs[element._program]
    if pipelined:
        assert program.in_flight["now"] == 0
        assert 1 <= program.in_flight["peak"] <= 2


def test_detect_element_resizes_and_keeps_float_frames(jax_detector):
    """A frame at another size is resized on the host (PIL); float
    frames keep the 0-255 contract: both as in JAX."""
    rng = np.random.default_rng(4)
    frames = {("s0", 0): rng.integers(0, 255, (80, 96, 3), dtype=np.uint8),
              ("s0", 1): rng.uniform(0, 255, (SIZE, SIZE, 3)).astype(
                  np.float32)}
    parameters = {"mode": "sync"}
    reference, _ = detect_run("jax", parameters, frames)
    port, _ = detect_run("torch", parameters, frames, overlay=jax_detector)
    assert_same_swag(port, reference)


def classify_run(package, tmp_path, images, monkeypatch, overlay=None):
    """examples/pipeline/pipeline_classify.json as it is, one stream per
    PNG; returns ({stream: swag}, the classify element)."""
    engine, runtime, _ = _runtime(package, f"cls_{package}")
    module = PACKAGES[package][3]
    definition = module.load_pipeline_definition(
        str(EXAMPLES / "pipeline" / "pipeline_classify.json"))
    out_dir = tmp_path / package
    out_dir.mkdir()
    monkeypatch.chdir(out_dir)         # the example writes into the cwd
    pipeline = module.Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for i, path in enumerate(images):
        pipeline.create_stream(f"s{i}", lease_time=0, parameters={
            "PE_ImageReadFile.pathname": str(path)})
    classify = _element(pipeline, "PE_ImageClassify")
    if overlay is not None:
        classify.params = bridge.params_from_numpy(
            overlay, classify.config, device="cpu")
    for i in range(len(images)):
        pipeline.post("process_frame", f"s{i}", {})
    for _ in range(400):
        if len(done) == len(images):
            break
        engine.clock.advance(0.01)
        engine.step()
    assert len(done) == len(images)
    written = sorted(path.name for path in out_dir.iterdir())
    return {frame.stream_id: frame.swag for frame in done}, classify, \
        written


def test_classify_example_matches_jax(tmp_path, monkeypatch):
    from PIL import Image
    rng = np.random.default_rng(7)
    images = []
    for i, shape in enumerate(((240, 320, 3), (224, 224, 3), (96, 128, 3))):
        path = tmp_path / f"in_{i}.png"
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(
            path)
        images.append(path)
    reference, jax_element, jax_written = classify_run(
        "jax", tmp_path, images, monkeypatch)
    port, element, written = classify_run(
        "torch", tmp_path, images, monkeypatch,
        overlay=jax.tree.map(np.asarray, jax_element.params))
    assert written == jax_written == ["classified_0.png"]
    confidences = [want["confidence"] for want in reference.values()]
    for stream, want in reference.items():
        got = port[stream]
        assert isinstance(got["class_id"], int)
        assert got["class_id"] == want["class_id"], stream
        assert abs(got["confidence"] - want["confidence"]) <= \
            1e-4 * max(confidences)
    stats = element.compute.programs[element._program].scheduler.stats
    assert stats["items"] == 3 and stats["batches"] == 1


def test_detect_example_runs_on_the_port(tmp_path):
    """examples/pipeline/pipeline_detect.json as it is, on the CPU: its
    video source reads an OpenCV-written file; detector_r18 at 256,
    batches padded to 32, pipelined."""
    cv2 = pytest.importorskip("cv2")
    source = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(source, cv2.VideoWriter_fourcc(*"mp4v"),
                             20.0, (256, 256))
    rng = np.random.default_rng(8)
    for f in range(4):
        image = rng.integers(0, 50, (256, 256, 3), dtype=np.uint8)
        image[40 + 4 * f:120 + 4 * f, 60:160] = 220
        writer.write(image)
    writer.release()
    engine, runtime, compute = _runtime("torch", "det_example")
    definition = TP.load_pipeline_definition(
        str(EXAMPLES / "pipeline" / "pipeline_detect.json"))
    pipeline = TP.Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("cam", lease_time=0, parameters={
        "PE_VideoReadFile.pathname": source})
    detector = _element(pipeline, "PE_Detect")
    program = compute.programs[detector._program]
    deadline = time.monotonic() + 60.0
    while (len(done) < 4 or "cam" in pipeline.streams) and \
            time.monotonic() < deadline:
        if program.in_flight["now"] == 0:     # the clock waits for a batch
            engine.clock.advance(0.01)
        engine.step()
        time.sleep(0.001)
    # every frame completes, and the reader ends the stream after them
    assert len(done) == 4 and "cam" not in pipeline.streams
    assert detector.config.backbone.width == 64
    assert program.scheduler.dispatch_gate is not None      # pipelined
    assert program.in_flight["now"] == 0
    for frame in done:
        swag = frame.swag
        assert len(swag["tracks"]) == len(swag["boxes"]) == \
            len(swag["scores"]) == len(swag["classes"])
        assert all(0 <= c < 80 for c in swag["classes"])
