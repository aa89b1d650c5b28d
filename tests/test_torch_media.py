"""tests/test_media.py's three audio scenarios on the port's elements
(elements/audio.py), each beside the JAX package's on its own engine and
broker under a virtual clock: PE_MicrophoneSim → PE_FFT → PE_AudioFilter
→ PE_AudioResampler, PE_MicrophoneSim → PE_FFT → PE_GraphXY, and
PE_RemoteSend → a binary topic → PE_RemoteReceive across two runtimes.
The port's PE_FFT runs on the CPU here (parameter device "cpu").

Outputs equal the JAX elements': frequencies exactly, magnitudes and
band levels within 1e-5 x the largest (f32 FFTs of 4,000 points in
another order), the spectrum raster pixel for pixel, the remote tensor
exactly and encode_tensor's bytes byte for byte."""

import types

import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.elements import audio as JA
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.elements import audio as TA
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

PACKAGES = {"jax": (JE, JM, JProcessRuntime, JP),
            "torch": (TE, TM, TProcessRuntime, TP)}


def element(name, inputs=(), outputs=(), parameters=None):
    return {"name": name, "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "parameters": parameters or {}}


def runtimes(package, *names):
    """One engine on a virtual clock, one broker, a runtime per name."""
    event, memory, runtime_class, _ = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    return engine, [runtime_class(name=name, engine=engine,
                                  transport_factory=factory).initialize()
                    for name in names]


def run_chain(package, graph, elements, frames):
    """The one-stream pipeline driven until `frames` frames completed."""
    module = PACKAGES[package][3]
    engine, (runtime,) = runtimes(package, f"dsp_{package}")
    if package == "torch":
        for spec in elements:
            if spec["name"] == "PE_FFT":
                spec["parameters"]["device"] = "cpu"
    pipeline = module.Pipeline(runtime, module.parse_pipeline_definition({
        "version": 0, "name": "p_dsp", "runtime": "jax", "graph": [graph],
        "elements": elements}), stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s1", lease_time=0)
    for _ in range(40):
        if len(done) >= frames:
            break
        engine.clock.advance(0.25)
        engine.step()
    assert len(done) >= frames
    return pipeline, done


def dsp_elements(last):
    return [element("PE_MicrophoneSim", [], ["audio"],
                    {"chunk_seconds": 0.25, "limit": 2, "frequency": 440.0}),
            element("PE_FFT", ["audio"], ["frequencies", "magnitudes"])] + \
        last


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_mic_fft_filter_resample_matches_jax():
    graph = "(PE_MicrophoneSim (PE_FFT (PE_AudioFilter PE_AudioResampler)))"
    last = [element("PE_AudioFilter", ["frequencies", "magnitudes"],
                    ["frequencies", "magnitudes"],
                    {"low_hz": 100.0, "high_hz": 2000.0}),
            element("PE_AudioResampler", ["frequencies", "magnitudes"],
                    ["bands"], {"band_count": 8})]
    _, want = run_chain("jax", graph, dsp_elements(last), 2)
    _, got = run_chain("torch", graph, dsp_elements(last), 2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.swag["frequencies"],
                                      w.swag["frequencies"])
        close(g.swag["magnitudes"], w.swag["magnitudes"])
        close(g.swag["bands"], w.swag["bands"])
        assert np.asarray(g.swag["bands"]).shape == (8,)
        assert np.argmax(g.swag["bands"]) == 0    # 440 Hz: lowest band


def test_graph_xy_matches_jax():
    graph = "(PE_MicrophoneSim (PE_FFT (PE_GraphXY)))"
    last = [element("PE_GraphXY", ["frequencies", "magnitudes"], ["image"],
                    {"width": 64, "height": 32})]
    _, want = run_chain("jax", graph, dsp_elements(last), 1)
    pipeline, got = run_chain("torch", graph, dsp_elements(last), 1)
    image = np.asarray(got[0].swag["image"])
    assert image.shape == (32, 64, 3) and image.dtype == np.uint8
    np.testing.assert_array_equal(image, np.asarray(want[0].swag["image"]))
    heights = (image.sum(axis=2) > 0).sum(axis=0)
    assert heights.argmax() == 3 and heights[3] >= 31
    # a degenerate one-bin spectrum renders blank, not a crash
    graph_xy = pipeline.graph.node("PE_GraphXY").element
    out = graph_xy.process_frame(got[0], frequencies=np.array([0.0]),
                                 magnitudes=np.array([5.0]))
    assert out.ok and np.asarray(out.outputs["image"]).shape[2] == 3


@pytest.mark.parametrize("array", [
    np.arange(1000, dtype="float32").reshape(10, 100),
    np.sin(np.linspace(0, 10, 4000)).astype("float32"),
    np.array([[1, -2], [3, 4]], dtype=np.int16)])
def test_encode_tensor_bytes_match_jax(array):
    payload = TA.encode_tensor(array)
    assert payload == JA.encode_tensor(array)
    decoded = TA.decode_tensor(payload)
    assert decoded.dtype == array.dtype
    np.testing.assert_array_equal(decoded, array)


def test_remote_tensor_roundtrip():
    engine, (send_rt, recv_rt) = runtimes("torch", "send_host", "recv_host")
    topic = "tensors/audio/1"
    sender = TP.Pipeline(send_rt, TP.parse_pipeline_definition({
        "version": 0, "name": "p_send", "runtime": "python",
        "graph": ["(PE_RemoteSend)"],
        "elements": [element("PE_RemoteSend", ["audio"], [],
                             {"topic": topic})]}), stream_lease_time=0)
    receiver = TP.Pipeline(recv_rt, TP.parse_pipeline_definition({
        "version": 0, "name": "p_recv", "runtime": "python",
        "graph": ["(PE_RemoteReceive)"],
        "elements": [element("PE_RemoteReceive", [], ["audio"],
                             {"topic": topic})]}), stream_lease_time=0)
    received = []
    receiver.add_frame_handler(received.append)
    receiver.create_stream("r1", lease_time=0)
    sender.create_stream("s1", lease_time=0)
    audio = np.sin(np.linspace(0, 10, 4000)).astype("float32")
    sender.process_frame("s1", {"audio": audio})
    for _ in range(10):
        engine.step()
    assert len(received) == 1
    np.testing.assert_array_equal(received[0].swag["audio"], audio)
    receiver.destroy_stream("r1")
    sender.process_frame("s1", {"audio": audio})
    for _ in range(10):
        engine.step()
    assert len(received) == 1              # unsubscribed at stream stop


def test_microphone_without_sounddevice_raises():
    try:
        import sounddevice  # noqa: F401
        pytest.skip("a capture stack is installed")
    except ImportError:
        pass
    mic = TA.PE_Microphone.__new__(TA.PE_Microphone)
    with pytest.raises(RuntimeError, match="PE_MicrophoneSim"):
        mic.start_stream(None)


def test_fft_defaults_to_the_card():
    """Without a card the default device raises: PE_FFT never falls back
    to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, (runtime,) = runtimes("torch", "fft_host")
    pipeline = TP.Pipeline(runtime, TP.parse_pipeline_definition({
        "version": 0, "name": "p_fft", "runtime": "jax",
        "graph": ["(PE_FFT)"],
        "elements": [element("PE_FFT", ["audio"],
                             ["frequencies", "magnitudes"])]}),
        stream_lease_time=0)
    pipeline.create_stream("s1", lease_time=0)
    fft = pipeline.graph.node("PE_FFT").element
    frame = types.SimpleNamespace(stream=pipeline.streams["s1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fft.process_frame(frame, audio=np.zeros(16, np.float32))
