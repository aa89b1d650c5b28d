"""PE_NeuralTTS (elements/tts.py) on both packages, each in its own
package's pipeline on its own engine under a virtual clock, with the same
weights: the JAX element's checkpoint written by the JAX package's
save_flat_npz (test preset, and the test vocoder's) and read by both
elements' `weights` / `vocoder_weights`.  Then the assistant example
(examples/speech/pipeline_assistant.json) as written on the port's CPU
path, with the test presets.

Texts: short, longer than max_tokens (truncated at 32 bytes: its audio
equals the first 32 bytes'), empty (a space's audio).  Sample counts are
equal; Griffin-Lim audio (gl_iters 4) within 2e-3 relative L2 and the
vocoder's within 1e-4 x its largest sample (the model-level limits of
tests/test_torch_tts.py)."""

import functools
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.models import tts as JT
from aiko_services_tpu.models import vocoder as JV
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

PACKAGES = {"jax": (JE, JM, JProcessRuntime, JP, JComputeRuntime),
            "torch": (TE, TM, TProcessRuntime, TP, TComputeRuntime)}
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
LONG = "the quick brown fox jumps over the lazy dog, twice over"
TEXTS = ["hello there", LONG, "", "tts"]
GL_REL_L2, VOCODER_TOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(TTS npz, vocoder npz) of JAX weights."""
    path = tmp_path_factory.mktemp("tts")
    tts = jax.jit(functools.partial(JT.tts_init,
                                    config=JT.TTS_PRESETS["test"]))(
        jax.random.PRNGKey(3))
    vocoder = jax.jit(functools.partial(
        JV.vocoder_init, config=JV.VOCODER_PRESETS["test"]))(
        jax.random.PRNGKey(4))
    save_flat_npz(tts, str(path / "tts.npz"))
    save_flat_npz(vocoder, str(path / "vocoder.npz"))
    return str(path / "tts.npz"), str(path / "vocoder.npz")


def _runtime(package):
    event, memory, runtime_class, module, compute_class = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = runtime_class(name=f"tts_{package}", engine=engine,
                            transport_factory=factory).initialize()
    compute_class(runtime, "compute", **(
        {"device": "cpu"} if package == "torch" else {}))
    return engine, runtime, module


def speak(package, texts, mode, weights, vocoder=None) -> list:
    """Each text through (PE_NeuralTTS) on one stream; the audio of
    each, in order."""
    engine, runtime, module = _runtime(package)
    parameters = {"preset": "test", "mode": mode, "weights": weights,
                  "gl_iters": 4, "max_batch": 8}
    if vocoder:
        parameters["vocoder_weights"] = vocoder
    pipeline = module.Pipeline(runtime, module.parse_pipeline_definition({
        "version": 0, "name": "p_tts", "runtime": "jax",
        "graph": ["(PE_NeuralTTS)"],
        "parameters": {f"PE_NeuralTTS.{key}": value
                       for key, value in parameters.items()},
        "elements": [{"name": "PE_NeuralTTS", "input": [{"name": "text"}],
                      "output": [{"name": "audio"},
                                 {"name": "sample_rate"}]}]}),
        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s1", lease_time=0)
    if mode == "sync":
        out = []
        for text in texts:
            ok, swag = pipeline.process_frame("s1", {"text": text})
            assert ok and swag["sample_rate"] == 16000
            out.append(np.asarray(swag["audio"]))
        return out
    for text in texts:
        pipeline.post("process_frame", "s1", {"text": text})
    for _ in range(400):
        if len(done) == len(texts):
            break
        engine.step()
        engine.clock.advance(0.01)
    assert len(done) == len(texts)
    return [np.asarray(frame.swag["audio"]) for frame in
            sorted(done, key=lambda frame: frame.frame_id)]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check(got, want, vocoder):
    assert [a.size for a in got] == [a.size for a in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.size >= 160
        if vocoder:
            assert np.max(np.abs(g - w)) <= VOCODER_TOL * np.max(np.abs(w))
        else:
            assert rel_l2(g, w) <= GL_REL_L2


@pytest.mark.parametrize("vocoder", [False, True],
                         ids=["griffin_lim", "vocoder"])
@pytest.mark.parametrize("mode", ["sync", "batched"])
def test_neural_tts_matches_jax(checkpoints, mode, vocoder):
    weights, vocoder_npz = checkpoints
    vocoder_npz = vocoder_npz if vocoder else None
    want = speak("jax", TEXTS, mode, weights, vocoder_npz)
    got = speak("torch", TEXTS, mode, weights, vocoder_npz)
    check(got, want, vocoder)
    # truncation at max_tokens, and the empty text's space
    again = speak("torch", [LONG[:32], " "], mode, weights, vocoder_npz)
    np.testing.assert_array_equal(again[0], got[1])
    np.testing.assert_array_equal(again[1], got[2])


def test_assistant_example_runs_on_the_port():
    """The example as written, on the CPU at test sizes: every frame
    completes with text, a response and audio from PE_NeuralTTS, and
    PE_Speaker collects the audio of every stream."""
    engine, runtime, module = _runtime("torch")
    raw = json.loads((EXAMPLES / "speech/pipeline_assistant.json")
                     .read_text())
    assert "PE_NeuralTTS" in raw["graph"][0]
    raw["parameters"].update({"PE_WhisperASR.preset": "test",
                              "PE_NeuralTTS.preset": "test",
                              "PE_LogMel.device": "cpu"})
    pipeline = module.Pipeline(runtime,
                               module.parse_pipeline_definition(raw),
                               stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for i in range(2):
        pipeline.create_stream(f"a{i}", parameters={
            "PE_MicrophoneSim.limit": 2,
            "PE_MicrophoneSim.frequency": 200.0 + 60 * i}, lease_time=0)
    while len(done) < 4 and engine.clock.now() < 60.0:
        while engine.step():
            pass
        engine.clock.advance(0.01)
    assert len(done) == 4
    assert pipeline.recovery_stats["frames_failed"] == 0
    tts = pipeline.graph.node("PE_NeuralTTS").element
    assert tts.config.max_frames == 96 and tts.vocoder is None
    for frame in done:
        swag = frame.swag
        assert isinstance(swag["response"], str)
        audio = np.asarray(swag["audio"])
        assert audio.dtype == np.float32 and audio.size >= 160
        assert audio.size % 160 == 0
        assert np.all(np.isfinite(audio))
    for stream_id, stream in pipeline.streams.items():
        audio = stream.variables.get("speaker.audio")
        assert audio is not None and audio.size, stream_id
