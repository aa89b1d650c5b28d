"""examples/speech/pipeline_transcription.json, unedited, on both
packages: PE_MicrophoneSim → PE_AudioFraming → PE_LogMel → PE_WhisperASR
→ PE_Synthesize → PE_Speaker, each in its own package's pipeline on its
own engine under a virtual clock.  Both serve the "test" Whisper preset
from the same seeded weights (a JAX param tree written with the JAX
package's save_flat_npz and loaded through the `weights` parameter);
each ASR element's model is switched to f32 after its setup, as
tests/test_torch_serving.py does, so that tokens are equal.  PE_LogMel
runs on the host ("cpu")."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.bridge import load_flat_npz
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

DEFINITION = "examples/speech/pipeline_transcription.json"
PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JP, JComputeRuntime),
    "torch": (TE, TM, TProcessRuntime, TP, TComputeRuntime),
}
# the example's buckets with a checkpoint loaded: flash rounding is off
BUCKETS = [500, 1000, 3000]
MAX_TOKENS = 24
OVERRIDES = {
    "PE_WhisperASR.preset": "test",
    "PE_WhisperASR.max_batch": 8,
    # random weights give near-uniform logprobs: open the gates
    "PE_WhisperASR.logprob_threshold": -1e9,
    "PE_WhisperASR.compression_ratio_threshold": 1e9,
    "PE_LogMel.device": "cpu",
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX ASR element's model for the example's parameters, in f32,
    saved as a flat npz."""
    config = dataclasses.replace(
        JW.WHISPER_PRESETS["test"], n_audio_ctx=max(BUCKETS) // 2,
        n_text_ctx=MAX_TOKENS + 8)
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("weights") / "whisper_test.npz")
    save_flat_npz(params, path)
    return params, path


def _build(package, weights, **parameters):
    event, memory, runtime_class, module, compute_class = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = runtime_class(name="speech_host", engine=engine,
                            transport_factory=factory).initialize()
    compute = compute_class(runtime, "compute", **(
        {"device": "cpu"} if package == "torch" else {}))
    definition = module.load_pipeline_definition(DEFINITION)
    definition.parameters.update(OVERRIDES, **parameters)
    definition.parameters["PE_WhisperASR.weights"] = weights[1]
    pipeline = module.Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    return engine, compute, pipeline, done


def _to_f32(package, element, weights):
    """Switch a set-up ASR element's model to f32 (the batched program
    reads config and params at each call)."""
    if package == "jax":
        element.config = dataclasses.replace(element.config,
                                             dtype=jnp.float32)
        element.params = weights[0]
    else:
        element.config = dataclasses.replace(element.config,
                                             dtype=torch.float32)
        element.params = load_flat_npz(element.params.float(), weights[1])


def _run(package, weights, streams, frames_each, **parameters):
    engine, compute, pipeline, done = _build(
        package, weights, **{"PE_MicrophoneSim.limit": frames_each,
                             **parameters})
    for i in range(streams):
        pipeline.create_stream(f"s{i}", lease_time=0, parameters={
            "PE_MicrophoneSim.frequency": 220.0 + 110.0 * i})
    asr = next(node.element for node in pipeline.graph.nodes()
               if node.name == "PE_WhisperASR")
    _to_f32(package, asr, weights)
    while len(done) < streams * frames_each and engine.clock.now() < 30.0:
        while engine.step():
            pass
        engine.clock.advance(0.01)
    speaker = {sid: stream.variables.get("speaker.audio")
               for sid, stream in pipeline.streams.items()}
    for sid in list(pipeline.streams):
        pipeline.destroy_stream(sid)
    leftover = [getattr(h, "__qualname__", "") for h in
                engine.live_timer_handlers()]
    scheduler = compute.programs["whisper_asr.PE_WhisperASR"].scheduler
    return done, speaker, scheduler, leftover, pipeline


def test_transcription_pipeline_tokens_match_jax(weights):
    port = _run("torch", weights, streams=3, frames_each=3)
    reference = _run("jax", weights, streams=3, frames_each=3)
    frames, speaker, _, leftover, pipeline = port
    assert len(frames) == 9
    assert pipeline.recovery_stats["frames_failed"] == 0
    expected = {(f.stream_id, f.frame_id): f.swag for f in reference[0]}
    for frame in frames:
        swag = frame.swag
        jax_swag = expected[(frame.stream_id, frame.frame_id)]
        np.testing.assert_array_equal(np.asarray(swag["tokens"]),
                                      np.asarray(jax_swag["tokens"]))
        assert swag["text"] == jax_swag["text"] and swag["text"]
        assert "time_PE_WhisperASR" in frame.metrics
        # the frames grow 1, 2, 3 s (window 3): mel rows 100, 200, 300
        assert tuple(swag["mel"].shape) == (100 * (frame.frame_id + 1), 80)
    assert speaker.keys() == reference[1].keys() == {"s0", "s1", "s2"}
    for sid, audio in speaker.items():
        np.testing.assert_array_equal(audio, reference[1][sid])
    # no microphone timer and no stream lease outlive the streams
    assert not [name for name in leftover
                if "tick" in name or "Lease" in name]


def test_six_streams_coalesce_into_at_most_two_batches(weights):
    frames, _, scheduler, _, _ = _run("torch", weights, streams=6,
                                      frames_each=1)
    assert len(frames) == 6
    assert scheduler.stats["items"] == 6
    assert scheduler.stats["batches"] <= 2      # coalesced
    assert scheduler.mean_batch_size() >= 3.0


def test_sync_mode_completes_frames_in_the_walk(weights):
    frames, _, scheduler, _, _ = _run(
        "torch", weights, streams=2, frames_each=1,
        **{"PE_WhisperASR.mode": "sync"})
    assert len(frames) == 2 and scheduler.stats["batches"] == 2
    assert all(isinstance(f.swag["text"], str) for f in frames)


def test_wav_elements_read_and_write_as_jax_does(tmp_path):
    from aiko_services_tpu.elements import speech as JS
    from aiko_services_tpu_torch.elements import speech as TS
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    TS.save_wav(str(tmp_path / "port.wav"), audio)
    JS.save_wav(str(tmp_path / "jax.wav"), audio)
    assert (tmp_path / "port.wav").read_bytes() == \
        (tmp_path / "jax.wav").read_bytes()
    loaded, rate = TS.load_wav(str(tmp_path / "port.wav"))
    reference, _ = JS.load_wav(str(tmp_path / "port.wav"))
    assert rate == 16000
    np.testing.assert_array_equal(loaded, reference)
    # a file source feeding a file sink, per stream
    runtime = TProcessRuntime(
        name="files", engine=TE.EventEngine(TE.VirtualClock()),
        transport_factory=lambda on_message, *_: TM.MemoryMessage(
            on_message=on_message, broker=TM.MemoryBroker())).initialize()
    pipeline = TP.Pipeline(runtime, TP.parse_pipeline_definition({
        "version": 0, "name": "p_files", "runtime": "python",
        "graph": ["(PE_AudioReadFile PE_AudioWriteFile)"],
        "parameters": {"PE_AudioWriteFile.pathname":
                       str(tmp_path / "out_{stream_id}.wav")},
        "elements": [
            {"name": "PE_AudioReadFile", "input": [],
             "output": [{"name": "audio"}, {"name": "sample_rate"}]},
            {"name": "PE_AudioWriteFile", "input": [{"name": "audio"}],
             "output": []}]}), stream_lease_time=0)
    pipeline.create_stream("s1", parameters={
        "PE_AudioReadFile.pathname": str(tmp_path / "port.wav")})
    for _ in range(2):
        assert pipeline.process_frame("s1", {}).ok
    written, _ = TS.load_wav(str(tmp_path / "out_s1.wav"))
    np.testing.assert_array_equal(written, np.concatenate([loaded] * 2))


def test_log_mel_runs_on_the_card_unless_told_cpu(monkeypatch):
    """PE_LogMel's "default" device is the card: without one the frame
    fails; it never carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime = TProcessRuntime(
        name="mel", engine=TE.EventEngine(TE.VirtualClock()),
        transport_factory=lambda on_message, *_: TM.MemoryMessage(
            on_message=on_message, broker=TM.MemoryBroker())).initialize()
    definition = {
        "version": 0, "name": "p_mel", "runtime": "python",
        "graph": ["(PE_LogMel)"],
        "elements": [{"name": "PE_LogMel", "input": [{"name": "audio"}],
                      "output": [{"name": "mel"}]}]}
    audio = np.zeros(16000, np.float32)
    pipeline = TP.Pipeline(runtime, TP.parse_pipeline_definition(definition))
    result = pipeline.process_frame("*", {"audio": audio})
    assert not result.ok and "no CUDA device" in result.diagnostic
    definition["parameters"] = {"PE_LogMel.device": "cpu"}
    pipeline = TP.Pipeline(runtime, TP.parse_pipeline_definition(definition),
                           name="p_mel_cpu")
    result = pipeline.process_frame("*", {"audio": audio})
    assert result.ok and result.outputs["mel"].shape == (100, 80)
    assert result.outputs["mel"].device.type == "cpu"
