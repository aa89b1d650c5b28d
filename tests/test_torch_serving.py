"""The port's serving entry (ComputeRuntime + PE_WhisperASR's batched
program) on the CPU, held against the JAX package's greedy_decode_scored
on the same collated batches and the same weights (a JAX param tree
written with the JAX package's save_flat_npz, loaded through the
element's `weights` parameter).  The element serves in bf16, as the JAX
element does; these tests switch its model to f32 after setup, as JAX
runs here, so that tokens are equal.  Each element lives in a
one-element pipeline of a port ProcessRuntime whose ComputeRuntime runs
on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.ops import audio as JAU
from aiko_services_tpu_torch.bridge import load_flat_npz
from aiko_services_tpu_torch.compute import ComputeRuntime
from aiko_services_tpu_torch.elements.speech import collate_mel
from aiko_services_tpu_torch.event import EventEngine, VirtualClock
from aiko_services_tpu_torch.pipeline import (
    Frame, Pipeline, Stream, parse_pipeline_definition)
from aiko_services_tpu_torch.process import ProcessRuntime
from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

MAX_TOKENS = 8
BUCKETS = [100, 300]
OPEN_GATES = {"logprob_threshold": -1e9,
              "compression_ratio_threshold": 1e9}


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """The JAX element's config for these buckets (in f32) and its
    params, saved as a flat npz."""
    base = JW.WHISPER_PRESETS["test"]
    config = dataclasses.replace(base, n_audio_ctx=max(BUCKETS) // 2,
                                 n_text_ctx=MAX_TOKENS + 8)
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("weights") / "whisper_test.npz")
    save_flat_npz(params, path)
    return config, params, path


def _runtime(compute=True):
    """A port ProcessRuntime on a virtual clock with (or without) a
    ComputeRuntime on the CPU."""
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name="host", engine=EventEngine(VirtualClock()),
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    return runtime, (ComputeRuntime(runtime, "compute", device="cpu")
                     if compute else None)


def _asr(parameters, name="asr", compute=True):
    """A PE_WhisperASR named `name` in a one-element pipeline; its setup
    has not run yet."""
    runtime, compute = _runtime(compute)
    pipeline = Pipeline(runtime, parse_pipeline_definition({
        "version": 0, "name": f"p_{name}", "runtime": "python",
        "graph": [f"({name})"],
        "elements": [{"name": name, "parameters": parameters,
                      "input": [{"name": "mel"}],
                      "output": [{"name": "tokens"}, {"name": "text"}],
                      "deploy": {"local": {"class_name": "PE_WhisperASR"}}}],
    }), stream_lease_time=0)
    return pipeline.graph.node(name).element, compute


def _element(path, name="asr", **parameters):
    merged = {"preset": "test", "buckets": BUCKETS, "max_batch": 4,
              "max_tokens": MAX_TOKENS, "weights": path, **OPEN_GATES,
              **parameters}
    element, compute = _asr(merged, name)
    # the batched program reads the element's config and params at each
    # call: an f32 copy of both makes it run in f32
    element.scheduler                                  # runs the setup
    element.config = dataclasses.replace(element.config,
                                         dtype=torch.float32)
    element.params = load_flat_npz(element.params.float(), path)
    return element, compute


def _process(element, stream_id, **inputs):
    """One frame through the element's process_frame (mode "sync")."""
    frame = Frame(stream=Stream(stream_id), frame_id=0)
    return element.process_frame(frame, **inputs)


def _jax_decode(config, params, bucket, mel):
    bucket_config = dataclasses.replace(config, n_audio_ctx=bucket // 2)
    return jax.jit(lambda p, m: JW.greedy_decode_scored(
        p, bucket_config, m, max_tokens=MAX_TOKENS,
        sot_sequence=(config.sot,), suppress_timestamps=True))(
            params, mel)


def _pcm(seed, samples):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(samples) * 3000).astype(np.int16)


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
def test_batched_audio_requests_match_jax(jax_model, wire):
    """Four requests from four streams over two buckets: each answer's
    tokens equal JAX's on the same padded batch."""
    config, params, path = jax_model
    element, compute = _element(path, frontend="audio", wire=wire)
    audio = [_pcm(i, n) for i, n in enumerate((8000, 12000, 40000, 45000))]
    answers = {}
    for i, samples in enumerate(audio):
        element.submit(f"s{i}", answers.__setitem__, audio=samples)
    assert element.scheduler.drain(force=True) == 4
    program = compute.programs["whisper_asr.asr"]
    assert sorted(program.first_call_times) == BUCKETS
    stats = element.scheduler.stats      # mirrored into the registry
    assert stats["batches"] == 2 and stats["items"] == 4
    assert stats._counters["items"].value >= 4

    for bucket, members in ((100, (0, 1)), (300, (2, 3))):
        if wire == "int16":
            batch = np.zeros((4, bucket * 160), np.int16)
            for row, i in enumerate(members):
                batch[row, :audio[i].shape[0]] = audio[i]
            samples = jnp.asarray(batch).astype(jnp.float32) / 32768.0
        else:
            batch = np.full((4, bucket * 160), 128, np.uint8)
            for row, i in enumerate(members):
                batch[row, :audio[i].shape[0]] = JAU.mulaw_encode(audio[i])
            samples = JAU.mulaw_decode(jnp.asarray(batch))
        mel = JAU.log_mel_spectrogram(samples)
        tokens, lengths, logprob = _jax_decode(config, params, bucket, mel)
        for row, i in enumerate(members):
            answer = answers[f"s{i}"]
            np.testing.assert_array_equal(
                answer["tokens"], np.asarray(tokens)[row, :lengths[row]])
            assert answer["avg_logprob"] == pytest.approx(
                float(logprob[row]), abs=1e-5)
            assert answer["text"] == " ".join(
                str(t) for t in answer["tokens"])


def test_mel_frontend_takes_float_and_packed_i8mel_rows(jax_model):
    config, params, path = jax_model
    element, _ = _element(path, frontend="mel", mode="sync")
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((80, 80)).astype(np.float32)
    packed = JAU.mel_i8_pack(mel)
    float_answer = _process(element, "a", mel=mel).outputs
    packed_answer = _process(element, "b", mel=packed).outputs
    # a CPU tensor (PE_LogMel's output on the host) is a host row too
    tensor_answer = _process(element, "c", mel=torch.from_numpy(mel)).outputs
    np.testing.assert_array_equal(tensor_answer["tokens"],
                                  float_answer["tokens"])
    for payload, answer in ((mel, float_answer),
                            (JAU.mel_i8_unpack(packed), packed_answer)):
        batch = np.zeros((1, 100, 80), np.float32)   # sync: no padding
        batch[0, :80] = payload
        tokens, lengths, _ = _jax_decode(
            config, params, 100, jnp.asarray(batch, jnp.bfloat16))
        np.testing.assert_array_equal(
            answer["tokens"], np.asarray(tokens)[0, :lengths[0]])


def test_hallucination_gates_suppress_every_output(jax_model):
    _, _, path = jax_model
    audio = _pcm(0, 9000)
    element, _ = _element(path, frontend="audio", mode="sync",
                          logprob_threshold=0.0)
    answer = _process(element, "s", audio=audio).outputs
    assert answer["suppressed"].startswith("avg_logprob")
    assert answer["text"] == "" and answer["tokens"].size == 0
    element, _ = _element(path, frontend="audio", mode="sync",
                          compression_ratio_threshold=0.0)
    answer = _process(element, "s", audio=audio).outputs
    assert answer["suppressed"].startswith("compression_ratio")
    assert answer["text"] == "" and answer["tokens"].size == 0


def test_flash_buckets_round_long_audio_to_kernel_geometry(jax_model):
    _, _, path = jax_model
    ladder = [500, 1000, 3000]
    for parameters, expected in (
            ({}, [500, 1000, 3072]),
            ({"flash_buckets": "false"}, ladder),
            ({"weights": path}, ladder),          # checkpoints: off
            ({"weights": path, "flash_buckets": True}, [500, 1000, 3072])):
        element, _ = _asr({
            "preset": "test", "buckets": ladder, "max_tokens": MAX_TOKENS,
            **parameters})
        assert element.scheduler.buckets.buckets == expected
        assert element.buckets == expected
        assert element.config.dtype is torch.bfloat16    # as in JAX


def test_setup_rejects_bad_parameters():
    with pytest.raises(ValueError, match="kv_quant"):
        _asr({"preset": "test", "kv_quant": "bogus"})[0].scheduler
    with pytest.raises(RuntimeError, match="no ComputeRuntime"):
        _asr({"preset": "test"}, compute=False)[0].scheduler
    # a tokenizer directory that holds no vocabulary fails to load
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        _asr({"preset": "test", "tokenizer": "vocab.json"})[0].scheduler
    # JAX options that wait for later ROADMAP items say which
    for option, item in (({"pp_stages": 2}, "item 10"),
                         ({"pipelined": True}, "item 2")):
        with pytest.raises(NotImplementedError, match=item):
            _asr({"preset": "test", **option})[0].scheduler
    # a sync element never pipelines (resolve_pipelined)
    assert _asr({"preset": "test", "pipelined": True,
                 "mode": "sync"})[0].scheduler is not None


def test_compute_runtime_direct_programs_and_errors():
    runtime, compute = _runtime()
    assert runtime.service_by_name("compute") is compute
    assert compute.device == torch.device("cpu")
    assert compute.device_kind == "cpu" and compute.memory_free is None
    compute.register_program("double", lambda x: 2 * x)
    assert compute.run("double", 21) == 42
    assert "direct" in compute.programs["double"].first_call_times
    with pytest.raises(ValueError, match="not batched"):
        compute.submit("double", "s", 1, 10, lambda *_: None)


def test_batch_failure_reaches_every_callback(jax_model):
    """A payload that fails its batch (here: one collate cannot encode)
    fails every request of that batch through its callback."""
    _, _, path = jax_model
    element, _ = _element(path, frontend="audio")
    answers = {}
    element.submit("good", answers.__setitem__, audio=_pcm(0, 9000))
    element.submit("bad", answers.__setitem__,
                   audio=np.array(["x"] * 9000))
    element.scheduler.drain(force=True)
    assert set(answers) == {"good", "bad"}
    assert all(isinstance(r, TypeError) for r in answers.values())
    # in a pipeline walk (mode "sync") the failure fails the frame
    element.mode = "sync"
    result = _process(element, "bad", audio=np.array(["x"] * 9000))
    assert not result.ok and "TypeError" in result.diagnostic


def test_host_mel_rows_collate_into_one_padded_batch():
    """numpy rows, CPU tensors and packed i8mel rows collate into the
    same zero-padded bf16 batch as the JAX element's collate."""
    rng = np.random.default_rng(3)
    mels = [rng.standard_normal((t, 80)).astype(np.float32)
            for t in (30, 100, 120)]
    payloads = [mels[0], torch.from_numpy(mels[1]),
                JAU.mel_i8_pack(mels[2])]
    batch = collate_mel(payloads, 4, 100, 80, torch.device("cpu"))
    expected = np.zeros((4, 100, 80), np.float32)
    expected[0, :30] = mels[0]
    expected[1] = mels[1]
    expected[2] = JAU.mel_i8_unpack(JAU.mel_i8_pack(mels[2]))[:100]
    assert batch.dtype is torch.bfloat16 and batch.shape == (4, 100, 80)
    np.testing.assert_array_equal(
        batch.float().numpy(),
        np.asarray(jnp.asarray(expected, jnp.bfloat16).astype(jnp.float32)))


def test_batched_frames_defer_and_carry_their_deadline(jax_model):
    """In a pipeline walk a batched element parks the frame (DEFERRED)
    and submits it with an absolute deadline on the engine clock."""
    _, _, path = jax_model
    element, compute = _element(path, frontend="audio", deadline_ms=250)
    engine = element.runtime.event
    engine.clock.advance(2.0)
    result = _process(element, "s", audio=_pcm(0, 9000))
    assert result.ok and result.outputs is not None
    assert repr(result.outputs) == "DEFERRED"
    scheduler = compute.programs["whisper_asr.asr"].scheduler
    (queued,) = [item for bucket in scheduler._queues.values()
                 for item in bucket.items]
    assert queued.deadline == pytest.approx(2.25)
    assert scheduler.clock() == 2.0          # the engine's clock
