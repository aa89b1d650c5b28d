"""The port's serving entry (ComputeRuntime + PE_WhisperASR's batched
program) on the CPU, held against the JAX package's greedy_decode_scored
on the same collated batches and the same weights (a JAX param tree
written with the JAX package's save_flat_npz, loaded through the
element's `weights` parameter).  The element serves in bf16, as the JAX
element does; these tests switch its model to f32 after setup, as JAX
runs here, so that tokens are equal."""

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
from aiko_services_tpu_torch.elements.speech import PE_WhisperASR

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


def _element(path, name="asr", **parameters):
    compute = ComputeRuntime("compute", device="cpu")
    merged = {"preset": "test", "buckets": BUCKETS, "max_batch": 4,
              "max_tokens": MAX_TOKENS, "weights": path, **OPEN_GATES,
              **parameters}
    element = PE_WhisperASR(name, merged, {"compute": compute})
    # the batched program reads the element's config and params at each
    # call: an f32 copy of both makes it run in f32
    element.scheduler                                  # runs the setup
    element.config = dataclasses.replace(element.config,
                                         dtype=torch.float32)
    element.params = load_flat_npz(element.params.float(), path)
    return element, compute


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
    float_answer = element.process_frame("a", mel=mel)
    packed_answer = element.process_frame("b", mel=packed)
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
    element, _ = _element(path, frontend="audio", logprob_threshold=0.0)
    answer = element.process_frame("s", audio=audio)
    assert answer["suppressed"].startswith("avg_logprob")
    assert answer["text"] == "" and answer["tokens"].size == 0
    element, _ = _element(path, frontend="audio",
                          compression_ratio_threshold=0.0)
    answer = element.process_frame("s", audio=audio)
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
        element = PE_WhisperASR("asr", {
            "preset": "test", "buckets": ladder, "max_tokens": MAX_TOKENS,
            **parameters}, {"compute": ComputeRuntime(device="cpu")})
        assert element.scheduler.buckets.buckets == expected
        assert element.buckets == expected
        assert element.config.dtype is torch.bfloat16    # as in JAX


def test_setup_rejects_bad_parameters():
    with pytest.raises(ValueError, match="kv_quant"):
        PE_WhisperASR("asr", {"preset": "test", "kv_quant": "bogus"},
                      {"compute": ComputeRuntime(device="cpu")}).scheduler
    with pytest.raises(RuntimeError, match="no ComputeRuntime"):
        PE_WhisperASR("asr", {"preset": "test"}, {}).scheduler


def test_compute_runtime_direct_programs_and_errors():
    compute = ComputeRuntime("compute", device="cpu")
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
    with pytest.raises(TypeError):
        element.process_frame("bad", audio=np.array(["x"] * 9000))
