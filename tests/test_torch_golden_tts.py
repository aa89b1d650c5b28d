"""The golden speech-out gates on the port, on weights the port trained.

The module fixture trains the test-preset TTS acoustic model on the tone
language with the port on the CPU (tests/torch_golden.py, the recipe of
tests/test_tts.py: teacher-forced mel loss + supervised log-durations)
and saves it with the port's bridge.save_flat_npz.  As in
tests/test_tts.py: the learned durations match the tone geometry (per
byte within 1.5 frames, total within 10%), PE_NeuralTTS speaks each
word's tone, and the vocoder leg runs end to end; the TTS → ASR text
round trip and the held-out MCD are marked slow, as JAX marks them, and
the vocoder against Griffin-Lim runs only under AIKO_HEAVY_TESTS, as in
JAX (its 9,000 steps take hours on the CPU; on the card it runs through
aiko_services_tpu_torch/tools/train_vocoder_scale.py).  Parity with JAX:
the JAX PE_NeuralTTS on the port-trained npz predicts the same
durations (within 1e-4 frames) and the same mel (within 1e-4 absolute),
in f32."""

import os

import numpy as np
import pytest
import torch

import torch_golden as golden
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.bridge import save_flat_npz
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
from aiko_services_tpu_torch.models.tts import (
    TTS_PRESETS, predict_durations, synthesize, tts_forward, tts_init)
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

CONFIG = TTS_PRESETS["test"]
MAX_TOKENS = golden.TTS_MAX_TOKENS
# JAX's PE_NeuralTTS on the same npz, f32: durations and mel
DURATION_TOL, MEL_TOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def tts_params():
    return golden.train_tts(device="cpu")


@pytest.fixture(scope="module")
def tts_weights(tts_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("tts") / "tts.npz"
    save_flat_npz(tts_params, str(path))
    return str(path)


def token_batch(words):
    ids = ByteTokenizer().encode(" ".join(words))[:MAX_TOKENS]
    return ids, torch.tensor([ids + [0] * (MAX_TOKENS - len(ids))],
                             dtype=torch.int64)


def test_learned_durations_match_ground_truth(tts_params):
    """The trained duration head recovers the tone-language timing: per
    byte within 1.5 frames, total utterance length within 10%."""
    words = ["charlie", "alpha"]
    ids, tokens = token_batch(words)
    with torch.no_grad():
        _, durations = predict_durations(tts_params, CONFIG, tokens)
    durations = durations[0, :len(ids)].numpy()
    truth = np.asarray(golden.byte_durations(words), np.float32)
    assert np.abs(durations - truth).max() < 1.5, \
        f"per-byte durations off: {durations} vs {truth}"
    assert abs(durations.sum() - truth.sum()) < 0.1 * truth.sum()


def tts_pipeline(package, weights):
    """A (PE_NeuralTTS) pipeline of the package on a virtual clock, as
    tests/test_tts.py defines it, with one stream open."""
    if package == "jax":
        from aiko_services_tpu import event
        from aiko_services_tpu import pipeline as module
        from aiko_services_tpu.compute import ComputeRuntime as compute_class
        from aiko_services_tpu.process import ProcessRuntime as runtime_class
        from aiko_services_tpu.transport import memory
    else:
        event, memory, module = TE, TM, TP
        runtime_class, compute_class = TProcessRuntime, TComputeRuntime
    broker = memory.MemoryBroker()
    runtime = runtime_class(
        name=f"tts_{package}", engine=event.EventEngine(event.VirtualClock()),
        transport_factory=lambda on_message, *_: memory.MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    compute_class(runtime, "compute",
                  **({"device": "cpu"} if package == "torch" else {}))
    definition = module.parse_pipeline_definition(
        golden.tts_definition(weights))
    pipeline = module.Pipeline(runtime, definition, stream_lease_time=0)
    pipeline.create_stream("s1", lease_time=0)
    element = next(node.element for node in pipeline.graph.nodes()
                   if node.name == "PE_NeuralTTS")
    return pipeline, element


def test_neural_tts_element_speaks_the_right_tone(tts_weights):
    """Text through the port's PE_NeuralTTS (Griffin-Lim) → audio whose
    dominant frequency is the word's tone and whose length tracks the
    learned duration."""
    pipeline, _ = tts_pipeline("torch", tts_weights)
    for word, freq in (("alpha", 330.0), ("charlie", 770.0)):
        ok, swag = pipeline.process_frame("s1", {"text": word})
        assert ok
        audio = np.asarray(swag["audio"])
        assert swag["sample_rate"] == golden.SAMPLE_RATE
        # learned duration: one word ≈ 25 frames ≈ 4000 samples
        assert 2400 <= audio.size <= 8000, f"{word}: {audio.size} samples"
        measured = golden.dominant_frequency(audio)
        assert abs(measured - freq) < 60.0, \
            f"{word}: dominant {measured:.0f} Hz, expected {freq:.0f}"


def test_jax_element_on_the_port_weights_predicts_the_same(tts_weights):
    """JAX's PE_NeuralTTS reads the port-trained npz: its params give
    the port's durations and mel for each of the corpus texts, in f32."""
    import jax.numpy as jnp

    from aiko_services_tpu.models import tts as JT

    _, port = tts_pipeline("torch", tts_weights)
    _, reference = tts_pipeline("jax", tts_weights)
    reference._setup()
    for words in (["charlie", "alpha"], ["bravo"], ["alpha", "bravo"]):
        ids, tokens = token_batch(words)
        with torch.no_grad():
            _, durations = predict_durations(port.params, CONFIG, tokens)
            mel, total = tts_forward(port.params, CONFIG, tokens)
        jax_tokens = jnp.asarray(tokens.numpy(), jnp.int32)
        _, jax_durations = JT.predict_durations(reference.params,
                                                JT.TTS_PRESETS["test"],
                                                jax_tokens)
        jax_mel, jax_total = JT.tts_forward(reference.params,
                                            JT.TTS_PRESETS["test"],
                                            jax_tokens)
        np.testing.assert_allclose(durations.numpy(),
                                   np.asarray(jax_durations),
                                   rtol=0, atol=DURATION_TOL)
        np.testing.assert_allclose(total.numpy(), np.asarray(jax_total),
                                   rtol=0, atol=len(ids) * DURATION_TOL)
        frames = int(np.ceil(float(total[0]))) - 1
        np.testing.assert_allclose(mel.numpy()[:, :frames],
                                   np.asarray(jax_mel)[:, :frames],
                                   rtol=0, atol=MEL_TOL)


def test_synthesize_with_vocoder_end_to_end(tts_params):
    """The text → speech path through the neural vocoder leg: the same
    acoustic model, the vocoder instead of Griffin-Lim, gives finite
    audio of the same duration."""
    from aiko_services_tpu_torch.models.vocoder import (VOCODER_PRESETS,
                                                        vocoder_init)

    config = VOCODER_PRESETS["test"]
    vocoder = vocoder_init(torch.Generator().manual_seed(1), config,
                           device="cpu")
    _, tokens = token_batch(["alpha"])
    audio_gl, samples_gl = synthesize(tts_params, CONFIG, tokens, n_iter=8)
    audio_v, samples_v = synthesize(tts_params, CONFIG, tokens,
                                    vocoder=vocoder, vocoder_config=config)
    assert int(samples_v[0]) == int(samples_gl[0])
    # the vocoder emits frames*hop samples; griffin-lim's istft emits
    # (frames-1)*hop: both cover every voiced sample, callers trim
    assert audio_v.shape[1] >= int(samples_v[0])
    assert audio_gl.shape[1] >= int(samples_gl[0])
    assert bool(torch.isfinite(audio_v).all())


@pytest.mark.slow   # >10 s call: tier-1 wall budget, as JAX marks it
def test_tts_to_asr_roundtrip_text_equality(tts_params):
    """TTS speaks "charlie alpha"; the port-trained golden ASR
    transcribes the synthesized waveform back to the same text."""
    from aiko_services_tpu_torch.models.whisper import greedy_decode_scored

    words = ["charlie", "alpha"]
    _, tokens = token_batch(words)
    audio, samples = synthesize(tts_params, CONFIG, tokens, n_iter=48)
    waveform = audio[0, :int(samples[0])].numpy()

    asr_params = golden.train_whisper(device="cpu")
    mel = golden.log_mel(waveform, "cpu")
    buffer = np.zeros((golden.BUCKET, 80), np.float32)
    frames = min(mel.shape[0], golden.BUCKET)
    buffer[:frames] = mel[:frames]
    out_tokens, lengths, _ = greedy_decode_scored(
        asr_params, golden.whisper_config(), torch.from_numpy(buffer[None]),
        max_tokens=golden.MAX_TOKENS)
    text = ByteTokenizer().decode(
        [int(t) for t in out_tokens[0][:int(lengths[0])]])
    assert text.strip() == "charlie alpha", f"round trip got {text!r}"


@pytest.mark.slow   # >10 s call: tier-1 wall budget, as JAX marks it
def test_tts_held_out_mcd():
    """Train without ["alpha", "charlie"], synthesize it with predicted
    durations, and measure mel-cepstral distortion against the
    ground-truth utterance: the trained model beats an untrained one by
    a wide margin and lands under JAX's absolute bound."""
    from aiko_services_tpu_torch.ops.audio import mel_cepstral_distortion

    held_out = ["alpha", "charlie"]
    params = golden.train_tts(exclude=held_out, device="cpu")
    _, tokens = token_batch(held_out)
    truth = golden.log_mel(golden.utterance(held_out), "cpu")

    def mcd_for(p):
        with torch.no_grad():
            mel, total = tts_forward(p, CONFIG, tokens)
        frames = int(np.clip(float(total[0]), 1, CONFIG.max_frames))
        return mel_cepstral_distortion(mel[0].numpy()[:frames], truth)

    mcd_trained = mcd_for(params)
    mcd_random = mcd_for(tts_init(torch.Generator().manual_seed(99),
                                  CONFIG, device="cpu"))
    print(f"held-out MCD: trained {mcd_trained:.2f} dB vs random "
          f"{mcd_random:.2f} dB")
    assert mcd_trained < 0.35 * mcd_random, \
        f"trained {mcd_trained:.2f} not well under random {mcd_random:.2f}"
    assert mcd_trained < 90.0, f"absolute MCD bound: {mcd_trained:.2f}"


@pytest.mark.skipif(not os.environ.get("AIKO_HEAVY_TESTS"),
                    reason="vocoder training: 9,000 steps, hours on the "
                           "CPU; run with AIKO_HEAVY_TESTS=1, or on the "
                           "card through aiko_services_tpu_torch.tools."
                           "train_vocoder_scale --runs wide")
def test_vocoder_vs_griffin_lim_held_out_mcd():
    """Copy synthesis on held-out text (ground-truth mel in, waveform
    re-analysis MCD out): the trained vocoder beats Griffin-Lim at 16
    rounds, stays within 0.5 dB of 32 rounds and under 25 dB, JAX's
    gate."""
    held_out = ["alpha", "charlie"]
    vocoder, config = golden.train_vocoder(exclude=held_out, device="cpu")
    mcd_vocoder = golden.held_out_mcd(vocoder, config, held_out, "cpu")
    mcd_gl = {n: golden.griffin_lim_mcd(n, held_out, "cpu")
              for n in (16, 32)}
    print(f"held-out copy-synthesis MCD: vocoder {mcd_vocoder:.2f} dB, "
          f"GL-16 {mcd_gl[16]:.2f} dB, GL-32 {mcd_gl[32]:.2f} dB")
    assert mcd_vocoder < mcd_gl[16]
    assert mcd_vocoder < mcd_gl[32] + 0.5
    assert mcd_vocoder < 25.0
