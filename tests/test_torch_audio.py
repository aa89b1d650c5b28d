"""Parity of the port's audio frontend and wire codecs
(aiko_services_tpu_torch.ops.audio) with the JAX package's, on seeded
audio made with numpy and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import audio as JAU
from aiko_services_tpu_torch.ops import audio as TAU

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)


def _audio(batch, samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    tone = 0.4 * np.sin(2 * np.pi * 440.0 * t)[None]
    noise = 0.1 * rng.standard_normal((batch, samples))
    return (tone + noise).astype(np.float32)


def test_mel_filterbank_is_the_reference_constant():
    np.testing.assert_array_equal(TAU.mel_filterbank(80),
                                  np.asarray(JAU.mel_filterbank(80)))


@pytest.mark.parametrize("samples", [16000, 24160])
def test_log_mel_spectrogram_matches_jax(samples):
    """Reflect pad, periodic Hann, rfft, dropped last frame and the
    per-item max - 8 clamp, in f32: within 1e-4 (FFT and log10 rounding
    differ between the two libraries)."""
    audio = _audio(2, samples)
    audio[1] *= 0.01              # a quiet item: the clamp is per item
    expected = np.asarray(JAU.log_mel_spectrogram(jnp.asarray(audio)))
    result = TAU.log_mel_spectrogram(torch.from_numpy(audio))
    assert result.dtype == torch.float32
    assert result.shape == expected.shape == (2, samples // 160, 80)
    np.testing.assert_allclose(result.numpy(), expected, rtol=0, atol=1e-4)


def test_stft_power_matches_jax():
    audio = _audio(1, 4000, seed=1)
    expected = np.asarray(JAU.stft(jnp.asarray(audio)))
    result = TAU.stft(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(result, expected, rtol=1e-4,
                               atol=1e-4 * np.abs(expected).max())


def test_mulaw_codec_matches_jax():
    audio = _audio(1, 2000, seed=2)[0]
    codes = TAU.mulaw_encode(audio)
    np.testing.assert_array_equal(codes, JAU.mulaw_encode(audio))
    pcm = (audio * 32767).astype(np.int16)
    np.testing.assert_array_equal(TAU.mulaw_encode(pcm),
                                  JAU.mulaw_encode(pcm))
    every_code = np.arange(256, dtype=np.uint8)
    expected = np.asarray(JAU.mulaw_decode(jnp.asarray(every_code)))
    result = TAU.mulaw_decode(torch.from_numpy(every_code))
    assert result.dtype == torch.float32
    np.testing.assert_allclose(result.numpy(), expected, rtol=0, atol=1e-6)


def test_mel_i8_unpack_matches_jax():
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((50, 80)).astype(np.float32)
    packed = JAU.mel_i8_pack(mel)
    np.testing.assert_array_equal(TAU.mel_i8_unpack(packed),
                                  JAU.mel_i8_unpack(packed))
    with pytest.raises(ValueError, match="packed"):
        TAU.mel_i8_unpack(np.zeros((4, 3), np.int8))
