"""The port's inverse audio path (ops/audio.py: stft_complex, istft,
mel_inverse_filterbank, mel_to_linear, griffin_lim and
mel_cepstral_distortion) against the JAX package's, f32, on inputs made
from a seed with numpy.

Tolerances: the complex spectrum and the inverse filterbank within 1e-5
of the reference's largest magnitude (f32 FFTs of 400 points sum in
other orders); istft and Griffin-Lim waveforms within 1e-5 x the
reference's largest sample (the overlap-add sums two or three frames per
sample, in another order than the reference's scatter); mel_to_linear
within 1e-5 relative; the MCD (host numpy f64 on both sides) within
1e-9 dB."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import audio as JA
from aiko_services_tpu_torch.ops import audio as TA

torch.set_num_threads(1)

TOL = 1e-5


def close(got, want, tol=TOL):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


def audio(batch=2, samples=3200, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    tone = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 2000, (batch, 1)) * t)
    return (tone + 0.05 * rng.standard_normal((batch, samples))
            ).astype(np.float32)


def magnitudes(batch=2, frames=20, seed=1):
    return np.abs(np.random.default_rng(seed).standard_normal(
        (batch, frames, 201))).astype(np.float32)


@pytest.mark.parametrize("samples", [3200, 4001])
def test_stft_complex_matches_jax(samples):
    x = audio(samples=samples)
    want = np.asarray(jax.jit(JA.stft_complex)(jnp.asarray(x)))
    got = TA.stft_complex(torch.from_numpy(x)).numpy()
    assert got.dtype == np.complex64
    close(got, want)


@pytest.mark.parametrize("frames", [1, 2, 21])
def test_istft_matches_jax(frames):
    spectrum = np.asarray(jax.jit(JA.stft_complex)(
        jnp.asarray(audio(samples=160 * (frames - 1) + 1 if frames > 1
                          else 100))))
    spectrum = spectrum[:, :frames].copy()
    want = np.asarray(jax.jit(JA.istft)(jnp.asarray(spectrum)))
    got = TA.istft(torch.from_numpy(spectrum)).numpy()
    assert got.shape == (2, 160 * (frames - 1))
    if frames > 1:
        close(got, want)


def test_istft_inverts_stft_complex():
    x = audio(samples=3200)
    got = TA.istft(TA.stft_complex(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, x, atol=1e-5)


@pytest.mark.parametrize("num_mels", [80, 40])
def test_mel_inverse_filterbank_matches_jax(num_mels):
    want = JA.mel_inverse_filterbank(num_mels)
    got = TA.mel_inverse_filterbank(num_mels)
    assert got.shape == (num_mels, 201) and got.dtype == np.float32
    close(got, want)


def test_mel_to_linear_matches_jax():
    log_mel = np.random.default_rng(2).uniform(
        -1.0, 1.5, (2, 12, 80)).astype(np.float32)
    want = np.asarray(jax.jit(JA.mel_to_linear)(jnp.asarray(log_mel)))
    got = TA.mel_to_linear(torch.from_numpy(log_mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.max(want)))


@pytest.mark.parametrize("n_iter", [0, 1, 4])
def test_griffin_lim_matches_jax(n_iter):
    mag = magnitudes()
    want = np.asarray(jax.jit(functools.partial(
        JA.griffin_lim, n_iter=n_iter))(jnp.asarray(mag)))
    got = TA.griffin_lim(torch.from_numpy(mag), n_iter=n_iter).numpy()
    close(got, want)


def test_griffin_lim_zero_magnitude_is_silence():
    """|s| = 0 everywhere: the phase's 1e-8 clamp gives 0, not NaN."""
    got = TA.griffin_lim(torch.zeros(1, 8, 201), n_iter=2).numpy()
    assert np.all(got == 0.0)


@pytest.mark.parametrize("frames_b", [30, 18, 0])
def test_mel_cepstral_distortion_matches_jax(frames_b):
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (30, 80)).astype(np.float32)
    b = rng.uniform(-1, 1, (frames_b, 80)).astype(np.float32)
    want = JA.mel_cepstral_distortion(a, b)
    got = TA.mel_cepstral_distortion(a, b)
    if frames_b == 0:
        assert got == want == float("inf")
    else:
        assert abs(got - want) <= 1e-9 and got > 0
        assert TA.mel_cepstral_distortion(a, a) == 0.0
