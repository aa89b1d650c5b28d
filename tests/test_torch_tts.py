"""The port's TTS acoustic model and neural vocoder (models/tts.py,
models/vocoder.py) against the JAX package's, on the same weights (JAX
init → numpy → bridge.params_from_numpy), f32, at the "test" preset and
at the "base" width (dim 128, 4 heads) with 1 layer and 256 frames.

Tolerances: log-durations and mel frames within 1e-4 x the reference's
largest magnitude; durations within 1e-5 relative; frame totals within
1e-4 frames.  Length regulation is compared frame by frame except where
a frame index lies within 1e-4 of a token boundary (cumsum in another
order may put such a frame on either side: a tie).  Pad tokens get 0
duration.  Griffin-Lim (n_iter 4) waveforms are held by the relative L2
of their STFT magnitudes (within 1e-3) and of the waveforms (within
2e-3): each round re-derives the phase from the last round's FFTs, so
f32 FFT rounding grows over the rounds (measured up to 2.2e-4 and 5.1e-4
over three seeds at both sizes); the sample counts are equal.  The
vocoder's waveform within 1e-4 x its largest sample (measured ~1.4e-6);
its oscillator bank within 1e-5 at 163,840 samples."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import tts as JT
from aiko_services_tpu.models import vocoder as JV
from aiko_services_tpu.ops import audio as JA
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import tts as TT
from aiko_services_tpu_torch.models import vocoder as TV

torch.set_num_threads(1)

CONFIGS = {
    "test": JT.TTS_PRESETS["test"],
    "base_1layer": dataclasses.replace(JT.TTS_PRESETS["base"],
                                       num_layers=1, max_tokens=32,
                                       max_frames=256),
}
TIE = 1e-4
WAVE_REL_L2, STFT_REL_L2 = 2e-3, 1e-3


def port_config(config, module=TT, name="TTSConfig"):
    return getattr(module, name)(**{
        field.name: getattr(config, field.name)
        for field in dataclasses.fields(config)})


@functools.lru_cache(maxsize=None)
def pair(name):
    config = CONFIGS[name]
    params = jax.jit(functools.partial(JT.tts_init, config=config))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     port_config(config), device="cpu")
    return config, params, model


@functools.lru_cache(maxsize=None)
def vocoder_pair(name="test"):
    config = JV.VOCODER_PRESETS[name]
    params = jax.jit(functools.partial(JV.vocoder_init, config=config))(
        jax.random.PRNGKey(1))
    port = port_config(config, TV, "VocoderConfig")
    return config, params, port, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), port, device="cpu")


def tokens_for(config, lengths=(5, None, 17), seed=0):
    """[3, max_tokens] byte tokens, 0-padded; None fills the row."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lengths), config.max_tokens), np.int32)
    for i, n in enumerate(lengths):
        n = config.max_tokens if n is None else n
        tokens[i, :n] = rng.integers(1, 256, n)
    return tokens


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tied_frames(ends, max_frames):
    """Frames within TIE of any token boundary [B, T] (the boundaries of
    either run)."""
    t = np.arange(max_frames, dtype=np.float64)[None, :, None]
    return np.any(np.abs(t - np.asarray(ends, np.float64)[:, None, :])
                  < TIE, axis=-1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predict_durations_match_jax(name):
    config, params, model = pair(name)
    tokens = tokens_for(config)
    log_w, d_w = jax.jit(lambda p, t: JT.predict_durations(p, config, t))(
        params, jnp.asarray(tokens))
    log_g, d_g = TT.predict_durations(model, port_config(config),
                                      torch.from_numpy(tokens))
    log_w, d_w = np.asarray(log_w), np.asarray(d_w)
    assert np.max(np.abs(log_g.numpy() - log_w)) <= \
        1e-4 * np.max(np.abs(log_w))
    np.testing.assert_allclose(d_g.numpy(), d_w, rtol=1e-5)
    assert np.all(d_g.numpy()[tokens == 0] == 0.0)    # pad tokens
    assert np.all(d_g.numpy()[tokens > 0] > 0.0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_regulate_matches_jax(name):
    config = CONFIGS[name]
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((3, config.max_tokens, 8)).astype(
        np.float32)
    durations = rng.uniform(0.2, 3.0 * config.frames_per_token,
                            (3, config.max_tokens)).astype(np.float32)
    durations[0, 7:] = 0.0                              # padding
    durations[1, 3] = 2.0                               # whole boundaries
    frames_w, total_w = jax.jit(functools.partial(
        JT.regulate, max_frames=config.max_frames))(
        jnp.asarray(hidden), jnp.asarray(durations))
    frames_g, total_g = TT.regulate(torch.from_numpy(hidden),
                                    torch.from_numpy(durations),
                                    config.max_frames)
    assert np.max(np.abs(total_g.numpy() - np.asarray(total_w))) <= TIE
    ends = np.cumsum(durations.astype(np.float64), axis=1)
    keep = ~tied_frames(ends, config.max_frames)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(frames_g.numpy()[keep],
                                  np.asarray(frames_w)[keep])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tts_forward_matches_jax(name):
    config, params, model = pair(name)
    tokens = tokens_for(config, seed=1)
    mel_w, total_w = jax.jit(lambda p, t: JT.tts_forward(p, config, t))(
        params, jnp.asarray(tokens))
    mel_g, total_g = TT.tts_forward(model, port_config(config),
                                    torch.from_numpy(tokens))
    mel_w, total_w = np.asarray(mel_w), np.asarray(total_w)
    assert mel_g.shape == (3, config.max_frames, config.n_mels)
    assert np.max(np.abs(total_g.numpy() - total_w)) <= TIE
    _, d_w = JT.predict_durations(params, config, jnp.asarray(tokens))
    keep = ~tied_frames(np.cumsum(np.asarray(d_w, np.float64), axis=1),
                        config.max_frames)
    err = np.max(np.abs(mel_g.numpy() - mel_w)[keep])
    assert err <= 1e-4 * np.max(np.abs(mel_w)), err


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_synthesize_griffin_lim_matches_jax(name):
    config, params, model = pair(name)
    tokens = tokens_for(config, seed=2)
    audio_w, samples_w = jax.jit(lambda p, t: JT.synthesize(
        p, config, t, n_iter=4))(params, jnp.asarray(tokens))
    audio_g, samples_g = TT.synthesize(model, port_config(config),
                                       torch.from_numpy(tokens), n_iter=4)
    audio_w = np.asarray(audio_w)
    assert samples_g.dtype == torch.int32
    np.testing.assert_array_equal(samples_g.numpy(), np.asarray(samples_w))
    assert audio_g.shape == audio_w.shape == \
        (3, 160 * (config.max_frames - 1))
    assert rel_l2(audio_g.numpy(), audio_w) <= WAVE_REL_L2
    spec_w = np.abs(np.asarray(JA.stft_complex(jnp.asarray(audio_w))))
    spec_g = np.abs(np.asarray(JA.stft_complex(jnp.asarray(
        audio_g.numpy()))))
    assert rel_l2(spec_g, spec_w) <= STFT_REL_L2


def test_vocoder_forward_matches_jax():
    config, params, port, model = vocoder_pair()
    mel = (0.3 * np.random.default_rng(5).standard_normal(
        (2, 12, 80))).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, m: JV.vocoder_forward(
        p, config, m))(params, jnp.asarray(mel)))
    got = TV.vocoder_forward(model, port, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 12 * 160)
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def test_oscillator_bank_keeps_the_reference_order():
    """At 1,024 frames (163,840 samples) the angle's f32 rounding shows:
    the bank equals JAX's within 1e-5."""
    config, params, port, model = vocoder_pair()
    want = np.asarray(jax.jit(functools.partial(
        JV.oscillator_bank, 163840, config))(params["freqs"]))
    got = TV.oscillator_bank(163840, port, model.freqs).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5


def test_synthesize_with_vocoder_matches_jax():
    config, params, model = pair("test")
    vconfig, vparams, vport, vmodel = vocoder_pair()
    tokens = tokens_for(config, seed=3)
    audio_w, samples_w = jax.jit(lambda p, v, t: JT.synthesize(
        p, config, t, vocoder=v, vocoder_config=vconfig))(
        params, vparams, jnp.asarray(tokens))
    audio_g, samples_g = TT.synthesize(
        model, port_config(config), torch.from_numpy(tokens),
        vocoder=vmodel, vocoder_config=vport)
    audio_w = np.asarray(audio_w)
    np.testing.assert_array_equal(samples_g.numpy(), np.asarray(samples_w))
    assert audio_g.shape == audio_w.shape == (3, 160 * config.max_frames)
    assert np.max(np.abs(audio_g.numpy() - audio_w)) <= \
        1e-4 * np.max(np.abs(audio_w))


@pytest.mark.parametrize("which", ["tts", "vocoder"])
def test_params_from_numpy_is_strict_on_every_leaf(which):
    if which == "tts":
        config, params, _ = pair("test")
        port = port_config(config)
    else:
        config, params, port, _ = vocoder_pair()
    flat = bridge.flatten_tree(jax.tree.map(np.asarray, params))
    model = bridge.params_from_numpy(flat_tree(flat), port, device="cpu")
    names = {name.replace(".", "/") for name, _ in model.named_parameters()}
    assert names == set(flat)
    for key in sorted(flat)[::max(1, len(flat) // 6)]:
        short = dict(flat)
        short.pop(key)
        with pytest.raises(ValueError, match="missing"):
            bridge.params_from_numpy(flat_tree(short), port, device="cpu")
    extra = dict(flat, **{"blocks/9/extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        bridge.params_from_numpy(flat_tree(extra), port, device="cpu")


def flat_tree(flat):
    """{'/'-path: array} → the nested dict tree it flattens from (list
    indices stay string keys: flatten_tree gives the same paths)."""
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree
