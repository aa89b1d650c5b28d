"""Parity of the port's Whisper (aiko_services_tpu_torch.models.whisper)
with the JAX package's on the same weights: JAX params from
whisper_init(PRNGKey(0)) cross through bridge.params_from_numpy, the mel
input is made from a seed with numpy, and both run in f32 on the CPU.
Greedy tokens and lengths must be identical; avg_logprob within 1e-5.
The JAX side runs under jax.jit, as the JAX package serves it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import whisper as TW
from aiko_services_tpu_torch.ops import attention as TA

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)


def _pair(config_changes=None, preset="test"):
    j_config = JW.WHISPER_PRESETS[preset]
    if config_changes:
        j_config = dataclasses.replace(j_config, **config_changes)
    t_config = TW.WhisperConfig(**{
        field.name: getattr(j_config, field.name)
        for field in dataclasses.fields(TW.WhisperConfig)})
    params = jax.jit(functools.partial(JW.whisper_init, config=j_config))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     t_config, device="cpu")
    return j_config, params, t_config, model


def _jax_decode(config, kwargs):
    return jax.jit(lambda params, mel: JW.greedy_decode_scored(
        params, config, mel, **kwargs))


@pytest.fixture(scope="module")
def test_preset():
    return _pair()


def _mel(batch, frames, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, 80)).astype(np.float32)


def test_config_maps_the_jax_dtype():
    config = TW.WhisperConfig(dtype=jnp.bfloat16)
    assert config.dtype == torch.bfloat16
    assert TW.WHISPER_PRESETS["small"].dim == 768


def test_encode_matches_jax(test_preset):
    j_config, params, t_config, model = test_preset
    mel = _mel(2, 200)
    expected = np.asarray(jax.jit(functools.partial(
        JW.encode, config=j_config))(params, mel=jnp.asarray(mel)))
    with torch.inference_mode():
        result = TW.encode(model, t_config, torch.from_numpy(mel))
    assert result.shape == expected.shape == (2, 100, 64)
    np.testing.assert_allclose(result.numpy(), expected, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, "tensor"])
@pytest.mark.parametrize("suppress_timestamps", [False, True])
def test_greedy_decode_scored_matches_jax(test_preset, suppress_timestamps,
                                          kv_quant):
    j_config, params, t_config, model = test_preset
    mel = _mel(3, 120, seed=1)
    kwargs = dict(max_tokens=10, suppress_timestamps=suppress_timestamps,
                  kv_quant=kv_quant)
    j_tokens, j_lengths, j_logprob = _jax_decode(j_config, kwargs)(
        params, jnp.asarray(mel))
    t_tokens, t_lengths, t_logprob = TW.greedy_decode_scored(
        model, t_config, torch.from_numpy(mel), **kwargs)
    assert t_tokens.dtype == t_lengths.dtype == torch.int32
    np.testing.assert_array_equal(t_tokens.numpy(), np.asarray(j_tokens))
    np.testing.assert_array_equal(t_lengths.numpy(), np.asarray(j_lengths))
    np.testing.assert_allclose(t_logprob.numpy(), np.asarray(j_logprob),
                               rtol=0, atol=1e-5)


def test_forward_logits_match_jax(test_preset):
    j_config, params, t_config, model = test_preset
    mel = _mel(2, 60, seed=2)
    tokens = np.array([[254, 3, 9, 200], [254, 77, 1, 255]])
    expected = np.asarray(jax.jit(functools.partial(
        JW.forward, config=j_config))(params, mel=jnp.asarray(mel),
                                      tokens=jnp.asarray(tokens)))
    with torch.inference_mode():
        result = model(torch.from_numpy(mel), torch.from_numpy(tokens))
    np.testing.assert_allclose(result.numpy(), expected, rtol=0, atol=1e-4)


def test_greedy_decode_through_the_flash_branch():
    """A config whose encoder takes the flash branch (context 1024, head
    dim 64): the port's dispatcher counts a flash call per encoder layer
    and its tokens equal JAX's, whose CPU backend runs plain attention —
    the port's kernel path held against the reference's math."""
    j_config, params, t_config, model = _pair(dict(
        dim=128, num_heads=2, enc_layers=1, dec_layers=1,
        n_audio_ctx=1024, n_text_ctx=16))
    mel = _mel(2, 2 * 1024, seed=3)
    before = TA.dispatch_stats["flash"]
    t_tokens, t_lengths, t_logprob = TW.greedy_decode_scored(
        model, t_config, torch.from_numpy(mel), max_tokens=6)
    assert TA.dispatch_stats["flash"] == before + 1
    j_tokens, j_lengths, j_logprob = _jax_decode(
        j_config, dict(max_tokens=6))(params, jnp.asarray(mel))
    np.testing.assert_array_equal(t_tokens.numpy(), np.asarray(j_tokens))
    np.testing.assert_array_equal(t_lengths.numpy(), np.asarray(j_lengths))
    np.testing.assert_allclose(t_logprob.numpy(), np.asarray(j_logprob),
                               rtol=0, atol=1e-5)


def test_decode_rejects_out_of_range_prompts(test_preset):
    _, _, t_config, model = test_preset
    audio = torch.zeros((1, 4, t_config.dim))
    with pytest.raises(ValueError, match="out of range"):
        TW.greedy_decode_from_audio(model, t_config, audio,
                                    sot_sequence=(t_config.n_vocab,))
    with pytest.raises(ValueError, match="n_text_ctx"):
        TW.greedy_decode_from_audio(model, t_config, audio,
                                    max_tokens=t_config.n_text_ctx)


def test_whisper_init_is_seeded_and_shaped():
    config = TW.WHISPER_PRESETS["test"]
    first = TW.whisper_init(torch.Generator().manual_seed(5), config,
                            device="cpu")
    second = TW.whisper_init(torch.Generator().manual_seed(5), config,
                             device="cpu")
    for (name, a), (_, b) in zip(first.named_parameters(),
                                 second.named_parameters()):
        assert torch.equal(a, b), name
    assert first.enc_blocks[1].attn.q.w.shape == (64, 64)
    assert "b" not in first.enc_blocks[0].attn.k
    assert torch.all(first.ln_enc.scale == 1)


def test_timestamp_helpers_match_jax():
    config = TW.WHISPER_PRESETS["small"]
    for kwargs in ({}, {"language": "de"}, {"language": "fr",
                                            "task": "translate",
                                            "timestamps": True}):
        assert TW.sot_sequence_for(config, **kwargs) == \
            JW.sot_sequence_for(JW.WHISPER_PRESETS["small"], **kwargs)
    tokens = [50364, 11, 12, 50400, 50410, 13, 50420, 14]
    assert TW.parse_timestamp_segments(tokens, 8) == \
        JW.parse_timestamp_segments(tokens, 8)
