"""Parity of the port's Llama (aiko_services_tpu_torch.models.llama) with
the JAX package's, on the same weights (JAX init → numpy → the bridge),
tiny preset, f32 on the CPU: logits within 1e-5 (the same products summed
in another order) and greedy tokens identical."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

ATOL = 1e-5
J_CONFIG = JL.LLAMA_PRESETS["tiny"]
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, J_CONFIG.vocab, shape).astype(np.int32)


def test_config_presets_mirror_jax():
    for name in ("tiny", "1b", "8b"):
        j, t = JL.LLAMA_PRESETS[name], TL.LLAMA_PRESETS[name]
        for field in dataclasses.fields(j):
            if field.name != "dtype":
                assert getattr(t, field.name) == getattr(j, field.name)
        assert t.head_dim == j.head_dim
    assert TL.LLAMA_PRESETS["1b"].head_dim == 64


def test_llama_forward_matches_jax(weights):
    params, model = weights
    tokens = _tokens((2, 11), seed=1)
    expected = jax.jit(functools.partial(JL.llama_forward,
                                         config=J_CONFIG))(
        params, tokens=jnp.asarray(tokens))
    result = TL.llama_forward(model, T_CONFIG, torch.from_numpy(tokens))
    assert result.dtype == torch.float32
    assert result.shape == (2, 11, J_CONFIG.vocab)
    np.testing.assert_allclose(result.numpy(), np.asarray(expected), rtol=0,
                               atol=ATOL)


def test_llama_hidden_prefill_then_cached_steps(weights):
    """Prefill into a longer cache, then two one-token steps at their
    offsets: the hidden states and the cache rows written."""
    params, model = weights
    tokens = _tokens((2, 9), seed=2)
    j_caches = JL.init_llama_caches(J_CONFIG, 2, 16)
    t_caches = TL.init_llama_caches(T_CONFIG, 2, 16, device="cpu")
    hidden = jax.jit(functools.partial(JL.llama_hidden, config=J_CONFIG),
                     static_argnames="position_offset")
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        expected, j_caches = hidden(
            params, tokens=jnp.asarray(tokens[:, start:stop]),
            caches=j_caches, position_offset=start)
        result, t_caches = TL.llama_hidden(
            model, T_CONFIG, torch.from_numpy(tokens[:, start:stop]),
            t_caches, position_offset=start)
        np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                                   rtol=0, atol=ATOL)
    for j_cache, t_cache in zip(j_caches, t_caches):
        np.testing.assert_allclose(t_cache["k"].numpy(),
                                   np.asarray(j_cache["k"]), atol=ATOL)
        assert t_cache["index"] == int(j_cache["index"]) == 9


@pytest.mark.parametrize("eos", [None, "first_token"])
def test_llama_greedy_decode_tokens_identical(weights, eos):
    params, model = weights
    prompt = _tokens((2, 6), seed=3)
    eos_token = None
    if eos == "first_token":
        # the second row's first emitted token: it stops at once and
        # keeps emitting EOS while the first row runs on
        eos_token = int(TL.llama_greedy_decode(
            model, T_CONFIG, torch.from_numpy(prompt), max_tokens=1)[1, 0])
    expected = jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=12,
        eos_token=eos_token))(params, prompt=jnp.asarray(prompt))
    result = TL.llama_greedy_decode(model, T_CONFIG,
                                    torch.from_numpy(prompt),
                                    max_tokens=12, eos_token=eos_token)
    assert result.dtype == torch.int32 and result.shape == (2, 12)
    np.testing.assert_array_equal(result.numpy(), np.asarray(expected))


def test_llama_init_draws_the_jax_distributions():
    model = TL.llama_init(torch.Generator().manual_seed(0), T_CONFIG,
                          device="cpu")
    assert torch.equal(model.ln_out.scale, torch.ones(T_CONFIG.dim))
    assert abs(model.embed.table.std().item() - 0.02) < 0.002
    w = model.layers[0].attn.q.w
    assert abs(w.std().item() - T_CONFIG.dim ** -0.5) < 0.1 * \
        T_CONFIG.dim ** -0.5
    assert "b" not in model.layers[0].attn.q
