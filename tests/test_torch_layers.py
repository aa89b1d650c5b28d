"""Parity of the port's layers (aiko_services_tpu_torch.models.layers)
with the JAX package's, in f32 and bf16.

Parameters and inputs are made from a seed with numpy and handed to both
packages as plain dicts of arrays/tensors (both layer libraries read
params["w"]).  Tolerances: f32 within 1e-5 (the same products summed in
another order); bf16 within 3e-2 on values of magnitude <~ 2 (one or two
bf16 roundings, 2^-8 relative each, at different points in the two
frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import layers as JL
from aiko_services_tpu_torch.models import layers as TL

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rng(seed):
    return np.random.default_rng(seed)


def _jax(tree, dtype):
    if isinstance(tree, dict):
        return {k: _jax(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree, getattr(jnp, dtype))


def _torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(
        getattr(torch, dtype))


def _close(result, expected, dtype):
    np.testing.assert_allclose(
        result.float().numpy(), np.asarray(expected.astype(jnp.float32)),
        rtol=0, atol=ATOL[dtype])


def _linear_params(rng, n_in, n_out, bias=True):
    params = {"w": rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)}
    if bias:
        params["b"] = rng.standard_normal(n_out) * 0.1
    return params


def _mha_params(rng, dim):
    return {"q": _linear_params(rng, dim, dim),
            "k": _linear_params(rng, dim, dim, bias=False),
            "v": _linear_params(rng, dim, dim),
            "o": _linear_params(rng, dim, dim)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False])
def test_linear(dtype, bias):
    rng = _rng(0)
    params = _linear_params(rng, 24, 40, bias)
    x = rng.standard_normal((2, 5, 24))
    result = TL.linear(_torch(params, dtype), _torch(x, dtype))
    assert result.dtype == getattr(torch, dtype)
    _close(result, JL.linear(_jax(params, dtype), _jax(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    rng = _rng(1)
    params = {"scale": 1 + 0.1 * rng.standard_normal(32),
              "bias": 0.1 * rng.standard_normal(32)}
    x = 3 + 2 * rng.standard_normal((2, 5, 32))
    _close(TL.layer_norm(_torch(params, dtype), _torch(x, dtype)),
           JL.layer_norm(_jax(params, dtype), _jax(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_symmetric_padding(dtype, stride):
    rng = _rng(2)
    params = {"w": rng.standard_normal((3, 16, 24)) / np.sqrt(48),
              "b": 0.1 * rng.standard_normal(24)}
    x = rng.standard_normal((2, 20, 16))
    result = TL.conv1d(_torch(params, dtype), _torch(x, dtype),
                       stride=stride)
    assert result.shape == (2, 20 // stride, 24)
    _close(result, JL.conv1d(_jax(params, dtype), _jax(x, dtype),
                             stride=stride), dtype)


def test_conv1d_even_kernel_needs_explicit_padding():
    params = {"w": torch.zeros((2, 4, 4)), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="odd kernel"):
        TL.conv1d(params, torch.zeros((1, 8, 4)))
    out = TL.conv1d(params, torch.zeros((1, 8, 4)), padding=[(1, 0)])
    assert out.shape == (1, 8, 4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_gelu_and_positions(dtype):
    rng = _rng(3)
    table = rng.standard_normal((50, 16))
    ids = np.array([[0, 7, 49], [3, 3, 1]])
    _close(TL.embedding({"table": _torch(table, dtype)},
                        torch.from_numpy(ids)),
           JL.embedding({"table": _jax(table, dtype)}, jnp.asarray(ids)),
           dtype)
    x = 3 * rng.standard_normal((4, 9))
    _close(TL.gelu(_torch(x, dtype)), JL.gelu(_jax(x, dtype)), dtype)
    np.testing.assert_allclose(
        TL.sinusoid_position_encoding(60, 32).numpy(),
        np.asarray(JL.sinusoid_position_encoding(60, 32)), rtol=0,
        atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_fused_self_attention(dtype):
    rng = _rng(4)
    params = _mha_params(rng, 32)
    x = rng.standard_normal((2, 6, 32))
    result, cache = TL.mha(_torch(params, dtype), _torch(x, dtype),
                           num_heads=4)
    expected, _ = JL.mha(_jax(params, dtype), _jax(x, dtype), num_heads=4)
    assert cache is None
    _close(result, expected, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_mask_branch(dtype):
    rng = _rng(5)
    params = _mha_params(rng, 32)
    x = rng.standard_normal((2, 3, 32))
    memory = rng.standard_normal((2, 5, 32))
    mask = rng.random((2, 1, 3, 5)) > 0.3
    mask[..., 0] = True
    result, _ = TL.mha(_torch(params, dtype), _torch(x, dtype),
                       kv_input=_torch(memory, dtype),
                       mask=torch.from_numpy(mask), num_heads=4)
    expected, _ = JL.mha(_jax(params, dtype), _jax(x, dtype),
                         kv_input=_jax(memory, dtype),
                         mask=jnp.asarray(mask), num_heads=4)
    _close(result, expected, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_cache_branch_prefill_then_step(dtype):
    """Prompt prefill under a causal mask, then one cached decode step:
    the outputs and the cache contents agree (the port's cache is
    updated in place, the JAX one functionally)."""
    rng = _rng(6)
    params = _mha_params(rng, 32)
    prompt = rng.standard_normal((2, 3, 32))
    step = rng.standard_normal((2, 1, 32))
    t_params, j_params = _torch(params, dtype), _jax(params, dtype)
    t_cache = TL.init_kv_cache(2, 6, 4, 8, getattr(torch, dtype))
    j_cache = JL.init_kv_cache(2, 6, 4, 8, getattr(jnp, dtype))
    causal = (np.arange(6)[None, :] <= np.arange(3)[:, None])[None, None]
    t_out, t_cache = TL.mha(t_params, _torch(prompt, dtype),
                            mask=torch.from_numpy(causal), cache=t_cache,
                            num_heads=4)
    j_out, j_cache = JL.mha(j_params, _jax(prompt, dtype),
                            mask=jnp.asarray(causal), cache=j_cache,
                            num_heads=4)
    _close(t_out, j_out, dtype)
    t_out, t_cache = TL.mha(t_params, _torch(step, dtype), cache=t_cache,
                            num_heads=4)
    j_out, j_cache = JL.mha(j_params, _jax(step, dtype), cache=j_cache,
                            num_heads=4)
    _close(t_out, j_out, dtype)
    assert t_cache["index"] == int(j_cache["index"]) == 4
    _close(t_cache["k"], j_cache["k"], dtype)
    _close(t_cache["v"], j_cache["v"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, "tensor", "position"])
def test_mha_precomputed_kv_branch(dtype, quant):
    """Cross attention over precomputed K/V: plain, "tensor"-quantized
    (scales folded into the score scale and the output) and
    "position"-quantized (dequantized first)."""
    rng = _rng(7)
    params = _mha_params(rng, 32)
    x = rng.standard_normal((3, 1, 32))
    audio = rng.standard_normal((3, 9, 32))
    t_params, j_params = _torch(params, dtype), _jax(params, dtype)
    t_kv = TL.precompute_kv(t_params, _torch(audio, dtype), 4)
    j_kv = JL.precompute_kv(j_params, _jax(audio, dtype), 4)
    if quant:
        t_kv = tuple(TL.quantize_kv(x, quant) for x in t_kv)
        j_kv = tuple(JL.quantize_kv(x, quant) for x in j_kv)
    result, _ = TL.mha(t_params, _torch(x, dtype), precomputed_kv=t_kv,
                       num_heads=4)
    expected, _ = JL.mha(j_params, _jax(x, dtype), precomputed_kv=j_kv,
                         num_heads=4)
    _close(result, expected, dtype)


@pytest.mark.parametrize("mode", ["tensor", "position"])
def test_quantize_kv_matches_jax(mode):
    tensor = _rng(8).standard_normal((2, 3, 7, 8)).astype(np.float32)
    result = TL.quantize_kv(torch.from_numpy(tensor), mode)
    expected = JL.quantize_kv(jnp.asarray(tensor), mode)
    assert result["q"].dtype == torch.int8
    np.testing.assert_array_equal(result["q"].numpy(),
                                  np.asarray(expected["q"]))
    np.testing.assert_array_equal(
        result["s"].float().numpy(),
        np.asarray(expected["s"].astype(jnp.float32)))
    np.testing.assert_allclose(
        TL.dequantize_kv(result, torch.float32).numpy(),
        np.asarray(JL.dequantize_kv(expected, jnp.float32)), rtol=0,
        atol=1e-6)
    with pytest.raises(ValueError, match="unknown quantize_kv mode"):
        TL.quantize_kv(torch.from_numpy(tensor), "row")


def test_update_kv_cache_writes_at_the_cursor_and_clamps():
    """Writes land at the cursor; a write past the end clamps into range
    as jax.lax.dynamic_update_slice does."""
    new = _rng(9).standard_normal((1, 2, 2, 4)).astype(np.float32)
    for index in (1, 5):
        t_cache = TL.init_kv_cache(1, 6, 2, 4)
        t_cache["index"] = index
        j_cache = JL.init_kv_cache(1, 6, 2, 4)
        j_cache["index"] = jnp.asarray(index, jnp.int32)
        t_new = TL.update_kv_cache(t_cache, torch.from_numpy(new),
                                   torch.from_numpy(-new))
        j_new = JL.update_kv_cache(j_cache, jnp.asarray(new),
                                   jnp.asarray(-new))
        np.testing.assert_array_equal(t_new["k"].numpy(),
                                      np.asarray(j_new["k"]))
        np.testing.assert_array_equal(t_new["v"].numpy(),
                                      np.asarray(j_new["v"]))
        assert t_new["index"] == int(j_new["index"]) == index + 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = _rng(20)
    params = {"scale": 1 + 0.1 * rng.standard_normal(32)}
    x = 3 + 2 * rng.standard_normal((2, 5, 32))
    _close(TL.rms_norm(_torch(params, dtype), _torch(x, dtype)),
           JL.rms_norm(_jax(params, dtype), _jax(x, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_logits_stay_f32(dtype):
    rng = _rng(21)
    params = _linear_params(rng, 24, 40, bias=False)
    x = rng.standard_normal((2, 3, 24))
    result = TL.linear_logits(_torch(params, dtype), _torch(x, dtype))
    expected = JL.linear_logits(_jax(params, dtype), _jax(x, dtype))
    assert result.dtype == torch.float32
    np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", ["scalar", "per_example"])
def test_rope_rotates_interleaved_pairs(dtype, offset):
    rng = _rng(22)
    x = rng.standard_normal((3, 2, 4, 16))
    j_cos, j_sin = JL.rope_frequencies(16, 64, 500000.0)
    t_cos, t_sin = TL.rope_frequencies(16, 64, 500000.0)
    np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), atol=1e-6)
    np.testing.assert_allclose(t_sin.numpy(), np.asarray(j_sin), atol=1e-6)
    positions = np.array([0, 7, 40], np.int32)
    t_offset = 5 if offset == "scalar" else torch.from_numpy(positions)
    j_offset = 5 if offset == "scalar" else jnp.asarray(positions)
    result = TL.apply_rope(_torch(x, dtype), t_cos, t_sin, t_offset)
    assert result.dtype == getattr(torch, dtype)
    _close(result, JL.apply_rope(_jax(x, dtype), j_cos, j_sin, j_offset),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_gqa_with_rope_and_cache(dtype):
    """Grouped-query attention (4 query heads over 2 KV heads, no biases)
    with the RoPE hook, prefill then one cached step."""
    rng = _rng(23)
    dim, heads, kv_heads = 32, 4, 2
    kv_dim = kv_heads * dim // heads
    params = {"q": _linear_params(rng, dim, dim, False),
              "k": _linear_params(rng, dim, kv_dim, False),
              "v": _linear_params(rng, dim, kv_dim, False),
              "o": _linear_params(rng, dim, dim, False)}
    x = rng.standard_normal((2, 6, dim))
    t_cos, t_sin = TL.rope_frequencies(8, 16)
    j_cos, j_sin = JL.rope_frequencies(8, 16)
    t_cache = TL.init_kv_cache(2, 8, kv_heads, 8, getattr(torch, dtype))
    j_cache = JL.init_kv_cache(2, 8, kv_heads, 8, getattr(jnp, dtype))
    for start, stop in ((0, 5), (5, 6)):
        t_mask = j_mask = None
        if stop - start > 1:
            t_mask = (torch.arange(8)[None] <=
                      torch.arange(start, stop)[:, None])[None, None]
            j_mask = jnp.asarray(t_mask.numpy())

        def t_rope(q, k, start=start):
            return (TL.apply_rope(q, t_cos, t_sin, start),
                    TL.apply_rope(k, t_cos, t_sin, start))

        def j_rope(q, k, start=start):
            return (JL.apply_rope(q, j_cos, j_sin, start),
                    JL.apply_rope(k, j_cos, j_sin, start))

        result, t_cache = TL.mha(
            _torch(params, dtype), _torch(x[:, start:stop], dtype),
            mask=t_mask, cache=t_cache, num_heads=heads,
            num_kv_heads=kv_heads, qk_transform=t_rope)
        expected, j_cache = JL.mha(
            _jax(params, dtype), _jax(x[:, start:stop], dtype),
            mask=j_mask, cache=j_cache, num_heads=heads,
            num_kv_heads=kv_heads, qk_transform=j_rope)
        _close(result, expected, dtype)


def _pool_case(seed):
    rng = _rng(seed)
    pool = rng.standard_normal((6, 2, 4, 8)).astype(np.float32)
    pool[0] = 0.0                                   # the null block
    tables = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
    return rng, pool, tables


def test_gather_paged_kv_matches_jax():
    _, pool, tables = _pool_case(24)
    result = TL.gather_paged_kv(torch.from_numpy(pool),
                                torch.from_numpy(tables))
    expected = JL.gather_paged_kv(jnp.asarray(pool), jnp.asarray(tables))
    assert result.shape == (2, 2, 12, 8)
    np.testing.assert_array_equal(result.numpy(), np.asarray(expected))


def test_scatter_paged_rows_drops_out_of_range_ids_as_jax_does():
    rng, pool, _ = _pool_case(25)
    # row (1, 1) goes past the pool (id 6 == N) and must drop
    dest = np.array([[3, 1], [5, 6]], np.int32)
    offsets = np.array([[0, 3], [2, 1]], np.int32)
    rows = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    t_pool = torch.from_numpy(pool.copy())
    TL.scatter_paged_rows(t_pool, torch.from_numpy(dest),
                          torch.from_numpy(offsets), torch.from_numpy(rows))
    expected = JL.scatter_paged_rows(jnp.asarray(pool), jnp.asarray(dest),
                                     jnp.asarray(offsets), jnp.asarray(rows))
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(expected))
    assert not t_pool[0].any()                      # null block untouched


def test_write_paged_blocks_drops_invalid_rows_as_jax_does():
    rng, pool, _ = _pool_case(26)
    ids = np.array([[2, 4], [6, 6]], np.int32)      # row 1: a pad row
    rows = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    t_pool = torch.from_numpy(pool.copy())
    TL.write_paged_blocks(t_pool, torch.from_numpy(ids),
                          torch.from_numpy(rows))
    expected = JL.write_paged_blocks(jnp.asarray(pool), jnp.asarray(ids),
                                     jnp.asarray(rows))
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(expected))
    assert not t_pool[0].any()
