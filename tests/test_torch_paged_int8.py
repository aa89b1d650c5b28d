"""The port's int8 serving KV form and the paged kernel's three numerics
against the JAX package's.

quantize_kv_cache / dequantize_kv_cache and the paged pool primitives in
their int8 dict form must give the JAX functions' exact int8 codes and
f32 scales, and drop out-of-range rows in both planes.  The paged
kernel's plain version (what the wrapper runs for CPU tensors) is held
against JAX's Pallas kernel in interpret mode, in f32, in all three
variants: native pools, int8 pools with fold_scales=True (decode) and
with fold_scales=False (the chunked-prefill extend), at W = 1 and W =
16 (a chunk under a causal triangle), G in {1, 2}, blocks of 8 and 16,
extents 0 / on a block edge / inside a block, and a fully masked row.
The CUDA kernel is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import layers as JL
from aiko_services_tpu.ops import paged_attention as JPA
from aiko_services_tpu_torch.models import layers as TL
from aiko_services_tpu_torch.ops import paged_attention as TPA

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

# f32 outputs of the same products summed in another order (blockwise in
# the JAX kernel, one contraction per part here); int8 values up to 127
# make the unscaled dots ~100x larger than native ones, whose outputs
# agree to ~1e-6
F32_ATOL = 2e-5

SLOTS, NUM_KV, HEAD_DIM = 3, 2, 16


def _int8_pool(rng, shape):
    """{"q", "s"} numpy planes: int8 values in [-127, 127], f32 scales
    (the null block, 0, all zeros)."""
    values = rng.integers(-127, 128, shape).astype(np.int8)
    scales = rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
    values[0] = 0
    scales[0] = 0.0
    return {"q": values, "s": scales}


def _case(groups, width, block, int8, seed):
    """Operands as numpy arrays; pools are dicts of planes when int8.
    Slot 0 sees nothing in the pool and its query 0 no side entry (a
    fully masked row); slot 1 ends on a block boundary, slot 2 inside
    its second block.  W > 1 is a chunk: side entry p visible to query w
    iff p <= w."""
    rng = np.random.default_rng(seed)
    nb = 3
    num_blocks = SLOTS * nb + 2
    entry = np.array([0, 2 * block, block + 3], np.int32)
    pool_shape = (num_blocks, NUM_KV, block, HEAD_DIM)
    if int8:
        k_pool, v_pool = _int8_pool(rng, pool_shape), \
            _int8_pool(rng, pool_shape)
    else:
        k_pool, v_pool = (rng.standard_normal(pool_shape).astype(np.float32)
                          for _ in range(2))
        k_pool[0] = v_pool[0] = 0.0
    ids = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((SLOTS, nb), np.int32)
    for s in range(SLOTS):
        used = -(-int(entry[s]) // block)
        tables[s, :used] = ids[s * nb:s * nb + used]
    side_len = width if width > 1 else 5
    q = rng.standard_normal((SLOTS, NUM_KV, groups * width,
                             HEAD_DIM)).astype(np.float32)
    side_shape = (SLOTS, NUM_KV, side_len, HEAD_DIM)
    k_side, v_side = (rng.standard_normal(side_shape).astype(np.float32)
                      for _ in range(2))
    if width > 1:
        side_valid = np.broadcast_to(np.tril(np.ones((width, width), bool)),
                                     (SLOTS, width, width)).copy()
    else:
        side_valid = rng.random((SLOTS, 1, side_len)) < 0.6
        side_valid[:, :, 0] = True
    side_valid[0, 0, :] = False
    return (q, k_pool, v_pool, tables, k_side, v_side, side_valid, entry)


def _to(operand, framework):
    if isinstance(operand, dict):
        return {key: _to(value, framework) for key, value in operand.items()}
    return jnp.asarray(operand) if framework == "jax" else \
        torch.from_numpy(np.ascontiguousarray(operand))


# -- the int8 serving form ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_cache_matches_jax(dtype):
    rng = np.random.default_rng(7)
    tensor = (rng.standard_normal((2, 3, 9, 16)) *
              rng.uniform(0.1, 4.0, (2, 3, 9, 1))).astype(np.float32)
    tensor[0, 0, 4] = 0.0                    # an all-zero row: scale 1e-12
    tensor[1, 2, 0, :4] = [127.0, -127.0, 63.5, -0.5]   # ties at .5
    j_in = jnp.asarray(tensor).astype(getattr(jnp, dtype))
    t_in = torch.from_numpy(tensor).to(getattr(torch, dtype))
    expected = JL.quantize_kv_cache(j_in)
    result = TL.quantize_kv_cache(t_in)
    assert result["q"].dtype == torch.int8 and result["s"].dtype == \
        torch.float32
    assert result["s"].shape == (2, 3, 9)
    np.testing.assert_array_equal(result["q"].numpy(),
                                  np.asarray(expected["q"]))
    np.testing.assert_array_equal(result["s"].numpy(),
                                  np.asarray(expected["s"]))
    j_back = JL.dequantize_kv_cache(expected, getattr(jnp, dtype))
    t_back = TL.dequantize_kv_cache(result, getattr(torch, dtype))
    assert t_back.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(t_back.float().numpy(),
                                  np.asarray(j_back.astype(jnp.float32)))
    assert TL.dequantize_kv_cache(t_in, torch.float32) is t_in


def _int8_pool_case(seed):
    rng = np.random.default_rng(seed)
    pool = _int8_pool(rng, (6, 2, 4, 8))
    pool["q"][1:] = rng.integers(-127, 128, pool["q"][1:].shape)
    return rng, pool


def test_gather_paged_kv_int8_matches_jax():
    _, pool = _int8_pool_case(30)
    tables = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
    result = TL.gather_paged_kv(_to(pool, "torch"), torch.from_numpy(tables))
    expected = JL.gather_paged_kv(_to(pool, "jax"), jnp.asarray(tables))
    assert result["q"].shape == (2, 2, 12, 8)
    assert result["s"].shape == (2, 2, 12)
    for key in ("q", "s"):
        np.testing.assert_array_equal(result[key].numpy(),
                                      np.asarray(expected[key]))
    values, scales = TL.paged_pool_planes(_to(pool, "torch"))
    assert values.dtype == torch.int8 and scales.shape == (6, 2, 4)


def test_scatter_paged_rows_int8_drops_in_both_planes():
    rng, pool = _int8_pool_case(31)
    # row (1, 1) goes past the pool (id 6 == N), row (0, 1) is negative:
    # both drop, in the values and in the scales
    dest = np.array([[3, -1], [5, 6]], np.int32)
    offsets = np.array([[0, 3], [2, 1]], np.int32)
    rows = TL.quantize_kv_cache(torch.from_numpy(
        rng.standard_normal((2, 2, 2, 8)).astype(np.float32)))
    t_pool = _to({key: value.copy() for key, value in pool.items()}, "torch")
    TL.scatter_paged_rows(t_pool, torch.from_numpy(dest),
                          torch.from_numpy(offsets), rows)
    j_rows = {key: jnp.asarray(value.numpy()) for key, value in rows.items()}
    expected = JL.scatter_paged_rows(
        _to(pool, "jax"), jnp.asarray(np.where(dest < 0, 6, dest)),
        jnp.asarray(offsets), j_rows)
    for key in ("q", "s"):
        np.testing.assert_array_equal(t_pool[key].numpy(),
                                      np.asarray(expected[key]))
        assert not t_pool[key][0].any()             # null block untouched


def test_write_paged_blocks_int8_drops_invalid_rows_as_jax_does():
    rng, pool = _int8_pool_case(32)
    ids = np.array([[2, 4], [6, 6]], np.int32)      # row 1: a pad row
    rows = TL.quantize_kv_cache(torch.from_numpy(
        rng.standard_normal((2, 2, 8, 8)).astype(np.float32)))
    t_pool = _to({key: value.copy() for key, value in pool.items()}, "torch")
    TL.write_paged_blocks(t_pool, torch.from_numpy(ids), rows)
    j_rows = {key: jnp.asarray(value.numpy()) for key, value in rows.items()}
    expected = JL.write_paged_blocks(_to(pool, "jax"), jnp.asarray(ids),
                                     j_rows)
    for key in ("q", "s"):
        np.testing.assert_array_equal(t_pool[key].numpy(),
                                      np.asarray(expected[key]))
        assert not t_pool[key][0].any()


# -- the paged kernel's three numerics ------------------------------------------

@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("width", [1, 16])
@pytest.mark.parametrize("variant", ["native", "int8_fold", "int8_dequant"])
def test_plain_version_matches_pallas_interpret(variant, width, groups,
                                                block):
    int8 = variant != "native"
    fold = variant == "int8_fold"
    operands = _case(groups, width, block, int8,
                     seed=width * 10 + groups + block + 100 * int8)
    expected = JPA.paged_decode_attention(
        *(_to(x, "jax") for x in operands), groups=groups,
        fold_scales=fold, interpret=True)
    before = dict(TPA.launches)
    result = TPA.paged_decode_attention(
        *(_to(x, "torch") for x in operands), groups=groups,
        fold_scales=fold)
    assert TPA.launches == before          # the CPU runs no kernel
    assert result.dtype == torch.float32
    assert result.shape == (SLOTS, NUM_KV, groups * width, HEAD_DIM)
    np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                               rtol=0, atol=F32_ATOL)


def test_fold_and_dequantize_agree_in_f32():
    """In f32 the two int8 numerics are the same algebra (the scale moves
    from the values to the scores and weights), and a fully masked row
    is the uniform average of every dequantized value it covers."""
    operands = _case(2, 1, 8, True, seed=5)
    torch_ops = [_to(x, "torch") for x in operands]
    fold = TPA.paged_decode_attention(*torch_ops, groups=2)
    dequant = TPA.paged_decode_attention(*torch_ops, groups=2,
                                         fold_scales=False)
    np.testing.assert_allclose(fold.numpy(), dequant.numpy(), rtol=0,
                               atol=F32_ATOL)
    _, _, v_pool, tables, _, v_side, _, _ = operands
    v_main = (v_pool["q"].astype(np.float32) *
              v_pool["s"][..., None])[tables[0]]     # [nb, H, B, D]
    covered = np.concatenate(
        [v_main.transpose(1, 0, 2, 3).reshape(NUM_KV, -1, HEAD_DIM),
         v_side[0]], axis=1)
    np.testing.assert_allclose(fold[0, :, 0].numpy(), covered.mean(axis=1),
                               rtol=0, atol=1e-6)
