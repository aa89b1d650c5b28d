"""Parity of the port's paged decode attention
(aiko_services_tpu_torch.ops.paged_attention) with the JAX package's.

On the CPU the wrapper runs its plain version; the JAX Pallas kernel runs
in interpret mode, as the JAX package's own tests run it.  Inputs are made
from a seed with numpy and handed to both packages: a pool whose blocks
hold stale values (block 0, the null block, zeros), ragged extents (0, a
multiple of the block, one that ends inside a block), table entries past
the extent on the null block, a side buffer under a partial validity mask
and one fully masked query row.  The CUDA kernel is held against the
plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import paged_attention as JPA
from aiko_services_tpu_torch.ops import paged_attention as TPA

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

# f32: the same products summed in another order (blockwise in the JAX
# kernel, one contraction per part here)
F32_ATOL = 1e-5
# bf16 inputs, f32 outputs: both sides cast the softmax weights to bf16
# before the PV products and may round a weight on either side of a bf16
# tie; relative L2 error of the whole output
BF16_REL_L2 = 1e-2

SLOTS, NUM_KV, HEAD_DIM, SIDE = 3, 2, 16, 5


def _case(groups, width, block, seed):
    """Operands as numpy arrays (f32, int32, bool)."""
    rng = np.random.default_rng(seed)
    nb = 3
    num_blocks = SLOTS * nb + 2
    # slot 0 sees nothing in the pool, slot 1 ends on a block boundary,
    # slot 2 inside its second block
    entry = np.array([0, 2 * block, block + 3], np.int32)
    pool_shape = (num_blocks, NUM_KV, block, HEAD_DIM)
    k_pool = rng.standard_normal(pool_shape).astype(np.float32)
    v_pool = rng.standard_normal(pool_shape).astype(np.float32)
    k_pool[0] = v_pool[0] = 0.0                  # the null block
    ids = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((SLOTS, nb), np.int32)
    for s in range(SLOTS):
        used = -(-int(entry[s]) // block)
        tables[s, :used] = ids[s * nb:s * nb + used]
    q = rng.standard_normal((SLOTS, NUM_KV, groups * width,
                             HEAD_DIM)).astype(np.float32)
    side_shape = (SLOTS, NUM_KV, SIDE, HEAD_DIM)
    k_side = rng.standard_normal(side_shape).astype(np.float32)
    v_side = rng.standard_normal(side_shape).astype(np.float32)
    side_valid = rng.random((SLOTS, width, SIDE)) < 0.6
    side_valid[:, :, 0] = True
    side_valid[0, 0, :] = False        # slot 0, query 0: fully masked
    return (q, k_pool, v_pool, tables, k_side, v_side, side_valid,
            entry)


def _both(operands, groups, dtype):
    jax_dtype, torch_dtype = getattr(jnp, dtype), getattr(torch, dtype)
    floats = (0, 1, 2, 4, 5)
    expected = JPA.paged_decode_attention(
        *(jnp.asarray(x, jax_dtype) if i in floats else jnp.asarray(x)
          for i, x in enumerate(operands)), groups=groups, interpret=True)
    result = TPA.paged_decode_attention(
        *(torch.from_numpy(x).to(torch_dtype) if i in floats
          else torch.from_numpy(x) for i, x in enumerate(operands)),
        groups=groups)
    return np.asarray(expected), result


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("width", [1, 3])
def test_plain_version_matches_pallas_interpret(width, groups, block):
    operands = _case(groups, width, block, seed=width * 10 + groups + block)
    before = dict(TPA.launches)
    expected, result = _both(operands, groups, "float32")
    assert TPA.launches == before          # the CPU runs no kernel
    assert result.dtype == torch.float32
    assert result.shape == (SLOTS, NUM_KV, groups * width, HEAD_DIM)
    np.testing.assert_allclose(result.numpy(), expected, rtol=0,
                               atol=F32_ATOL)


def test_fully_masked_row_is_the_uniform_average():
    """JAX's softmax over equal -1e30 scores: every position the row
    covers (the null block's zeros included) weighs the same."""
    q, k_pool, v_pool, tables, k_side, v_side, side_valid, entry = \
        _case(1, 1, 8, seed=3)
    result = TPA.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, k_pool, v_pool, tables, k_side,
                                        v_side, side_valid, entry)),
        groups=1)
    covered = np.concatenate([v_pool[tables[0]].transpose(1, 0, 2, 3)
                              .reshape(NUM_KV, -1, HEAD_DIM), v_side[0]],
                             axis=1)
    np.testing.assert_allclose(result[0, :, 0].numpy(),
                               covered.mean(axis=1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", [1, 3])
def test_plain_version_bf16_matches_pallas_interpret(width):
    operands = _case(2, width, 16, seed=40 + width)
    expected, result = _both(operands, 2, "bfloat16")
    assert result.dtype == torch.float32
    rel_l2 = np.linalg.norm(result.numpy() - expected) / \
        np.linalg.norm(expected)
    assert rel_l2 <= BF16_REL_L2


def test_int8_pools_and_other_devices_raise():
    """Malformed int8 pools (a scale plane of the wrong shape, mixed
    forms), other devices and bad group counts raise."""
    q, k_pool, v_pool, tables, k_side, v_side, side_valid, entry = (
        torch.from_numpy(x) for x in _case(1, 1, 8, seed=5))
    int8_pool = {"q": k_pool.to(torch.int8), "s": k_pool[..., :2]}
    with pytest.raises(ValueError, match="scale plane has shape"):
        TPA.paged_decode_attention(q, int8_pool, int8_pool, tables, k_side,
                                   v_side, side_valid, entry, groups=1)
    with pytest.raises(TypeError, match="differ in form"):
        TPA.paged_decode_attention(q, int8_pool, v_pool, tables, k_side,
                                   v_side, side_valid, entry, groups=1)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        TPA.paged_decode_attention(meta, k_pool, v_pool, tables, k_side,
                                   v_side, side_valid, entry, groups=1)
    with pytest.raises(ValueError, match="do not split"):
        TPA.paged_decode_attention(q, k_pool, v_pool, tables, k_side,
                                   v_side, side_valid, entry, groups=3)
