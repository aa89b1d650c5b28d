"""Parity of the port's attention (aiko_services_tpu_torch.ops.attention)
with the JAX package's.

On the CPU each kernel wrapper runs its plain version; the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Inputs are made from a seed with numpy and handed to both packages.
The kernels themselves are held against these plain versions on the card
by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import attention as JA
from aiko_services_tpu.parallel.ring_attention import \
    attention_reference as jax_attention_reference
from aiko_services_tpu_torch.ops import attention as TA

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

# f32 on the CPU: both sides sum the same products in another order
F32_ATOL = 1e-5
# bf16, elementwise: |port - jax| <= 2^-7 |jax| + 2^-8 sum_j p_j |v_j| / l,
# i.e. the two outputs' bf16 roundings (half an ulp each, 2^-8 relative)
# plus the JAX kernel's bf16 rounding of the probabilities before the PV
# product (2^-8 relative each); sum_j p_j |v_j| / l is the plain version
# on |v|
BF16_ROUNDING = 2 ** -7
BF16_PROBABILITIES = 2 ** -8


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 256])
def test_flash_attention_matches_pallas_interpret(seq, causal):
    q, k, v = _qkv((2, 3, seq, 64), seed=seq + int(causal))
    expected = JA.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=64,
        block_k=64, interpret=True)
    result = TA.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        block_q=64, block_k=64)
    assert result.dtype == torch.float32 and result.shape == q.shape
    np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                               rtol=0, atol=F32_ATOL)


def test_flash_attention_rejects_ragged_blocks():
    q = torch.ones((1, 1, 100, 16))
    with pytest.raises(ValueError, match="not divisible"):
        TA.flash_attention(q, q, q, block_q=64, block_k=64)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A wrapper takes its plain version only for CPU tensors; any other
    device either launches the CUDA kernel or raises."""
    q = torch.empty((1, 1, 128, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        TA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        TA.cross_decode_attention(q[:, :, :1], q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_attention_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(7)
    b, h, t, d = 3, 4, 200, 64        # t pads to 256 inside the kernels
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(2))
    jax_dtype, torch_dtype = getattr(jnp, dtype), getattr(torch, dtype)
    expected = JA.cross_decode_attention(
        *(jnp.asarray(x, jax_dtype) for x in (q, k, v)), interpret=True)
    result = TA.cross_decode_attention(
        *(torch.from_numpy(x).to(torch_dtype) for x in (q, k, v)))
    assert result.dtype == torch_dtype and result.shape == (b, h, 1, d)
    expected = np.asarray(expected.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(result.numpy(), expected, rtol=0,
                                   atol=F32_ATOL)
        return
    q, k, v = (torch.from_numpy(x).to(torch_dtype).float() for x in (q, k, v))
    magnitude = TA.cross_decode_attention_reference(q, k, v.abs()).numpy()
    limit = BF16_ROUNDING * np.abs(expected) + BF16_PROBABILITIES * magnitude
    assert (np.abs(result.float().numpy() - expected) <= limit).all()


def test_cross_decode_attention_rejects_multi_row_queries():
    q = torch.zeros((1, 1, 2, 64))
    with pytest.raises(ValueError, match="q_len 1"):
        TA.cross_decode_attention(q, q, q)


@pytest.mark.parametrize("causal", [False, True])
def test_dispatcher_short_sequences_take_plain_attention(causal):
    q, k, v = _qkv((2, 3, 96, 32), seed=11)
    before = dict(TA.dispatch_stats)
    result = TA.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal)
    assert TA.dispatch_stats["xla"] == before["xla"] + 1
    assert TA.dispatch_stats["flash"] == before["flash"]
    expected = jax_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                               rtol=0, atol=F32_ATOL)


def test_dispatcher_long_tiled_sequences_take_the_flash_path():
    """s >= FLASH_MIN_SEQ, s % 128 == 0, d % 64 == 0: the kernel path
    (its plain version on the CPU), held against the JAX reference."""
    q, k, v = _qkv((1, 1, TA.FLASH_MIN_SEQ, 64), seed=13)
    before = dict(TA.dispatch_stats)
    result = TA.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert TA.dispatch_stats["flash"] == before["flash"] + 1
    expected = jax_attention_reference(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                               rtol=0, atol=F32_ATOL)
