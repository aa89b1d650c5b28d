"""The paged kernel's path at head dim 128 (Llama-3-8B's) against the
JAX package.

The plain version of the paged kernel (what the wrapper runs for CPU
tensors, and what chip_smoke.py holds the CUDA kernel against on the
card) at D = 128 against JAX's Pallas kernel in interpret mode, f32, in
its three numerics (native pools, int8 folded for decode, int8
dequantized for the extend), at W = 1 (decode, G = 4) and W = 16 (an
extend chunk under a causal triangle), with a fully masked row: within
2e-5 (the same products summed in another order).  kernel_plan at D =
128: the tensor-core path takes 128-row tiles, and a split-path block
never outgrows an SM's shared memory (f32 stops at 128 positions, two
warps).  A paged decoder at head dim 128 (dim 256, 2 heads, 1 KV head)
gives the JAX paged-kernel decoder's greedy tokens, f32, native and int8
pools.  The CUDA kernel at D = 128 is held against its plain version on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.ops import paged_attention as JPA
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.ops import paged_attention as TPA
from aiko_services_tpu_torch.serving import ContinuousDecoder

from test_torch_paged_chunked import fresh_table_scratch
from test_torch_paged_serving import run

torch.set_num_threads(1)

HEAD_DIM = 128
SLOTS, NUM_KV = 3, 2
F32_ATOL = 2e-5
H100_SMS = 132


def _pool(rng, shape, int8):
    if int8:
        values = rng.integers(-127, 128, shape).astype(np.int8)
        scales = rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
        values[0], scales[0] = 0, 0.0
        return {"q": values, "s": scales}
    pool = rng.standard_normal(shape).astype(np.float32)
    pool[0] = 0.0
    return pool


def _case(groups, width, block, int8, seed):
    """Slot 0 sees nothing in the pool and its query 0 no side entry (a
    fully masked row); slot 1 ends on a block boundary, slot 2 inside
    its second block."""
    rng = np.random.default_rng(seed)
    nb = 3
    num_blocks = SLOTS * nb + 2
    entry = np.array([0, 2 * block, block + 3], np.int32)
    shape = (num_blocks, NUM_KV, block, HEAD_DIM)
    k_pool, v_pool = _pool(rng, shape, int8), _pool(rng, shape, int8)
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


@pytest.mark.parametrize("shape", [(1, 4), (16, 1)], ids=["decode", "extend"])
@pytest.mark.parametrize("variant", ["native", "int8_fold", "int8_dequant"])
def test_plain_version_at_d128_matches_pallas_interpret(variant, shape):
    width, groups = shape
    int8 = variant != "native"
    fold = variant == "int8_fold"
    operands = _case(groups, width, 16, int8, seed=width + 7 * int8)
    expected = JPA.paged_decode_attention(
        *(_to(x, "jax") for x in operands), groups=groups,
        fold_scales=fold, interpret=True)
    before = dict(TPA.launches)
    result = TPA.paged_decode_attention(
        *(_to(x, "torch") for x in operands), groups=groups,
        fold_scales=fold)
    assert TPA.launches == before          # the CPU runs no kernel
    assert result.shape == (SLOTS, NUM_KV, groups * width, HEAD_DIM)
    np.testing.assert_allclose(result.numpy(), np.asarray(expected),
                               rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("is_bf16, rows, plan", [
    # the tensor-core path: 128-row tiles at D = 128 (256 at D = 64)
    (True, 256, (TPA.TENSOR_PATH, 128, 4096, 1)),
    # bf16 decode: the split grows to 256 positions (four warps fit)
    (True, 4, (TPA.SPLIT_PATH, 4, 256, 16)),
    # f32: a 256-position split (four warps of two 32 KB stages) would
    # outgrow the SM's shared memory; 128 positions, two warps
    (False, 4, (TPA.SPLIT_PATH, 4, 128, 32)),
    (False, 16, (TPA.SPLIT_PATH, 16, 128, 32)),
])
def test_kernel_plan_at_d128_fits_an_sm(is_bf16, rows, plan):
    got = TPA.kernel_plan(is_bf16, 16, 8, rows, 4096, H100_SMS, 128)
    assert got == plan
    if got[0] == TPA.SPLIT_PATH:
        itemsize = 2 if is_bf16 else 4
        assert TPA._split_block_bytes(itemsize, got[1], 128, got[2]) <= \
            TPA._MAX_SHARED_BYTES
    # D = 64 plans are those of before: every split fits
    assert TPA.kernel_plan(is_bf16, 16, 8, rows, 4096, H100_SMS)[2] == \
        (4096 if got[0] == TPA.TENSOR_PATH else 256)


@pytest.mark.parametrize("head_dim", [64, 128, 96, 256])
def test_the_kernel_takes_head_dims_64_and_128_only(head_dim):
    """The wrapper's checks on a card tensor's operands (host-side, so
    reachable here): head dims 64 and 128 pass, any other raises before
    a launch (no fallback)."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)
    pool = t(5, 2, 16, head_dim)
    operands = (t(3, 2, 4, head_dim), pool, None, pool.clone(), None,
                t(3, 2, dtype=torch.int32), t(3, 2, 5, head_dim),
                t(3, 2, 5, head_dim), t(3, 1, 5, dtype=torch.bool),
                t(3, dtype=torch.int32))
    if head_dim in (64, 128):
        TPA._check_operands(*operands, groups=4)
    else:
        with pytest.raises(ValueError, match="head dim 64 or 128"):
            TPA._check_operands(*operands, groups=4)


J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], dim=256,
                               num_heads=2, num_kv_heads=1, ffn_dim=256,
                               max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{f.name: getattr(J_CONFIG, f.name)
                             for f in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(30)]
REQUESTS = {"a": (PROMPT, 10), "b": (PROMPT[:11] + [3, 4], 8),
            "c": (PROMPT[5:9], 6)}


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(2))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["native", "int8"])
def test_paged_decoder_at_head_dim_128_matches_jax(kv_dtype):
    assert T_CONFIG.head_dim == 128
    params, model = weights()
    kwargs = {"max_slots": 2, "prefill_buckets": (32,), "steps_per_sync": 4,
              "paged_kv": True, "kv_block": 16, "kv_cache_dtype": kv_dtype}
    before = JS.ATTENTION_IMPL
    JS.ATTENTION_IMPL = "paged_kernel"
    try:
        jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    assert jax_decoder.paged_kernel
    fresh_table_scratch(jax_decoder)
    expected = run(jax_decoder, REQUESTS)
    port = ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    assert run(port, REQUESTS) == expected
    assert port.pool.used_blocks() == 0
