"""The kernel wrappers under autograd.

The port's CUDA kernels have no backward (the JAX package's Pallas
kernels have no custom_vjp either), and each wrapper fills its output
through ctypes, so an operand that requires grad would get no gradient
without a word.  On the card each wrapper raises instead; on the CPU
each wrapper runs its plain version, whose gradients equal jax.grad of
the JAX reference on the same inputs: JAX's `attention_reference` for
flash and cross-decode (what the JAX dispatcher runs where flash does
not), and for the paged kernel a jnp transcription of its numerics
over the JAX package's `gather_paged_kv`.  The card's half (each wrapper raises on a CUDA operand that requires
grad) is in tests/test_torch_kernels_cuda.py, which imports no jax.
Inputs are seeded numpy arrays in f32; gradients agree within 1e-5
absolute and relative (f32 sums in two orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models.layers import gather_paged_kv as j_gather
from aiko_services_tpu.parallel import attention_reference as j_attention
from aiko_services_tpu_torch.ops import attention as A
from aiko_services_tpu_torch.ops import paged_attention as P

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in shapes]


def _torch_grads(fn, arrays):
    tensors = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*tensors)
    # a fixed cotangent, not a plain sum: every output element weighs in
    weights = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(out.shape)).astype(np.float32))
    (out * weights).sum().backward()
    return [t.grad.numpy() for t in tensors], weights.numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_version_carries_jax_gradients(causal):
    arrays = _arrays(0, *[(2, 3, 128, 16)] * 3)
    got, weights = _torch_grads(
        lambda q, k, v: A.flash_attention(q, k, v, causal=causal), arrays)
    want = jax.grad(lambda q, k, v: jnp.sum(
        j_attention(q, k, v, causal=causal) * weights),
        argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_cross_decode_plain_version_carries_jax_gradients():
    arrays = _arrays(1, (2, 3, 1, 16), (2, 3, 250, 16), (2, 3, 250, 16))
    got, weights = _torch_grads(A.cross_decode_attention, arrays)
    want = jax.grad(lambda q, k, v: jnp.sum(j_attention(q, k, v) * weights),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def _paged_case(seed):
    slots, num_kv, groups, width, block, nb, side = 2, 2, 2, 2, 8, 3, 3
    q, k_pool, v_pool, k_side, v_side = _arrays(
        seed, (slots, num_kv, groups * width, 16),
        (slots * nb + 1, num_kv, block, 16),
        (slots * nb + 1, num_kv, block, 16),
        (slots, num_kv, side, 16), (slots, num_kv, side, 16))
    k_pool[0] = v_pool[0] = 0
    tables = np.arange(1, slots * nb + 1, dtype=np.int32).reshape(slots, nb)
    side_valid = np.random.default_rng(seed).random((slots, width, side)) \
        < 0.6
    side_valid[:, :, 0] = True
    entries = np.array([13, 24], np.int32)
    return [q, k_pool, v_pool, k_side, v_side], \
        (tables, side_valid, entries, groups)


def _j_paged(q, k_pool, v_pool, k_side, v_side, tables, side_valid,
             entries, groups, scale):
    """The plain version's numerics in jnp: f32 scores, -1e30 masking,
    one softmax over main and side positions, f32 PV products."""
    slots, _, gw, _ = q.shape
    width, side_len = gw // groups, k_side.shape[2]
    k_main, v_main = j_gather(k_pool, tables), j_gather(v_pool, tables)
    scores = jnp.concatenate([
        jnp.einsum("shqd,shkd->shqk", q, k_main) * scale,
        jnp.einsum("shqd,shkd->shqk", q, k_side) * scale], axis=-1)
    main_ok = (jnp.arange(k_main.shape[2])[None] < entries[:, None])
    side_ok = jnp.broadcast_to(side_valid[:, None], (
        slots, groups, width, side_len)).reshape(slots, gw, side_len)
    valid = jnp.concatenate([
        jnp.broadcast_to(main_ok[:, None], (slots, gw, main_ok.shape[1])),
        side_ok], axis=-1)[:, None]
    weights = jax.nn.softmax(jnp.where(valid, scores, -1e30), axis=-1)
    t = k_main.shape[2]
    return jnp.einsum("shqk,shkd->shqd", weights[..., :t], v_main) + \
        jnp.einsum("shqk,shkd->shqd", weights[..., t:], v_side)


def test_paged_plain_version_carries_jax_gradients():
    arrays, (tables, side_valid, entries, groups) = _paged_case(2)
    scale = 0.25

    def port(q, k_pool, v_pool, k_side, v_side):
        return P.paged_decode_attention(
            q, k_pool, v_pool, torch.from_numpy(tables), k_side, v_side,
            torch.from_numpy(side_valid), torch.from_numpy(entries),
            groups=groups, scale=scale)

    got, weights = _torch_grads(port, arrays)
    want = jax.grad(lambda *a: jnp.sum(_j_paged(
        *a, jnp.asarray(tables), jnp.asarray(side_valid),
        jnp.asarray(entries), groups, scale) * weights),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
