"""Ring attention on the port against the JAX package's.

ring_attention over four gloo ranks (tests/torch_spmd.py, one spawn for
the file) on {seq: 4} and on {data: 2, seq: 2}, causal and not, with
as many K/V heads as query heads and with GQA (two query heads a K/V
head), against JAX's ring_attention under shard_map on four virtual CPU
devices and against attention_reference on the whole sequence; f32
inputs from a seeded numpy generator, within 2e-5 (the online softmax
sums blocks in another order than the full softmax).  In one process,
_block_update's semantics against JAX's: -inf masking, a fully masked
block leaves the accumulators as they were, and ring_attention_sharded
on a mesh of one brings a fully masked row out as zeros."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import parallel as JP
from aiko_services_tpu_torch.parallel import create_mesh

# the packages export the function ring_attention under the module's name
JR = importlib.import_module("aiko_services_tpu.parallel.ring_attention")
TR = importlib.import_module(
    "aiko_services_tpu_torch.parallel.ring_attention")

import torch_spmd_cases as cases
from torch_spmd import run_ranks

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, kv_heads, causal):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, 4, 32, 8)).astype(np.float32)
    k, v = (rng.standard_normal((4, kv_heads, 32, 8)).astype(np.float32)
            for _ in range(2))
    return q, k, v, causal


CASES = {f"{'gqa' if kv == 2 else 'mha'}_{'causal' if c else 'full'}":
         _case(i, kv, c) for i, (kv, c) in enumerate(
             [(4, False), (4, True), (2, False), (2, True)])}
MESHES = ({"seq": 4}, {"data": 2, "seq": 2})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(cases.ring, 4, tmp_path_factory.mktemp("ring"), CASES)


@pytest.mark.parametrize("axes", MESHES, ids=["seq4", "data2_seq2"])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_attention_matches_jax_and_the_reference(ranks, axes, name):
    q, k, v, causal = CASES[name]
    mesh = JP.create_mesh(axes, devices=jax.devices()[:4])
    want = np.asarray(jax.jit(lambda q, k, v: JR.ring_attention(
        q, k, v, mesh, causal=causal))(q, k, v))
    group = q.shape[1] // k.shape[1]
    full = np.asarray(JR.attention_reference(
        q, np.repeat(k, group, axis=1), np.repeat(v, group, axis=1),
        causal=causal))
    for result in ranks:
        got = result[(tuple(axes), name)]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, full, **TOL)


def _accumulators(shape):
    b, h, s, d = shape
    return (np.zeros((b, h, s, d), np.float32), np.full((b, h, s), -np.inf,
            np.float32), np.zeros((b, h, s), np.float32))


@pytest.mark.parametrize("k_offset", [8, 0, 64], ids=["diagonal", "past",
                                                        "future"])
def test_block_update_matches_jax(k_offset):
    """Queries at positions 8-15 against a block on the diagonal, one
    wholly in their past and one wholly in their future (fully masked:
    the accumulators stay as they were)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
               for _ in range(3))
    o, m, l = _accumulators(q.shape)
    scale = 1.0 / math.sqrt(4)
    want = JR._block_update(*map(jnp.asarray, (q, k, v, o, m, l)), 8,
                            k_offset, True, scale)
    got = TR._block_update(*map(torch.from_numpy, (q, k, v, o, m, l)), 8,
                           k_offset, True, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if k_offset == 64:
        assert torch.isneginf(got[1]).all() and not got[2].any() and \
            not got[0].any()


def test_a_fully_masked_row_comes_out_as_zeros():
    """On a mesh of one, ring_attention_sharded is attention_reference;
    a row whose every key is masked (a block wholly in its future) keeps
    l == 0, and the ring's guard brings it out as zeros, not as the
    uniform average."""
    mesh = create_mesh({"seq": 1}, device="cpu")
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 4, 4)).astype(
        np.float32)) for _ in range(3))
    out = TR.ring_attention_sharded(q, k, v, "seq", causal=True, mesh=mesh)
    want = JR.attention_reference(*(jnp.asarray(t.numpy())
                                    for t in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    o, m, l = (torch.from_numpy(a) for a in _accumulators(q.shape))
    o, m, l = TR._block_update(q, k, v, o, m, l, 0, 4, True, 0.5)
    assert (l == 0).all()
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    assert not (o / l[..., None]).any()
