# Ring attention: exact attention over sequences sharded across ranks,
# and the plain full attention the dispatcher's short-sequence path runs.
#
# Counterpart of aiko_services_tpu/parallel/ring_attention.py (blockwise
# ring attention, Liu et al.): Q stays resident, K/V blocks rotate around
# the sequence axis's ring (one ppermute_ring a step, none after the
# last block), and the softmax accumulates online (running max and
# normalizer), so no rank holds the S x S score matrix.  JAX's
# semantics, spelled out:
#   * masking is by -inf (not the serving paths' -1e30);
#   * a fully masked block leaves the accumulators untouched;
#   * a fully masked row comes out as zeros (l == 0 → 1), not as the
#     uniform average;
#   * products and the accumulators are f32;
#   * GQA rotates K/V at H_kv heads and expands them per block.
# No kernel lies here: plain torch, as plain jnp in JAX.

from __future__ import annotations

import math

import torch

from .collectives import axis_index, axis_size, ppermute_ring, shard_map
from .mesh import AXIS_SEQUENCE

__all__ = ["ring_attention", "ring_attention_sharded", "attention_reference"]


def _block_update(q, k, v, o, m, l, q_offset, k_offset, causal, scale):
    """One online-softmax accumulation step against a K/V block.

    q: [B,H,Sq,D]  k,v: [B,H,Sk,D]  o: [B,H,Sq,D] f32  m,l: [B,H,Sq] f32;
    offsets are the blocks' global sequence positions (causal masks)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, float("-inf"))

    block_max = scores.amax(dim=-1)                          # [B,H,Sq]
    m_new = torch.maximum(m, block_max)
    # fully-masked block: keep accumulators untouched (exp(-inf)=0 paths)
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), torch.zeros_like(p), p)
    correction = torch.where(torch.isneginf(m), torch.zeros_like(m),
                             torch.exp(m - m_safe))
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.matmul(p, v.float())
    return o_new, m_new, l_new


def ring_attention_sharded(q, k, v, axis_name: str = AXIS_SEQUENCE,
                           causal: bool = False, scale: float | None = None,
                           *, mesh):
    """The per-rank body: q, k, v are this rank's [B, H, S_local, D]
    blocks of a sequence sharded over `axis_name` of `mesh`, in rank
    order.  k/v may carry fewer heads than q (H_q % H_kv == 0): the ring
    rotates the small K/V blocks and expands them per block only."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    n = axis_size(axis_name, mesh=mesh)
    my_idx = axis_index(axis_name, mesh=mesh)
    s_local = q.shape[2]
    q_offset = my_idx * s_local

    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), device=q.device)
    kv = torch.stack([k, v])                      # one rotation a step
    for i in range(n):
        kv_idx = (my_idx - i) % n         # whose block we hold at step i
        k_blk, v_blk = kv[0], kv[1]
        if group > 1:                     # GQA: expand per block only
            k_blk = torch.repeat_interleave(k_blk, group, dim=1)
            v_blk = torch.repeat_interleave(v_blk, group, dim=1)
        o, m, l = _block_update(q, k_blk, v_blk, o, m, l, q_offset,
                                kv_idx * s_local, causal, scale)
        if i < n - 1:
            kv = ppermute_ring(kv, axis_name, n, mesh=mesh)
    l = torch.where(l == 0.0, torch.ones_like(l), l)   # masked rows → 0
    return (o / l[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = AXIS_SEQUENCE,
                   batch_axis: str | None = "data", causal: bool = False,
                   scale: float | None = None):
    """Sequence-parallel exact attention.

    q, k, v: [B, H, S, D], DTensors or full tensors every rank holds, S
    sharded over `axis_name` (and B over `batch_axis` if the mesh has
    it).  Returns a [B, H, S, D] DTensor with that sharding."""
    batch = batch_axis if batch_axis in mesh.mesh_dim_names else None
    spec = (batch, None, axis_name, None)

    def body(q, k, v):
        return ring_attention_sharded(q, k, v, axis_name, causal, scale,
                                      mesh=mesh)
    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)


def attention_reference(q, k, v, causal: bool = False,
                        scale: float | None = None):
    """Plain full attention with f32 scores and softmax.
    q: [B, H, Sq, D], k/v: [B, H, Sk, D] → [B, H, Sq, D] in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)
