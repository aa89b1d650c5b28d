# Shared neural-net building blocks: nn.Module parameter holders and
# plain functions on tensors.
#
# Counterpart of aiko_services_tpu/models/layers.py, the subset Whisper
# and Llama use.  Parameter layouts are the JAX package's, so a JAX param tree
# copies over leaf for leaf (bridge.py): a linear's `w` is [in, out], a
# conv1d's `w` is [k, in, out] (WIO).  Every module reads like the JAX
# param dict it mirrors (params["w"], "b" in params), so the functions
# below accept either a module or a plain dict of tensors.
#
# dtype policy, as in JAX: compute runs in the activations' dtype with
# f32 accumulation; attention scores and softmax are f32.

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Params", "Linear", "LayerNorm", "RMSNorm", "Embedding", "Conv1d",
    "MHA", "linear", "linear_logits", "layer_norm", "rms_norm",
    "embedding", "conv1d", "mha", "precompute_kv", "quantize_kv",
    "dequantize_kv", "quantize_kv_cache", "dequantize_kv_cache",
    "init_kv_cache", "update_kv_cache", "gather_paged_kv",
    "paged_pool_planes", "scatter_paged_rows", "write_paged_blocks",
    "sinusoid_position_encoding", "rope_frequencies", "apply_rope", "gelu",
]


class Params(nn.Module):
    """A module that reads like the JAX param dict it mirrors:
    module["w"] is the parameter or child named "w", and `"b" in module`
    says whether it has one."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(tensor, generator, std: float) -> None:
    noise = torch.randn(tuple(tensor.shape), generator=generator,
                        device=generator.device, dtype=torch.float32)
    tensor.copy_(noise * std)


class Linear(Params):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param((in_dim, out_dim), dtype, device)
        if bias:
            self.b = _param((out_dim,), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        _normal_(self.w, generator, 1.0 / math.sqrt(self.w.shape[0]))
        if "b" in self:
            self.b.zero_()


class LayerNorm(Params):
    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = _param((dim,), dtype, device)
        self.bias = _param((dim,), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


class Embedding(Params):
    def __init__(self, vocab: int, dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.table = _param((vocab, dim), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        _normal_(self.table, generator, 0.02)


class Conv1d(Params):
    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param((kernel, in_ch, out_ch), dtype, device)
        self.b = _param((out_ch,), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        kernel, in_ch, _ = self.w.shape
        _normal_(self.w, generator, 1.0 / math.sqrt(in_ch * kernel))
        self.b.zero_()


class RMSNorm(Params):
    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = _param((dim,), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        self.scale.fill_(1.0)


class MHA(Params):
    """Multi-head attention projections; num_kv_heads < num_heads is GQA.
    k carries no bias; q, v and o carry one when `bias` (as in JAX)."""

    def __init__(self, dim: int, num_heads: int,
                 num_kv_heads: int | None = None, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        head_dim = dim // num_heads
        inner = num_heads * head_dim
        kv_inner = (num_kv_heads or num_heads) * head_dim
        self.q = Linear(dim, inner, bias, dtype, device)
        self.k = Linear(dim, kv_inner, False, dtype, device)
        self.v = Linear(dim, kv_inner, bias, dtype, device)
        self.o = Linear(inner, dim, bias, dtype, device)


# -- functions ---------------------------------------------------------------

def linear(params, x):
    """x [..., in] @ w [in, out] + b, in x's dtype (f32 accumulation)."""
    w = params["w"]
    flat = x.reshape(-1, x.shape[-1])
    if "b" in params:
        y = torch.addmm(params["b"], flat, w)
    else:
        y = torch.matmul(flat, w)
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def linear_logits(params, x):
    """Vocab projection x [..., dim] @ w [dim, vocab] with f32
    accumulation KEPT f32: rounding logits to the activations' dtype
    before an argmax can flip near-ties against an f32 reference.  bf16
    operands on the card go to one bf16-in / f32-out product, so the
    [dim, vocab] head is never upcast (that copy would be the decode
    step's largest memory traffic); elsewhere both operands are taken in
    f32 (the CPU has no such product)."""
    w = params["w"]
    flat = x.reshape(-1, x.shape[-1])
    if flat.is_cuda and flat.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        y = torch.mm(flat.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def layer_norm(params, x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def rms_norm(params, x, eps: float = 1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"]).to(x.dtype)


def embedding(params, token_ids):
    return params["table"][token_ids]


def conv1d(params, x, stride: int = 1, padding=None):
    """x: [B, T, C_in] → [B, T', C_out], w [k, in, out].

    Default padding is SYMMETRIC (k-1)//2 on both sides (what Whisper
    checkpoints are trained under), not XLA's asymmetric "SAME" under
    stride > 1; even kernels must pass `padding` as [(left, right)]."""
    w = params["w"]
    if padding is None:
        k = w.shape[0]
        if k % 2 == 0:
            raise ValueError(
                f"conv1d default padding requires an odd kernel, got "
                f"{k}; pass padding explicitly for even kernels")
        padding = [((k - 1) // 2, (k - 1) // 2)]
    (left, right), = padding
    channels_first = F.pad(x.transpose(1, 2), (left, right))
    y = F.conv1d(channels_first, w.permute(2, 1, 0), params["b"],
                 stride=stride)
    return y.transpose(1, 2).to(x.dtype)


def _split_heads(x, num_heads: int):
    b, t, _ = x.shape
    return x.view(b, t, num_heads, -1).permute(0, 2, 1, 3)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * d)


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.float32, device=None):
    """Static-shape KV cache: [B, H_kv, T_max, D] + write index."""
    shape = (batch, num_kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def update_kv_cache(cache, k_new, v_new):
    """Write new K/V at the cache cursor and return the cache with the
    cursor advanced.  Unlike the JAX function this writes IN PLACE: the
    returned dict shares its buffers with `cache`.  The start clamps into
    range as jax.lax.dynamic_update_slice does."""
    t_max, t = cache["k"].shape[2], k_new.shape[2]
    start = min(max(int(cache["index"]), 0), t_max - t)
    cache["k"][:, :, start:start + t] = k_new
    cache["v"][:, :, start:start + t] = v_new
    return {"k": cache["k"], "v": cache["v"],
            "index": int(cache["index"]) + t}


def precompute_kv(params, kv_input, num_kv_heads: int):
    """Project K/V once for reuse across many queries (the encoder output
    attended by every decode step).  Returns (k, v): [B, H_kv, T, D]."""
    k = _split_heads(linear(params["k"], kv_input), num_kv_heads)
    v = _split_heads(linear(params["v"], kv_input), num_kv_heads)
    return k, v


def quantize_kv(tensor, mode: str = "position"):
    """Symmetric int8 quantization of a K or V tensor [..., T, D].

    mode="position": one bf16 scale per position (over the last axis).
    mode="tensor": one f32 scale per leading-axis element (per batch
    item of a [B, H, T, D] tensor), so mha can fold it into the score
    scale and the output.  Returns {"q": int8, "s": scale}."""
    if mode == "tensor":
        dims = tuple(range(1, tensor.ndim))
        scale = tensor.abs().amax(dim=dims, keepdim=True).float() / 127.0 \
            + 1e-12
        q = torch.clamp(torch.round(tensor.float() / scale), -127, 127)
        return {"q": q.to(torch.int8), "s": scale}
    if mode != "position":
        raise ValueError(f"unknown quantize_kv mode {mode!r}")
    scale = (tensor.abs().amax(dim=-1, keepdim=True).float() / 127.0
             + 1e-12).to(torch.bfloat16)
    q = torch.clamp(torch.round(tensor.float() / scale.float()), -127, 127)
    return {"q": q.to(torch.int8), "s": scale}


def dequantize_kv(kv, dtype):
    """Inverse of quantize_kv; passes plain tensors through."""
    if isinstance(kv, dict) and "q" in kv:
        return kv["q"].to(dtype) * kv["s"].to(dtype)
    return kv


def quantize_kv_cache(tensor):
    """Symmetric int8 for the serving KV cache: one f32 scale per
    (..., position), max|x| / 127 + 1e-12, values rounded half to even
    (torch.round, as jnp.round) and clipped to [-127, 127].  Returns
    {"q": int8 [..., T, D], "s": f32 [..., T]}."""
    scale = tensor.abs().amax(dim=-1).float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(tensor.float() / scale[..., None]),
                    -127, 127)
    return {"q": q.to(torch.int8), "s": scale}


def dequantize_kv_cache(kv, dtype):
    """Inverse of quantize_kv_cache, in `dtype`: both factors cast, then
    multiplied (in bf16 the product rounds to bf16, as JAX's does);
    passes plain tensors through."""
    if isinstance(kv, dict) and "q" in kv:
        return kv["q"].to(dtype) * kv["s"][..., None].to(dtype)
    return kv


# -- paged KV block pool primitives -------------------------------------------
# The paged serving cache (serving_paged.BlockPool) stores KV in one
# [N, H, B, D] pool of B-token blocks per layer, or in the int8 serving
# form {"q" int8 [N, H, B, D], "s" f32 [N, H, B]} (quantize_kv_cache),
# addressed by per-slot int32 block tables; block 0 is the null block
# (all zeros, never allocated, never written).  The functions below take
# either form, the dict plane by plane.  Unlike the JAX functions they
# update the pool IN PLACE.  Out-of-range destination ids DROP, as JAX's
# mode="drop" does: a dropped row is redirected to block 0 at its own
# offset and writes back what block 0 holds there, in both planes, so
# the scatter keeps its shape on the device (a boolean selection of the
# live rows would stop the host until the device caught up).

def paged_pool_planes(pool):
    """(value plane, scale plane or None) of one pool leaf: the int8
    serving dict splits into its int8 values [N, H, B, D] and f32
    per-position scales [N, H, B]; native pools carry no scale plane."""
    if isinstance(pool, dict):
        return pool["q"], pool["s"]
    return pool, None


def _plane_pairs(pool, rows):
    """[(pool plane, rows plane)] of a pool leaf and rows of its form."""
    if isinstance(pool, dict) != isinstance(rows, dict):
        raise TypeError("paged pool and rows differ in form: an int8 pool "
                        "takes quantize_kv_cache rows, a native pool "
                        "tensors")
    if isinstance(pool, dict):
        return [(pool["q"], rows["q"]), (pool["s"], rows["s"])]
    return [(pool, rows)]


def gather_paged_kv(pool, tables):
    """Slot-major view of a block pool: tables [S, nb] int32 → [S, H,
    nb*B, D] (the int8 dict: s [S, H, nb*B]), position p of slot s read
    from pool[tables[s, p // B], :, p % B].  Used by the paged kernel's
    plain version."""
    if isinstance(pool, dict):
        return {"q": gather_paged_kv(pool["q"], tables),
                "s": gather_paged_kv(pool["s"], tables)}
    g = pool[tables.long()]                      # [S, nb, H, B, (D)]
    s, nb, h, b = g.shape[:4]
    return g.transpose(1, 2).reshape(s, h, nb * b, *g.shape[4:])


def _drop_to_null(pool, ids):
    """(ids with every out-of-range id sent to block 0, in-range mask)."""
    keep = (ids >= 0) & (ids < pool.shape[0])
    return torch.where(keep, ids, torch.zeros_like(ids)).long(), keep


def scatter_paged_rows(pool, dest_blocks, offsets, rows):
    """Scatter per-position rows into pool blocks, in place: rows [S, H,
    W, D] (scales [S, H, W]); row (s, w) lands at pool[dest_blocks[s, w],
    :, offsets[s, w]] (both [S, W]).  Out-of-range ids drop (inactive
    slots, positions past the table)."""
    offsets = offsets.long()
    for plane, values in _plane_pairs(pool, rows):
        dest, keep = _drop_to_null(plane, dest_blocks)
        vals = values.transpose(1, 2).to(plane.dtype)    # [S, W, H, (D)]
        tail = (None,) * (vals.ndim - 2)
        vals = torch.where(keep[(..., *tail)], vals,
                           plane[dest, :, offsets])
        plane[dest, :, offsets] = vals


def write_paged_blocks(pool, block_ids, rows):
    """Whole-block scatter for the admit prefill, in place: rows [A, H,
    nb*B, D] (scales [A, H, nb*B]) cover nb = block_ids.shape[1] blocks
    per admit row; block j of row a lands at pool[block_ids[a, j]].
    Invalid rows carry out-of-range ids and drop."""
    nb = block_ids.shape[1]
    for plane, values in _plane_pairs(pool, rows):
        ids, keep = _drop_to_null(plane, block_ids)
        a, h, t = values.shape[:3]
        vals = values.reshape(a, h, nb, t // nb,
                              *values.shape[3:]).transpose(1, 2)
        tail = (None,) * (vals.ndim - 2)
        vals = torch.where(keep[(..., *tail)], vals.to(plane.dtype),
                           plane[ids])
        plane[ids] = vals


def _foldable(scale) -> bool:
    """A scale folds into the score scale / output iff it is constant
    along every axis but the batch one (scalar, or [B, 1, ..., 1])."""
    return scale.ndim == 0 or all(d == 1 for d in scale.shape[1:])


def mha(params, x, kv_input=None, mask=None, cache=None,
        num_heads: int = 8, num_kv_heads: int | None = None,
        qk_transform=None, precomputed_kv=None, fused: bool = True):
    """Attention: self (kv_input None), cross (kv_input or precomputed_kv),
    optional KV cache (updated in place, see update_kv_cache).

    mask: broadcastable to [B, H, Tq, Tk], True = attend.
    qk_transform(q, k) -> (q, k): applied after the head split, before
    the cache write.  precomputed_kv: (k, v) already projected and split,
    each a tensor or a quantize_kv dict; "tensor"-mode scales fold into
    the score scale and the output.  Returns (output, new_cache)."""
    num_kv_heads = num_kv_heads or num_heads
    q = _split_heads(linear(params["q"], x), num_heads)
    k_scale = v_scale = None
    if precomputed_kv is not None:
        k, v = precomputed_kv
        if isinstance(k, dict) and isinstance(v, dict) and \
                _foldable(k["s"]) and _foldable(v["s"]):
            k_scale, v_scale = k["s"], v["s"]
            k, v = k["q"].to(x.dtype), v["q"].to(x.dtype)
        else:
            k = dequantize_kv(k, x.dtype)
            v = dequantize_kv(v, x.dtype)
    else:
        k, v = precompute_kv(params, x if kv_input is None else kv_input,
                             num_kv_heads)
    if qk_transform is not None:
        q, k = qk_transform(q, k)

    if cache is not None:
        cache = update_kv_cache(cache, k, v)
        k, v = cache["k"], cache["v"]
        # valid-position mask for the unwritten cache tail
        valid = (torch.arange(k.shape[2], device=k.device)
                 < cache["index"])[None, None, None]
        mask = valid if mask is None else (mask & valid)

    if num_kv_heads != num_heads:                  # GQA: repeat KV groups
        repeat = num_heads // num_kv_heads
        k = torch.repeat_interleave(k, repeat, dim=1)
        v = torch.repeat_interleave(v, repeat, dim=1)

    if fused and mask is None and cache is None and k_scale is None \
            and q.shape[2] == k.shape[2]:
        # mask-free self/cross attention: the flash kernel where shapes
        # tile, plain attention otherwise
        from ..ops.attention import attention
        out = attention(q, k, v)
        return linear(params["o"], _merge_heads(out)), cache

    scale = 1.0 / math.sqrt(q.shape[-1])
    if k_scale is not None:
        scale = scale * k_scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(weights.float(), v.float())
    if v_scale is not None:
        out = out * v_scale
    out = out.to(x.dtype)
    return linear(params["o"], _merge_heads(out)), cache


def sinusoid_position_encoding(length: int, dim: int,
                               max_timescale: float = 10000.0,
                               device=None):
    """Whisper-style sinusoids: [length, dim] f32."""
    half = dim // 2
    log_increment = math.log(max_timescale) / max(half - 1, 1)
    inv_timescales = torch.exp(
        -log_increment * torch.arange(half, device=device,
                                      dtype=torch.float32))
    scaled = torch.arange(length, device=device,
                          dtype=torch.float32)[:, None] * \
        inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None):
    """RoPE cos/sin tables: each [max_len, head_dim // 2] f32."""
    exponents = torch.arange(0, head_dim, 2, device=device,
                             dtype=torch.float32) / head_dim
    # theta filled on the device: torch.tensor(theta, device=...) would
    # be a host-to-device copy that synchronizes the stream
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=device), exponents)
    angles = torch.arange(max_len, device=device,
                          dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin, position_offset=0):
    """x: [B, H, T, D]; rotates interleaved (even, odd) pairs by the
    position angle (not the rotate-half layout).

    position_offset: an int (shared by the batch) or a [B] tensor, one
    offset per example (continuous batching: each slot sits at its own
    sequence position)."""
    t = x.shape[2]
    steps = torch.arange(t, device=x.device)
    if isinstance(position_offset, torch.Tensor) and position_offset.ndim:
        positions = position_offset.long()[:, None] + steps[None]  # [B, T]
        cos_t, sin_t = cos[positions][:, None], sin[positions][:, None]
    else:
        positions = int(position_offset) + steps                   # [T]
        cos_t, sin_t = cos[positions][None, None], sin[positions][None, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos_t - x2 * sin_t,
                           x1 * sin_t + x2 * cos_t], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def gelu(x):
    # exact (erf) gelu: what whisper checkpoints are trained under
    return F.gelu(x, approximate="none")
