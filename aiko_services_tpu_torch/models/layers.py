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
    "MHA", "linear", "row_parallel_linear", "enter_columns", "model_share",
    "linear_logits",
    "greedy_tokens", "quantize_linear",
    "quantize_linear_tree", "as_tree", "tree_leaves", "layer_norm", "rms_norm",
    "embedding", "conv1d", "mha", "cached_mha", "precompute_kv", "quantize_kv",
    "dequantize_kv", "quantize_kv_cache", "dequantize_kv_cache",
    "slot_kv_blocks", "concat_kv_rows", "kv_rows_nbytes",
    "init_kv_cache", "update_kv_cache", "gather_paged_kv",
    "paged_pool_planes", "scatter_paged_rows", "slice_paged_block",
    "write_paged_blocks",
    "sinusoid_position_encoding", "rope_frequencies", "apply_rope", "gelu",
    "linear_axes", "layer_norm_axes", "rms_norm_axes", "embedding_axes",
    "conv1d_axes", "mha_axes",
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

def _mm_f32(flat, w):
    """flat [N, in] @ w [in, out] accumulated in f32, returned in f32:
    bf16 operands on the card go to one bf16-in / f32-out product (no
    upcast copy of the weight); elsewhere both operands are taken in
    f32 (the CPU has no such product)."""
    if flat.is_cuda and flat.dtype == w.dtype == torch.bfloat16:
        return torch.mm(flat, w, out_dtype=torch.float32)
    return torch.mm(flat.float(), w.float())


def linear(params, x):
    """x [..., in] @ w [in, out] + b, in x's dtype (f32 accumulation).
    A weight-only int8 linear ({"w8", "s"}, quantize_linear) takes its
    int8 weight converted to x's dtype as the product's operand and
    lands the per-output-channel scale on the f32 accumulator:
    y = (x @ W8) * s + b."""
    flat = x.reshape(-1, x.shape[-1])
    if "w8" in params:
        w8 = params["w8"]
        y = _mm_f32(flat, w8.to(x.dtype)) * params["s"]
        if "b" in params:
            y = y + params["b"]
        return y.reshape(*x.shape[:-1], w8.shape[-1]).to(x.dtype)
    w = params["w"]
    if "b" in params:
        y = torch.addmm(params["b"], flat, w)
    else:
        y = torch.matmul(flat, w)
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def _model_axis_spans(mesh) -> bool:
    """Whether `mesh` has a model axis of more than one rank (the axis
    heads, ffn and vocab shard over)."""
    if mesh is None:
        return False
    from ..parallel.collectives import axis_spans
    return axis_spans(mesh, "model")


def model_share(count: int, what: str, mesh=None) -> int:
    """This rank's share of `count` (heads, classes) cut over the model
    axis of `mesh`: all of them without one.  A count that does not
    divide raises ValueError, as JAX's placement does (only the
    vocabulary pads)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return count
    from ..parallel.collectives import axis_size
    n = axis_size("model", mesh=mesh)
    if count % n:
        raise ValueError(f"{what} {count} does not divide over the "
                         f"'model' axis of size {n}")
    return count // n


def _sum_over_model(y, mesh):
    """A rank's partial sum y summed over the model axis: in place
    (psum_) with grad off (serving), through the autograd pair's
    reduce_from_axis with it on (training)."""
    from ..parallel.collectives import psum_, reduce_from_axis
    if torch.is_grad_enabled():
        return reduce_from_axis(y, "model", mesh=mesh)
    return psum_(y, "model", mesh=mesh)


def enter_columns(x, mesh=None):
    """x, the same on every rank of the model axis, as the input of a
    column-parallel product over it (q / k / v, the FFN's in, the
    vocab-sharded head): under autograd with a model axis of more than
    one rank, the identity whose gradient is summed over the axis
    (collectives.copy_to_axis); otherwise x itself."""
    if not (torch.is_grad_enabled() and _model_axis_spans(mesh)):
        return x
    from ..parallel.collectives import copy_to_axis
    return copy_to_axis(x, "model", mesh=mesh)


def row_parallel_linear(params, x, mesh=None):
    """A linear whose input axis is sharded over the model axis of
    `mesh` (attention's o over heads, the FFN's down over ffn): each
    rank's product over its slice of the input is a partial sum, summed
    over the model axis in f32 (in place; under autograd through
    collectives.reduce_from_axis, whose gradient reaches every rank
    whole), then the bias and the cast to x's dtype, as GSPMD partitions
    JAX's f32-accumulated einsum.  With no mesh, or a model axis of one
    rank, it is linear() exactly."""
    if not _model_axis_spans(mesh):
        return linear(params, x)
    flat = x.reshape(-1, x.shape[-1])
    if "w8" in params:
        w = params["w8"]
        y = _mm_f32(flat, w.to(x.dtype)) * params["s"]
    else:
        w = params["w"]
        y = _mm_f32(flat, w)
    y = _sum_over_model(y, mesh)
    if "b" in params:
        y = y + params["b"]
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def linear_logits(params, x, mesh=None):
    """Vocab projection x [..., dim] @ w [dim, vocab] with f32
    accumulation KEPT f32: rounding logits to the activations' dtype
    before an argmax can flip near-ties against an f32 reference.  bf16
    operands on the card go to one bf16-in / f32-out product, so the
    [dim, vocab] head is never upcast (that copy would be the decode
    step's largest memory traffic).  Consumes plain {"w"} and quantized
    {"w8", "s"} heads.  With a mesh whose model axis spans ranks, w is
    this rank's vocabulary shard and its logits are gathered over the
    axis in rank order into the whole vocabulary (the serving rounds
    pick from the shards instead: collectives.greedy_pick).  Under
    autograd x enters the vocabulary's columns through enter_columns."""
    y = _local_logits(params, enter_columns(x, mesh))
    if not _model_axis_spans(mesh):
        return y
    from ..parallel.collectives import all_gather
    return all_gather(y, "model", axis=-1, mesh=mesh)


def _local_logits(params, x):
    flat = x.reshape(-1, x.shape[-1])
    if "w8" in params:
        w8 = params["w8"]
        y = _mm_f32(flat, w8.to(x.dtype)) * params["s"]
        return y.reshape(*x.shape[:-1], w8.shape[-1])
    w = params["w"]
    y = _mm_f32(flat, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def greedy_tokens(params, x, mesh=None):
    """The greedy tokens [...] int32 of hidden states x [..., dim] under
    the head: the argmax of linear_logits (the first maximal index, as
    jnp.argmax); with a vocab-sharded head on a mesh, the pick over the
    shards (collectives.greedy_pick), without gathering the logits."""
    if not _model_axis_spans(mesh):
        return torch.argmax(linear_logits(params, x), dim=-1).to(
            torch.int32)
    from ..parallel.collectives import greedy_pick
    return greedy_pick(_local_logits(params, x), "model", mesh=mesh)


def quantize_linear(params, input_max=None) -> dict:
    """Weight-only int8 (W8A16) for one linear: one f32 scale per output
    channel, max|w| over the input axis / 127 + 1e-12, and the weight
    rounded half to even (torch.round, as jnp.round) and clipped to
    [-127, 127].  Returns {"w8": int8 [in, out], "s": f32 [out]} (plus
    "b" passed through), which linear() and linear_logits consume.
    input_max(amax) -> amax: where the input axis is a shard of a longer
    one, the per-channel max over the whole axis (a max over the ranks
    holding its shards), so the scales are the unsharded weight's."""
    w = params["w"]
    amax = w.abs().amax(dim=0).float()
    if input_max is not None:
        amax = input_max(amax)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(
        torch.int8)
    out = {"w8": q, "s": scale}
    if "b" in params:
        out["b"] = params["b"]
    return out


def _children(node):
    """A param tree node's children as (name, child) pairs: a module's
    parameters and submodules, a dict's items, a list's elements; None
    for a leaf."""
    if isinstance(node, nn.ModuleList):
        return list(enumerate(node))
    if isinstance(node, nn.Module):
        return list(node._parameters.items()) + \
            list(node._modules.items())
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def quantize_linear_tree(params, exclude=("router",), input_max=None):
    """The param tree (a module or nested dicts and lists of tensors) as
    nested dicts and lists with every linear ({"w": 2-D, ["b"]}) in its
    quantize_linear form.  Everything else stays as it is: 3-D weights
    (MoE experts, conv1d), embeddings, norms; keys in `exclude` are kept
    whole (MoE routers: int8 rounding could flip the top-k).
    input_max(path, amax) -> amax: quantize_linear's input_max for the
    linear at `path` (a tuple of names and list indices), e.g.
    parallel.sharding.input_axis_max on a mesh."""
    def walk(node, path):
        children = _children(node)
        if children is None:
            return node
        names = {name for name, _ in children}
        if names and names <= {"w", "b"} and \
                getattr(dict(children).get("w"), "ndim", 0) == 2:
            return quantize_linear(
                dict(children), None if input_max is None else
                lambda amax: input_max(path, amax))
        if isinstance(node, (nn.ModuleList, list, tuple)):
            return [walk(child, path + (index,))
                    for index, child in children]
        return {name: (child if name in exclude
                       else walk(child, path + (name,)))
                for name, child in children}
    return walk(params, ())


def as_tree(params):
    """A param tree (a module, or nested dicts and lists) as nested
    dicts and lists of its tensors (the tensors themselves, not
    copies)."""
    children = _children(params)
    if children is None:
        return params
    if isinstance(params, (nn.ModuleList, list, tuple)):
        return [as_tree(child) for _, child in children]
    return {name: as_tree(child) for name, child in children}


def tree_leaves(params, prefix: tuple = ()) -> list:
    """[(path, tensor)] of every tensor in a param tree (a module, or
    nested dicts and lists), the path a tuple of names and indices."""
    children = _children(params)
    if children is None:
        return [(prefix, params)]
    leaves = []
    for name, child in children:
        leaves.extend(tree_leaves(child, prefix + (name,)))
    return leaves


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


def embedding(params, token_ids, mesh=None):
    """Rows of the table for token_ids.  With a mesh whose model axis
    spans ranks the table is this rank's contiguous vocabulary shard, an
    equal chunk (the last one padded where the vocabulary does not
    divide): ids outside it are masked, the rest looked up, and the rows
    summed over the axis (one rank holds each id, so the sum is exact;
    under autograd through collectives.reduce_from_axis, so each id's
    gradient lands on the rank that holds its row)."""
    table = params["table"]
    if not _model_axis_spans(mesh):
        return table[token_ids]
    from ..parallel.collectives import axis_index
    rows = table.shape[0]
    local = token_ids - axis_index("model", mesh=mesh) * rows
    inside = (local >= 0) & (local < rows)
    out = table[torch.where(inside, local, 0)]
    out = out * inside[..., None].to(out.dtype)
    return _sum_over_model(out, mesh)


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


def precompute_kv(params, kv_input, num_kv_heads: int, mesh=None):
    """Project K/V once for reuse across many queries (the encoder output
    attended by every decode step).  Returns (k, v): [B, H_kv, T, D].
    mesh: k and v are this rank's KV heads of a model axis, their input
    entering the columns through enter_columns."""
    kv_input = enter_columns(kv_input, mesh)
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


# -- dense slot-cache rows ------------------------------------------------------
# The dense serving cache is one [S, H, T, D] tensor per layer (the int8
# form: {"q" int8 [S, H, T, D], "s" f32 [S, H, T]}).  A prefix-cache block
# is one slot's rows of one block, [H, B, D] (or the dict): harvest copies
# them out, a hit concatenates them back in.

def slot_kv_blocks(cache, slot: int, start: int, stop: int,
                   block_tokens: int) -> list:
    """One slot's rows [start, stop) of a dense cache leaf as per-block
    COPIES [H, B, D] (or the dict with s [H, B]), each in storage of its
    own: the cache updates in place, a cached block must not, and an
    evicted block frees its bytes whatever its siblings' fate."""
    def rows(plane, a):
        return plane[slot, :, a:a + block_tokens].clone()
    return [{"q": rows(cache["q"], a), "s": rows(cache["s"], a)}
            if isinstance(cache, dict) else rows(cache, a)
            for a in range(start, stop, block_tokens)]


def concat_kv_rows(blocks):
    """Per-block leaves back into contiguous rows along the time axis
    (inverse of slot_kv_blocks), the int8 dict plane by plane: an int8
    chain lands without a dequantize / requantize round trip."""
    if isinstance(blocks[0], dict):
        return {"q": torch.cat([b["q"] for b in blocks], dim=1),
                "s": torch.cat([b["s"] for b in blocks], dim=1)}
    return torch.cat(blocks, dim=1)


def kv_rows_nbytes(rows) -> int:
    """Bytes of K or V rows: a tensor or array, an int8 dict, or a list
    of either (one leaf per layer)."""
    if isinstance(rows, dict):
        return sum(kv_rows_nbytes(leaf) for leaf in rows.values())
    if isinstance(rows, (list, tuple)):
        return sum(kv_rows_nbytes(leaf) for leaf in rows)
    return int(rows.nbytes)


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


def slice_paged_block(pool, block_id: int):
    """One block's rows [H, B, D] (or the int8 dict) of the pool: views,
    not copies."""
    if isinstance(pool, dict):
        return {"q": pool["q"][block_id], "s": pool["s"][block_id]}
    return pool[block_id]


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


def _mha_project(params, x, kv_input, num_heads: int, num_kv_heads: int,
                 qk_transform, precomputed_kv, mesh=None) -> tuple:
    """The projections of mha and cached_mha: (q, k, v, k_scale,
    v_scale), heads split, the
    qk_transform applied; k_scale / v_scale the foldable "tensor"-mode
    scales of a precomputed int8 K/V, else None.  mesh: the heads are
    this rank's, x (and kv_input) entering their columns once each
    (enter_columns)."""
    x = enter_columns(x, mesh)
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
                             num_kv_heads,
                             None if kv_input is None else mesh)
    if qk_transform is not None:
        q, k = qk_transform(q, k)
    return q, k, v, k_scale, v_scale


def _repeat_kv(k, v, num_heads: int, num_kv_heads: int) -> tuple:
    if num_kv_heads != num_heads:                  # GQA: repeat KV groups
        repeat = num_heads // num_kv_heads
        k = torch.repeat_interleave(k, repeat, dim=1)
        v = torch.repeat_interleave(v, repeat, dim=1)
    return k, v


def _plain_attention(params, x, q, k, v, mask, cache, k_scale, v_scale,
                     num_heads: int, num_kv_heads: int, mesh) -> tuple:
    """The plain product of mha and cached_mha: the cache write (and its
    valid-position
    mask), the GQA repeat, an f32 softmax under the mask, the output
    projection.  Returns (output, new_cache)."""
    if cache is not None:
        cache = update_kv_cache(cache, k, v)
        k, v = cache["k"], cache["v"]
        # valid-position mask for the unwritten cache tail
        valid = (torch.arange(k.shape[2], device=k.device)
                 < cache["index"])[None, None, None]
        mask = valid if mask is None else (mask & valid)
    k, v = _repeat_kv(k, v, num_heads, num_kv_heads)
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
    return row_parallel_linear(params["o"], _merge_heads(out), mesh), cache


def mha(params, x, kv_input=None, mask=None, num_heads: int = 8,
        num_kv_heads: int | None = None, qk_transform=None,
        precomputed_kv=None, fused: bool = True, mesh=None):
    """Attention without a KV cache (cached_mha takes one): self
    (kv_input None) or cross (kv_input or precomputed_kv).

    mask: broadcastable to [B, H, Tq, Tk], True = attend.
    qk_transform(q, k) -> (q, k): applied after the head split.
    precomputed_kv: (k, v) already projected and split, each a tensor or
    a quantize_kv dict; "tensor"-mode scales fold into the score scale
    and the output.  mesh: the heads are this rank's share of a model
    axis, and the output projection is row-parallel over it
    (row_parallel_linear).  Mask-free attention of equal lengths goes to
    ops.attention's dispatch (the flash kernel where shapes tile).
    Returns (output, None), as the JAX package's mha without a cache."""
    num_kv_heads = num_kv_heads or num_heads
    q, k, v, k_scale, v_scale = _mha_project(
        params, x, kv_input, num_heads, num_kv_heads, qk_transform,
        precomputed_kv, mesh)
    if fused and mask is None and k_scale is None \
            and q.shape[2] == k.shape[2]:
        # mask-free self/cross attention: the flash kernel where shapes
        # tile, plain attention otherwise
        from ..ops.attention import attention
        k, v = _repeat_kv(k, v, num_heads, num_kv_heads)
        out = attention(q, k, v)
        return row_parallel_linear(params["o"], _merge_heads(out),
                                   mesh), None
    return _plain_attention(params, x, q, k, v, mask, None, k_scale,
                            v_scale, num_heads, num_kv_heads, mesh)


def cached_mha(params, x, cache, mask=None, num_heads: int = 8,
               num_kv_heads: int | None = None, qk_transform=None,
               mesh=None):
    """Self-attention over a KV cache (updated in place, see
    update_kv_cache; None: no cache), the JAX package's mha with a
    cache: qk_transform applies before the cache write, and the product
    is the plain one (the flash kernel takes no cache), so a decoder's
    rounds dispatch no kernel here.  Returns (output, new_cache)."""
    num_kv_heads = num_kv_heads or num_heads
    q, k, v, k_scale, v_scale = _mha_project(
        params, x, None, num_heads, num_kv_heads, qk_transform, None, mesh)
    return _plain_attention(params, x, q, k, v, mask, cache, k_scale,
                            v_scale, num_heads, num_kv_heads, mesh)


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


# -- logical sharding axes ---------------------------------------------------
# Each parameter's axes by logical name, a tree shaped like the JAX param
# tree (parallel/sharding.py maps the names onto a mesh).

def linear_axes(in_axis: str, out_axis: str, bias: bool = True):
    axes = {"w": (in_axis, out_axis)}
    if bias:
        axes["b"] = (out_axis,)
    return axes


def layer_norm_axes():
    return {"scale": ("embed",), "bias": ("embed",)}


def rms_norm_axes():
    return {"scale": ("embed",)}


def embedding_axes():
    return {"table": ("vocab", "embed")}


def conv1d_axes():
    return {"w": (None, None, "embed"), "b": ("embed",)}


def mha_axes(bias: bool = True):
    return {
        "q": linear_axes("embed", "heads", bias),
        "k": linear_axes("embed", "kv_heads", False),
        "v": linear_axes("embed", "kv_heads", bias),
        "o": linear_axes("heads", "embed", bias),
    }
