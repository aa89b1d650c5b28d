# Paged decode attention: the CUDA kernel that reads K/V straight out of
# the serving block pool through per-slot block tables, and its plain
# version.
#
# Counterpart of aiko_services_tpu/ops/paged_attention.py in all three of
# its numerics: native pools, and int8 pools with fold_scales True
# (decode: the scales fold into scores and weights) or False (the
# chunked-prefill extend: blocks dequantize in the compute dtype before
# the dots).  The wrapper takes its plain version only for tensors on the
# CPU; for a CUDA tensor it launches the kernel
# (csrc/paged_decode_attention.cu) or raises.

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.layers import (dequantize_kv_cache, gather_paged_kv,
                             paged_pool_planes)
from .kernels import check, entry, require_cuda

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "kernel_plan", "launches"]

# kernel launches, counted by the wrapper where it launches its kernel,
# one count per numerics variant
launches = {"paged_decode_attention": 0,
            "paged_decode_attention_int8_fold": 0,
            "paged_decode_attention_int8_dequant": 0}

# what the kernel takes (csrc/paged_decode_attention.cu)
_KERNEL_HEAD_DIM = 64
_KERNEL_MAX_BLOCK_TOKENS = 128
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the C entry's `mode`
_NATIVE, _INT8_FOLD, _INT8_DEQUANT = 0, 1, 2
_VARIANTS = {_NATIVE: "paged_decode_attention",
             _INT8_FOLD: "paged_decode_attention_int8_fold",
             _INT8_DEQUANT: "paged_decode_attention_int8_dequant"}
# the C entry's `path`
SPLIT_PATH, TENSOR_PATH = 0, 1
# the tensor-core path: bf16 above this many rows per (slot, KV head),
# 256 rows a block (8 warps of 32).  At 16 rows or fewer a K/V element
# takes at most 16 multiply-adds, so the CUDA cores keep up with the
# loads and the split over T fills the card; above, the products belong
# on the tensor cores and each K/V position is read once per (slot, KV
# head) for all its rows.
_TENSOR_MIN_ROWS = 17
_TENSOR_TILE_ROWS = 256
# the split path: positions per main split (one warp per 64, each taking
# two 32-position tiles), from 64 doubling up to 256 while the grid keeps
# at least _SPLIT_WAVES blocks a multiprocessor (fewer, longer splits:
# less to merge)
_SPLIT_MIN, _SPLIT_MAX, _SPLIT_WAVES = 64, 256, 4
_PARTIAL_FLOATS = _KERNEL_HEAD_DIM + 2      # a split's sums, max and sum


def paged_decode_attention_reference(q, k_pool, v_pool, tables, k_side,
                                     v_side, side_valid, entry_lengths, *,
                                     groups: int, scale: float,
                                     fold_scales: bool = True):
    """Plain version of the paged kernel with the JAX kernel's numerics:
    f32 scores, -1e30 masking of main positions >= entry_lengths and of
    invalid side entries, one softmax over the whole row, weights cast to
    the compute dtype (q's) before the f32-accumulated PV products.  Int8
    pools: with fold_scales the int8 values are the dot operands, the
    score takes * s_k after the scale and before the mask and the weight
    * s_v before its cast; without, the pool dequantizes in the compute
    dtype first (dequantize_kv_cache).  Shapes as paged_decode_attention's;
    returns [S, Hkv, G*W, D] f32."""
    slots_n, _, gw, _ = q.shape
    width = gw // groups
    side_len = k_side.shape[2]
    k_main = gather_paged_kv(k_pool, tables)           # [S, Hkv, T, D]
    v_main = gather_paged_kv(v_pool, tables)
    k_fold = v_fold = None
    if isinstance(k_main, dict) and fold_scales:
        k_fold, v_fold = k_main["s"][:, :, None], v_main["s"][:, :, None]
        k_main, v_main = k_main["q"].to(q.dtype), v_main["q"].to(q.dtype)
    else:
        k_main = dequantize_kv_cache(k_main, q.dtype)
        v_main = dequantize_kv_cache(v_main, q.dtype)
    main_t = k_main.shape[2]
    q32 = q.float()
    scores_main = torch.matmul(q32, k_main.float().transpose(-1, -2)) * scale
    if k_fold is not None:
        scores_main = scores_main * k_fold
    scores_side = torch.matmul(q32, k_side.float().transpose(-1, -2)) * scale
    main_valid = (torch.arange(main_t, device=q.device)[None] <
                  entry_lengths[:, None])[:, None, None, :]
    side_ok = side_valid[:, None, None].expand(
        slots_n, 1, groups, width, side_len).reshape(slots_n, 1, gw,
                                                     side_len)
    masked = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    scores = torch.cat([torch.where(main_valid, scores_main, masked),
                        torch.where(side_ok, scores_side, masked)], dim=-1)
    weights = torch.softmax(scores, dim=-1)
    w_main = weights[..., :main_t]
    if v_fold is not None:
        w_main = w_main * v_fold
    w_main = w_main.to(q.dtype).float()
    w_side = weights[..., main_t:].to(v_side.dtype).float()
    return torch.matmul(w_main, v_main.float()) + \
        torch.matmul(w_side, v_side.float())


def kernel_plan(is_bf16: bool, slots: int, num_kv: int, rows: int,
                positions: int, multiprocessors: int) -> tuple:
    """How the CUDA kernel splits one call, from host-known shapes only
    (never from entry_lengths, which live on the card): (path, rows per
    block, positions per main split, main splits).  `positions` is the
    table's nb * B.  The tensor-core path (bf16, more than 16 rows) takes
    all of a (slot, KV head)'s positions in one block; the split path
    covers them in main splits of split positions each, plus one split
    for the side buffer, and merges the splits in a second kernel."""
    if is_bf16 and rows >= _TENSOR_MIN_ROWS:
        return TENSOR_PATH, _TENSOR_TILE_ROWS, positions, 1
    tile_rows = 4 if rows <= 4 else 16
    blocks = slots * num_kv * -(-rows // tile_rows)
    split = _SPLIT_MIN
    while split < _SPLIT_MAX and blocks * (-(-positions // (2 * split)) +
                                           1) >= _SPLIT_WAVES * \
            multiprocessors:
        split *= 2
    return SPLIT_PATH, tile_rows, split, -(-positions // split)


def _check_planes(k_pool, v_pool) -> tuple:
    """(k values, k scales, v values, v scales) of the two pool leaves,
    raising where the planes do not make one pool form."""
    name = "paged_decode_attention"
    kq, ks = paged_pool_planes(k_pool)
    vq, vs = paged_pool_planes(v_pool)
    if (ks is None) != (vs is None):
        raise TypeError(f"{name}: k_pool and v_pool differ in form (one "
                        f"int8 dict, one native tensor)")
    for label, values, scales in (("k_pool", kq, ks), ("v_pool", vq, vs)):
        if scales is None:
            continue
        if values.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError(f"{name}: an int8 {label} holds int8 values "
                            f"and float32 scales, got {values.dtype} and "
                            f"{scales.dtype}")
        if tuple(scales.shape) != tuple(values.shape[:-1]):
            raise ValueError(f"{name}: {label} scale plane has shape "
                             f"{tuple(scales.shape)}, expected "
                             f"{tuple(values.shape[:-1])} (one scale per "
                             f"position)")
    return kq, ks, vq, vs


def _check_operands(q, kq, ks, vq, vs, tables, k_side, v_side, side_valid,
                    entry_lengths, groups: int) -> None:
    name = "paged_decode_attention"
    slots_n, num_kv, gw, head_dim = q.shape
    width = gw // groups
    num_blocks, _, block_tokens, _ = kq.shape
    nb, side_len = tables.shape[1], k_side.shape[2]
    pool_shape = (num_blocks, num_kv, block_tokens, head_dim)
    expected = {
        "k_pool": (kq, pool_shape),
        "v_pool": (vq, pool_shape),
        "tables": (tables, (slots_n, nb)),
        "k_side": (k_side, (slots_n, num_kv, side_len, head_dim)),
        "v_side": (v_side, (slots_n, num_kv, side_len, head_dim)),
        "side_valid": (side_valid, (slots_n, width, side_len)),
        "entry_lengths": (entry_lengths, (slots_n,)),
    }
    if ks is not None:
        expected["k_pool scales"] = (ks, pool_shape[:3])
        expected["v_pool scales"] = (vs, pool_shape[:3])
    for label, (tensor, shape) in expected.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name}: {label} has shape "
                             f"{tuple(tensor.shape)}, expected {shape}")
        if tensor.device != q.device:
            raise ValueError(f"{name}: {label} on {tensor.device}, q on "
                             f"{q.device}")
    pool_dtype = q.dtype if ks is None else torch.int8
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k_side, v_side)) or any(
            t.dtype != pool_dtype for t in (kq, vq)):
        raise TypeError(f"{name}: the CUDA kernel takes q, side buffers and "
                        f"native pools of one type, bfloat16 or float32 "
                        f"(int8 pools: int8 values, float32 scales)")
    if tables.dtype != torch.int32 or entry_lengths.dtype != torch.int32 \
            or side_valid.dtype != torch.bool:
        raise TypeError(f"{name}: tables and entry_lengths must be int32 "
                        f"and side_valid bool")
    for label, tensor in (("q", q), ("k_pool", kq), ("v_pool", vq),
                          ("k_side", k_side), ("v_side", v_side),
                          ("side_valid", side_valid),
                          ("entry_lengths", entry_lengths),
                          *(() if ks is None else
                            (("k_pool scales", ks), ("v_pool scales", vs)))):
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if tables.stride(1) != 1:
        raise ValueError(f"{name}: tables needs unit stride along a row")
    # the kernel copies pool and side rows 16 bytes at a time
    for label, tensor in (("q", q), ("k_pool", kq), ("v_pool", vq),
                          ("k_side", k_side), ("v_side", v_side)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte "
                             f"boundary")
    if head_dim != _KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dim "
                         f"{_KERNEL_HEAD_DIM}, got {head_dim}")
    if not 1 <= block_tokens <= _KERNEL_MAX_BLOCK_TOKENS:
        raise ValueError(f"{name}: the CUDA kernel takes 1 to "
                         f"{_KERNEL_MAX_BLOCK_TOKENS} tokens per block, "
                         f"got {block_tokens}")
    if nb < 1 or slots_n < 1:
        raise ValueError(f"{name}: empty block table {tuple(tables.shape)}")


def paged_decode_attention(q, k_pool, v_pool, tables, k_side, v_side,
                           side_valid, entry_lengths, *, groups: int,
                           scale: float | None = None,
                           fold_scales: bool = True):
    """Block-table-native decode attention over a paged KV pool.

    q:             [S, Hkv, G*W, D] grouped queries (G-major: row g*W + w)
    k/v_pool:      one layer's pool [N, Hkv, B, D], or the int8 serving
                   dict {"q" int8 [N, Hkv, B, D], "s" f32 [N, Hkv, B]}
    tables:        [S, nb] int32 block ids (unfilled entries point at the
                   null block; positions past entry_lengths are masked)
    k/v_side:      [S, Hkv, P, D] this round's side buffers, in q's dtype
    side_valid:    [S, W, P] bool, per-query side visibility
    entry_lengths: [S] int32 read-only main extent per slot

    Returns [S, Hkv, G*W, D] f32.  fold_scales chooses between the int8
    pools' two numerics (paged_decode_attention_reference); native pools
    ignore it.  On the card the kernel takes bf16 or f32 with D = 64 and
    B <= 128 (contiguous operands, q, pools and side buffers on 16-byte
    boundaries; the table may be a column slice), split as kernel_plan
    says."""
    kq, ks, vq, vs = _check_planes(k_pool, v_pool)
    slots_n, num_kv, gw, head_dim = q.shape
    if gw % groups:
        raise ValueError(f"paged_decode_attention: {gw} query rows do not "
                         f"split into {groups} groups")
    if scale is None:
        # f32(1)/sqrt(f32(d)): the exact value the JAX oracle computes
        scale = float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, tables, k_side, v_side, side_valid,
            entry_lengths, groups=groups, scale=scale,
            fold_scales=fold_scales)
    require_cuda("paged_decode_attention", q)
    _check_operands(q, kq, ks, vq, vs, tables, k_side, v_side, side_valid,
                    entry_lengths, groups)
    mode = _NATIVE if ks is None else (_INT8_FOLD if fold_scales
                                       else _INT8_DEQUANT)
    library, function = entry(
        "paged_decode_attention", "aiko_paged_decode_attention",
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] +
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] +
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    nb, block_tokens = tables.shape[1], kq.shape[2]
    path, tile_rows, split, main_splits = kernel_plan(
        q.dtype == torch.bfloat16, slots_n, num_kv, gw, nb * block_tokens,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty((slots_n, num_kv, gw, head_dim), dtype=torch.float32,
                      device=q.device)
    partials = None if path == TENSOR_PATH else torch.empty(
        slots_n * num_kv * (main_splits + 1) * gw * _PARTIAL_FLOATS,
        dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = function(
            int(q.dtype == torch.bfloat16), mode, q.data_ptr(),
            kq.data_ptr(), 0 if ks is None else ks.data_ptr(),
            vq.data_ptr(), 0 if vs is None else vs.data_ptr(),
            tables.data_ptr(), tables.stride(0), k_side.data_ptr(),
            v_side.data_ptr(), side_valid.data_ptr(),
            entry_lengths.data_ptr(), out.data_ptr(), slots_n, num_kv, gw,
            gw // groups, nb, block_tokens, k_side.shape[2], head_dim,
            float(scale), path, tile_rows, split, main_splits,
            0 if partials is None else partials.data_ptr(), stream)
    launches[_VARIANTS[mode]] += 1
    check(library, "paged_decode_attention", code)
    return out
