# Paged decode attention: the CUDA kernel that reads K/V straight out of
# the serving block pool through per-slot block tables, and its plain
# version.
#
# Counterpart of aiko_services_tpu/ops/paged_attention.py (native pools;
# the int8 pool variants wait, ROADMAP.md Queue 2 item 3).  The wrapper
# takes its plain version only for tensors on the CPU; for a CUDA tensor
# it launches the kernel (csrc/paged_decode_attention.cu) or raises.

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.layers import gather_paged_kv, paged_pool_planes
from .kernels import check, entry, require_cuda

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "launches"]

# kernel launches, counted by the wrapper where it launches its kernel
launches = {"paged_decode_attention": 0}

# what the kernel takes (csrc/paged_decode_attention.cu)
_KERNEL_HEAD_DIM = 64
_KERNEL_MAX_ROWS = 64            # groups * width query rows per KV head
_KERNEL_MAX_BLOCK_TOKENS = 128
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def paged_decode_attention_reference(q, k_pool, v_pool, tables, k_side,
                                     v_side, side_valid, entry_lengths, *,
                                     groups: int, scale: float):
    """Plain version of the paged kernel with the JAX kernel's numerics:
    f32 scores, -1e30 masking of main positions >= entry_lengths and of
    invalid side entries, one softmax over the whole row, weights cast to
    the values' dtype before the f32-accumulated PV products.  Shapes as
    paged_decode_attention's; returns [S, Hkv, G*W, D] f32."""
    slots_n, _, gw, _ = q.shape
    width = gw // groups
    side_len = k_side.shape[2]
    k_main = gather_paged_kv(k_pool, tables)           # [S, Hkv, T, D]
    v_main = gather_paged_kv(v_pool, tables)
    main_t = k_main.shape[2]
    q32 = q.float()
    scores_main = torch.matmul(q32, k_main.float().transpose(-1, -2)) * scale
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
    w_main = weights[..., :main_t].to(v_main.dtype).float()
    w_side = weights[..., main_t:].to(v_side.dtype).float()
    return torch.matmul(w_main, v_main.float()) + \
        torch.matmul(w_side, v_side.float())


def _check_operands(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                    entry_lengths, groups: int) -> None:
    name = "paged_decode_attention"
    slots_n, num_kv, gw, head_dim = q.shape
    width = gw // groups
    num_blocks, _, block_tokens, _ = k_pool.shape
    nb, side_len = tables.shape[1], k_side.shape[2]
    expected = {
        "k_pool": (k_pool, (num_blocks, num_kv, block_tokens, head_dim)),
        "v_pool": (v_pool, (num_blocks, num_kv, block_tokens, head_dim)),
        "tables": (tables, (slots_n, nb)),
        "k_side": (k_side, (slots_n, num_kv, side_len, head_dim)),
        "v_side": (v_side, (slots_n, num_kv, side_len, head_dim)),
        "side_valid": (side_valid, (slots_n, width, side_len)),
        "entry_lengths": (entry_lengths, (slots_n,)),
    }
    for label, (tensor, shape) in expected.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name}: {label} has shape "
                             f"{tuple(tensor.shape)}, expected {shape}")
        if tensor.device != q.device:
            raise ValueError(f"{name}: {label} on {tensor.device}, q on "
                             f"{q.device}")
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k_pool, v_pool, k_side, v_side)):
        raise TypeError(f"{name}: the CUDA kernel takes q, pools and side "
                        f"buffers of one type, bfloat16 or float32")
    if tables.dtype != torch.int32 or entry_lengths.dtype != torch.int32 \
            or side_valid.dtype != torch.bool:
        raise TypeError(f"{name}: tables and entry_lengths must be int32 "
                        f"and side_valid bool")
    for label, tensor in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                          ("k_side", k_side), ("v_side", v_side),
                          ("side_valid", side_valid),
                          ("entry_lengths", entry_lengths)):
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if tables.stride(1) != 1:
        raise ValueError(f"{name}: tables needs unit stride along a row")
    if head_dim != _KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dim "
                         f"{_KERNEL_HEAD_DIM}, got {head_dim}")
    if gw > _KERNEL_MAX_ROWS:
        raise ValueError(f"{name}: the CUDA kernel takes at most "
                         f"{_KERNEL_MAX_ROWS} query rows (groups x width) "
                         f"per KV head, got {gw}")
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
    k/v_pool:      one layer's pool [N, Hkv, B, D]
    tables:        [S, nb] int32 block ids (unfilled entries point at the
                   null block; positions past entry_lengths are masked)
    k/v_side:      [S, Hkv, P, D] this round's side buffers
    side_valid:    [S, W, P] bool, per-query side visibility
    entry_lengths: [S] int32 read-only main extent per slot

    Returns [S, Hkv, G*W, D] f32.  The JAX signature: `fold_scales`
    chooses between the int8 pools' two numerics, and int8 pools raise
    NotImplementedError here (ROADMAP.md Queue 2 item 3), so with the
    native pools taken it selects nothing.  On the card the kernel takes
    bf16 or f32 with D = 64, G*W <= 64 and B <= 128 (contiguous operands;
    the table may be a column slice)."""
    k_pool, _ = paged_pool_planes(k_pool)
    v_pool, _ = paged_pool_planes(v_pool)
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
            entry_lengths, groups=groups, scale=scale)
    require_cuda("paged_decode_attention", q)
    _check_operands(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                    entry_lengths, groups)
    library, function = entry(
        "paged_decode_attention", "aiko_paged_decode_attention",
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] +
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    out = torch.empty((slots_n, num_kv, gw, head_dim), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = function(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), tables.stride(0),
            k_side.data_ptr(), v_side.data_ptr(), side_valid.data_ptr(),
            entry_lengths.data_ptr(), out.data_ptr(), slots_n, num_kv, gw,
            gw // groups, tables.shape[1], k_pool.shape[2], k_side.shape[2],
            head_dim, float(scale), stream)
    launches["paged_decode_attention"] += 1
    check(library, "paged_decode_attention", code)
    return out
