# Fused attention: the CUDA flash-attention kernel for long sequences,
# plain attention otherwise, and the decode-time cross-attention kernel.
#
# Counterpart of aiko_services_tpu/ops/attention.py.  Each kernel has a
# wrapper (checks, output allocation, launch on the current stream) and
# a plain PyTorch version of the same function beside it.  A wrapper
# takes its plain version only for tensors on the CPU; for a CUDA tensor
# it launches its kernel or raises.  The kernels' sources are
# csrc/flash_attention.cu and csrc/cross_decode_attention.cu.

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .kernels import check, entry, prepare, refuse_grad, require_cuda

__all__ = ["flash_attention", "flash_attention_reference", "attention",
           "cross_decode_attention", "cross_decode_attention_reference",
           "cross_decode_plan", "FLASH_MIN_SEQ", "dispatch_stats",
           "launches"]

# The dispatcher keeps the JAX package's rule, so the port runs its
# kernel exactly where the reference runs its Pallas kernel.
FLASH_MIN_SEQ = 1024

# which implementation the dispatcher chose, per call
dispatch_stats = {"flash": 0, "xla": 0}
# kernel launches, counted by each wrapper where it launches its kernel
launches = {"flash_attention": 0, "cross_decode_attention": 0}

# the kernels are built for head dim 64, that of every Whisper size
_KERNEL_HEAD_DIM = 64
# the cross-decode kernel's split over T: as many splits per (batch,
# head) as fill one wave of _CROSS_BLOCKS_PER_SM blocks (the kernel's
# residency) on every multiprocessor, each a multiple of 32 positions
_CROSS_BLOCKS_PER_SM, _CROSS_SPLIT_ALIGN = 6, 32
_CROSS_PARTIAL_FLOATS = _KERNEL_HEAD_DIM + 2    # weighted sums, max, sum


def _check_cuda_operands(name: str, tensors, head_dim: int) -> None:
    device = tensors[0].device
    for tensor in tensors:
        if tensor.device != device:
            raise ValueError(f"{name}: operands on {tensor.device} and "
                             f"{device}")
        if tensor.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{tensor.dtype}")
        # 16-byte vector loads: unit last stride, every row start aligned
        if tensor.stride(-1) != 1 or tensor.data_ptr() % 16 or \
                any(stride % 8 for stride in tensor.stride()[:-1]):
            raise ValueError(f"{name}: operand needs unit stride on the "
                             f"last axis and 16-byte aligned rows, got "
                             f"strides {tensor.stride()}")
    if head_dim != _KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dim "
                         f"{_KERNEL_HEAD_DIM}, got {head_dim}")


# -- flash attention ---------------------------------------------------------

def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: float | None = None):
    """Plain version of the flash kernel, in f32: full softmax, the
    causal mask, and the l == 0 guard (a row with no visible key is 0).
    q, k, v: [B, H, S, D] → [B, H, S, D] in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        positions = torch.arange(q.shape[2], device=q.device)
        scores = scores.masked_fill(positions[None, :] > positions[:, None],
                                    float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (torch.matmul(p, v.float()) / l).to(q.dtype)


def flash_attention(q, k, v, causal: bool = False,
                    scale: float | None = None, block_q: int = 128,
                    block_k: int = 128):
    """Fused attention.  q, k, v: [B, H, S, D] → [B, H, S, D].

    S must divide by block_q and block_k (as for the Pallas kernel).  On
    the card the kernel takes bf16 with D = 64 and S a multiple of its
    64-row tile; the output is a [B, S, H, D] buffer viewed as
    [B, H, S, D], so merging heads afterwards costs no copy."""
    b, h, s, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"sequence {s} not divisible by blocks "
                         f"({block_q}, {block_k})")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale)
    require_cuda("flash_attention", q)
    refuse_grad("flash_attention", q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} differ")
    if s % 64:
        raise ValueError(f"sequence {s} not divisible by the kernel's "
                         f"64-row tile")
    if not scale > 0:
        raise ValueError(f"flash_attention: the CUDA kernel takes a "
                         f"positive scale, got {scale}")
    _check_cuda_operands("flash_attention", (q, k, v), d)
    prepare(("flash_attention",))        # built at the first call
    library, function = entry(
        "flash_attention", "aiko_flash_attention_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in (0, 1, 2)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = function(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, s, d, strides, float(scale), int(bool(causal)), stream)
    launches["flash_attention"] += 1
    check(library, "flash_attention", code)
    return out


def attention(q, k, v, causal: bool = False, scale: float | None = None):
    """Dispatch: the flash kernel for long sequences that tile
    (s >= FLASH_MIN_SEQ, s % 128 == 0, d % 64 == 0), plain attention
    otherwise — the JAX package's rule, applied on every device."""
    s, d = q.shape[2], q.shape[3]
    if s >= FLASH_MIN_SEQ and s % 128 == 0 and d % 64 == 0:
        dispatch_stats["flash"] += 1
        return flash_attention(q, k, v, causal=causal, scale=scale)
    dispatch_stats["xla"] += 1
    from ..parallel.ring_attention import attention_reference
    return attention_reference(q, k, v, causal=causal, scale=scale)


# -- decode-time cross attention --------------------------------------------

def cross_decode_attention_reference(q, k, v, scale: float | None = None):
    """Plain version of the cross-decode kernel, in f32: T padded to a
    multiple of 128 with the padding masked, then a plain softmax.
    q [B, H, 1, D], k/v [B, H, T, D] → [B, H, 1, D] in q's dtype."""
    t = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    t_pad = -(-t // 128) * 128
    pad = (0, 0, 0, t_pad - t)
    k = torch.nn.functional.pad(k.float(), pad)
    v = torch.nn.functional.pad(v.float(), pad)
    scores = torch.matmul(q.float(), k.transpose(-1, -2)) * scale
    valid = torch.arange(t_pad, device=q.device) < t
    scores = scores.masked_fill(~valid, float("-inf"))
    # t >= 1, so the max is finite and the padding's exp is exactly 0
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return (torch.matmul(p, v) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def cross_decode_plan(batch: int, heads: int, t_len: int,
                      multiprocessors: int) -> tuple[int, int]:
    """How the CUDA kernel splits one call over T, from host-known shapes
    only: (positions per split, splits).  One block per (batch, head,
    split) streams its positions and writes a partial; a second kernel
    merges the splits of each (batch, head).  The splits are as many as
    one wave of blocks takes, so every multiprocessor has its share of
    the loads in flight at once; every split holds at least one
    position."""
    splits = max(1, _CROSS_BLOCKS_PER_SM * multiprocessors //
                 (batch * heads))
    split = -(-t_len // splits)
    split = -(-split // _CROSS_SPLIT_ALIGN) * _CROSS_SPLIT_ALIGN
    return split, -(-t_len // split)


@functools.cache
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cross_decode_attention(q, k, v, scale: float | None = None):
    """Decode-time cross attention: q [B, H, 1, D], k/v [B, H, T, D]
    (precomputed, read-only) → [B, H, 1, D].

    Kept beside its plain version and tested, but not dispatched — as in
    the JAX package, the Whisper decode tail runs layers.mha's einsum
    branch."""
    b, h, q_len, d = q.shape
    t = k.shape[2]
    if q_len != 1:
        raise ValueError(f"decode kernel needs q_len 1, got {q_len}")
    if t < 1:
        raise ValueError("cross_decode_attention: empty K/V")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return cross_decode_attention_reference(q, k, v, scale=scale)
    require_cuda("cross_decode_attention", q)
    refuse_grad("cross_decode_attention", q, k, v)
    if k.shape != (b, h, t, d) or v.shape != k.shape:
        raise ValueError(f"cross_decode_attention: k/v shapes "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    _check_cuda_operands("cross_decode_attention", (q, k, v), d)
    prepare(("cross_decode_attention",))     # built at the first call
    library, function = entry(
        "cross_decode_attention", "aiko_cross_decode_attention_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_void_p])
    split, splits = cross_decode_plan(b, h, t,
                                      _multiprocessors(q.device.index))
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    partials = torch.empty(b * h * splits * _CROSS_PARTIAL_FLOATS,
                           dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = function(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), partials.data_ptr(), b, h, t, d,
                        split, splits, strides, float(scale), stream)
    launches["cross_decode_attention"] += 1
    check(library, "cross_decode_attention", code)
    return out
