# diagnostic harness: the console readout is the product
# graft: disable-file=lint-print
# Which decode-attention pattern reaches this card's real read ceiling,
# and what do the port's two decode kernels reach at the same shapes?
# The port's copy of tools/diag_attn_patterns.py.
#
# Each pattern runs as plain torch ops (bf16 operands, scores and the
# softmax in f32, weights back to bf16 for the PV product, as JAX's
# einsums) at TWO rep counts, the attention output fed back as the next
# rep's query, and reports the marginal rate over the K/V bytes a rep
# reads (diag_membw.marginal_rate: CUDA events, two-point fit).  K and V
# are seeded random values (JAX's tool used ones), at least 1 GiB a
# pattern, so the 50 MB L2 serves none of a rep's reads.
#
# Patterns (the ceiling: diag_membw.py, measured first in this run):
#   gqa4   — Llama serving shape: q [S 256, Hkv 8, G 4, D 64] against
#            K/V [256, 8, T 2048, 64]
#   mha1   — Whisper decode shape: q [B 256, H 12, 1, 64] against K/V
#            [256, 12, 2048, 64]
#   mha8   — the Whisper shape with 8 packed queries (is one query row
#            the limiter?)
#   mha1q  — mha1 with int8 K/V, the per-tensor scale folded into the
#            scores and the output.  Eager torch converts int8 → bf16 in
#            a pass of its own (it writes and rereads the bf16 copy),
#            where XLA fuses the convert into the dot: the rate is still
#            over the int8 bytes, as JAX's
# and two rows for the port's own kernels at two of those shapes:
#   gqa4/kernel — ops/paged_attention.paged_decode_attention over a pool
#            of 32-token blocks holding the same K/V through a block
#            table (the null block first, an empty side buffer)
#   mha1/kernel — ops/attention.cross_decode_attention
# Before a kernel row is timed, the kernel's output is held against its
# plain version run in f32 on the same operands, to chip_smoke.py's
# limits (the paged split path: c = 2^-12, relative L2 1e-4; the
# tensor-core path 2^-8, 3e-3; cross-decode: u = 2^-8, c = 2^-12,
# relative L2 0.004).  A failed check is reported and the tool exits 1;
# the row is not timed.
#
#   python -m aiko_services_tpu_torch.tools.diag_attn_patterns
#
# On the card only (the default device); the functions take
# device="cpu" and smaller shapes for the tests, where the kernel rows
# run the plain versions.

from __future__ import annotations

import math
import sys

import torch

from .diag_membw import (REPS_HI, REPS_LO, SPEC_BYTES_PER_S, device_line,
                         marginal_rate)

__all__ = ["GQA", "MHA", "attend", "pattern", "paged_operands",
           "check_paged", "check_cross", "run", "main"]

GQA = {"slots": 256, "kv_heads": 8, "groups": 4, "head_dim": 64,
       "t": 2048, "block": 32}
MHA = {"batch": 256, "heads": 12, "head_dim": 64, "t": 2048}
INT8_SCALE = 1.0 / 127.0


def attend(q, k, v, k_scale=None, v_scale=None):
    """softmax(q kᵀ / √D) v over the last two axes, q [..., Q, D] and
    k/v [..., T, D]: bf16 operands (int8 K/V converted to bf16), f32
    scores and softmax, bf16 weights, the output in bf16.  k_scale /
    v_scale fold a per-tensor int8 scale into the scores and output."""
    kk = k.to(torch.bfloat16) if k.dtype == torch.int8 else k
    vv = v.to(torch.bfloat16) if v.dtype == torch.int8 else v
    scores = torch.matmul(q, kk.transpose(-1, -2)).float() * \
        (1.0 / math.sqrt(q.shape[-1]))
    if k_scale is not None:
        scores = scores * k_scale
    weights = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    out = torch.matmul(weights, vv).float()
    if v_scale is not None:
        out = out * v_scale
    return out.to(torch.bfloat16)


def pattern(step, q0):
    """build(reps) for a chain of `reps` calls of step(q), each call's
    output the next call's query."""
    def build(reps):
        def run():
            q = q0
            for _ in range(reps):
                q = step(q)
            return q
        return run
    return build


def _randn(generator, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=generator,
                       device=generator.device,
                       dtype=torch.float32).to(dtype)


def paged_operands(k, v, block: int):
    """The paged kernel's operands holding K/V [S, Hkv, T, D]: pools
    [1 + S * T / block, Hkv, block, D] (block 0 the null block), tables
    [S, T / block], an empty (all-masked) side buffer of one entry and
    every slot's extent T."""
    slots, kv_heads, t, head_dim = k.shape
    nb = t // block

    def pool(x):
        blocks = x.reshape(slots, kv_heads, nb, block, head_dim) \
            .permute(0, 2, 1, 3, 4).reshape(slots * nb, kv_heads, block,
                                             head_dim)
        return torch.cat([torch.zeros_like(blocks[:1]), blocks])

    device = k.device
    tables = (1 + torch.arange(slots * nb, dtype=torch.int32,
                               device=device)).reshape(slots, nb)
    side = torch.zeros((slots, kv_heads, 1, head_dim), dtype=k.dtype,
                       device=device)
    return (pool(k), pool(v), tables, side, side.clone(),
            torch.zeros((slots, 1, 1), dtype=torch.bool, device=device),
            torch.full((slots,), t, dtype=torch.int32, device=device))


def _held(out, ref, magnitude, u, c, rel_l2_limit, label) -> dict:
    err = (out.float() - ref).abs()
    rel_l2 = (err.norm() / ref.norm().clamp_min(1e-30)).item()
    ratio = (err / (u * ref.abs() + c * magnitude).clamp_min(1e-30)) \
        .max().item()
    if not bool(torch.isfinite(out).all()) or ratio > 1.0 or \
            rel_l2 > rel_l2_limit:
        raise AssertionError(
            f"{label} disagrees with its plain version: max abs err "
            f"{err.max().item()}, error / bound {ratio}, relative L2 "
            f"{rel_l2} (limit {rel_l2_limit})")
    return {"max_abs_err": err.max().item(), "rel_l2": rel_l2,
            "rel_l2_limit": rel_l2_limit, "bound_ratio": ratio}


def check_paged(q, operands, groups: int, kernel=None) -> dict:
    """The paged kernel (or `kernel`, a function of the same signature)
    on q [S, Hkv, G, D] against its plain version in f32 on the same
    operands, within ops/paged_attention.py TOLERANCE for the path the
    kernel takes; raises outside it."""
    from ..ops import paged_attention as P

    kernel = kernel or P.paged_decode_attention
    k_pool, v_pool, tables, k_side, v_side, side_valid, lengths = operands
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = kernel(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                 lengths, groups=groups, scale=scale)

    def plain(v_main, v_s):
        return P.paged_decode_attention_reference(
            q.float(), k_pool.float(), v_main, tables, k_side.float(), v_s,
            side_valid, lengths, groups=groups, scale=scale)

    path = P.kernel_plan(q.dtype == torch.bfloat16, q.shape[0], q.shape[1],
                         q.shape[2], 1, 1)[0] \
        if q.device.type == "cuda" else P.TENSOR_PATH
    c, rel_l2_limit = P.TOLERANCE[path]
    ref = plain(v_pool.float(), v_side.float())
    magnitude = plain(v_pool.float().abs(), v_side.float().abs())
    return _held(out, ref, magnitude, 0.0, c, rel_l2_limit, "gqa4/kernel")


def check_cross(q, k, v, kernel=None) -> dict:
    """The cross-decode kernel (or `kernel`) on q [B, H, 1, D] against
    its plain version in f32 on the same operands, within
    ops/attention.py CROSS_TOLERANCE; raises outside it."""
    from ..ops import attention as A

    kernel = kernel or A.cross_decode_attention
    out = kernel(q, k, v)
    ref = A.cross_decode_attention_reference(q.float(), k.float(),
                                             v.float())
    magnitude = A.cross_decode_attention_reference(q.float(), k.float(),
                                                   v.float().abs())
    return _held(out, ref, magnitude, *A.CROSS_TOLERANCE, "mha1/kernel")


def run(device=None, gqa=None, mha=None, ceiling_gbps=None,
        repeats: int = 5, reps=(REPS_LO, REPS_HI)) -> dict:
    """Every row: {name: marginal_rate's row + "of_ceiling"}, the kernel
    checks under "checks" and the failed labels under "failed"."""
    from .. import resolve_device
    from ..ops import attention as A
    from ..ops import paged_attention as P
    from .diag_membw import measure

    device = resolve_device(device)
    gqa, mha = gqa or GQA, mha or MHA
    if ceiling_gbps is None:
        ceiling_gbps = measure(device, repeats=repeats,
                               reps=reps)["ceiling_gbps"]
    generator = torch.Generator(device=device).manual_seed(0)
    rows, checks, failed = {}, {}, []

    def row(name, build, nbytes):
        result = marginal_rate(name, build, nbytes, device, repeats, reps)
        result["of_ceiling"] = result["gbps"] / ceiling_gbps
        print(f"{'':12s} {result['of_ceiling']:.1%} of the measured "
              f"ceiling {ceiling_gbps:.1f} GB/s", flush=True)
        rows[name] = result

    s, hkv, g, d, t = (gqa[key] for key in
                       ("slots", "kv_heads", "groups", "head_dim", "t"))
    k, v = _randn(generator, (s, hkv, t, d)), _randn(generator, (s, hkv, t, d))
    q0 = _randn(generator, (s, hkv, g, d))
    kv_bytes = 2 * k.numel() * k.element_size()
    with torch.no_grad():
        row("gqa4", pattern(lambda q: attend(q, k, v), q0), kv_bytes)
        operands = paged_operands(k, v, gqa["block"])
        del k, v
        try:
            if device.type == "cuda":
                P.prepare_paged_kernel(torch.bfloat16, d)
            checks["gqa4/kernel"] = check_paged(q0, operands, g)
            row("gqa4/kernel", pattern(
                lambda q: P.paged_decode_attention(
                    q, *operands, groups=g,
                    scale=1.0 / math.sqrt(d)).to(torch.bfloat16), q0),
                kv_bytes)
        except Exception as exc:
            print(f"gqa4/kernel  FAILED {exc!r}", flush=True)
            failed.append("gqa4/kernel")
        del operands

        b, h, d, t = (mha[key] for key in ("batch", "heads", "head_dim",
                                           "t"))
        k, v = _randn(generator, (b, h, t, d)), _randn(generator, (b, h, t, d))
        kv_bytes = 2 * k.numel() * k.element_size()
        for num_q in (1, 8):
            q0 = _randn(generator, (b, h, num_q, d))
            row(f"mha{num_q}", pattern(lambda q: attend(q, k, v), q0),
                kv_bytes)
        q0 = _randn(generator, (b, h, 1, d))
        try:
            checks["mha1/kernel"] = check_cross(q0, k, v)
            row("mha1/kernel", pattern(
                lambda q: A.cross_decode_attention(q, k, v), q0), kv_bytes)
        except Exception as exc:
            print(f"mha1/kernel  FAILED {exc!r}", flush=True)
            failed.append("mha1/kernel")
        del k, v
        ki = torch.randint(-127, 128, (b, h, t, d), generator=generator,
                           device=device, dtype=torch.int8)
        vi = torch.randint(-127, 128, (b, h, t, d), generator=generator,
                           device=device, dtype=torch.int8)
        row("mha1q", pattern(lambda q: attend(q, ki, vi, INT8_SCALE,
                                              INT8_SCALE), q0),
            2 * ki.numel())
        del ki, vi
    if device.type == "cuda":
        torch.cuda.empty_cache()
    over = [name for name, result in rows.items()
            if result["gbps"] * 1e9 > SPEC_BYTES_PER_S]
    if over:
        print(f"FAILED: {', '.join(over)} read over the data sheet's "
              f"3.35 TB/s (the L2 served it)", flush=True)
        failed += over
    return {"rows": rows, "checks": checks, "failed": failed,
            "ceiling_gbps": ceiling_gbps}


def main(argv=None, device=None) -> int:
    from .. import resolve_device

    device = resolve_device(device)
    print(device_line(device), flush=True)
    result = run(device)
    for name, check in result["checks"].items():
        print(f"{name} held against its plain version: max abs err "
              f"{check['max_abs_err']:.3g}, relative L2 "
              f"{check['rel_l2']:.3g} (limit {check['rel_l2_limit']}), "
              f"error / bound {check['bound_ratio']:.3g}", flush=True)
    if result["failed"]:
        print(f"FAILED rows: {', '.join(result['failed'])}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
