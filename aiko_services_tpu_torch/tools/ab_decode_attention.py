# A/B harness: the console comparison table is the product
# graft: disable-file=lint-print
# A/B the decode-attention inner loop IN-PROGRAM, on the round steps the
# port's ContinuousDecoder runs (serving._round_step_for): the select KV
# write's two_pass (score/weight products) vs online (one flash-style
# sweep) vs vpu (broadcast-multiply reductions), the block KV write, and
# the paged pair: the paged step with the plain gather version of the
# paged kernel bound in this process vs the CUDA kernel.  The port's copy
# of tools/ab_decode_attention.py, at its defaults.  Microbenchmark wins
# do not survive program context, so the number that counts is the
# chained full-step time at the serving shape: ms a decode step, 64 steps
# a round, chains of 4 rounds, best of 3 (tools/timing.py).
#
# Before the paged pair is timed, every paged-kernel call of two short
# rounds at the timed shape is held against its plain version computed
# in f32 on the same operands, with chip_smoke.py's tolerance for the
# path the kernel takes (ops/paged_attention.py TOLERANCE).  The check
# fills the pools with seeded values and gives each slot its own token
# and its own length, staggered over the whole table and past it, so a
# kernel that reads another slot's table row, the wrong block or one
# position too many or too few disagrees.  Any case that raises is
# reported and fails the run (exit 1).
#
#   python -m aiko_services_tpu_torch.tools.ab_decode_attention \
#       [preset] [slots] [cache_t]
#
# On the card only (the default device); the functions take device="cpu"
# for the tests, where both paged cases run the plain version.

from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

from .timing import timed_chain

__all__ = ["measure", "measure_paged", "check_paged", "cases", "main"]

def _decode_config(preset: str):
    from ..models.llama import LLAMA_PRESETS
    return dataclasses.replace(LLAMA_PRESETS[preset], dtype=torch.bfloat16,
                               max_seq_len=1024)


def _params(config, device):
    from ..models.llama import llama_init
    return llama_init(torch.Generator(device=device).manual_seed(0),
                      config, device=device)


def _slot_state(slots: int, device) -> tuple:
    return (torch.ones((slots,), dtype=torch.int32, device=device),
            torch.zeros((slots,), dtype=torch.int32, device=device),
            torch.ones((slots,), dtype=torch.bool, device=device),
            torch.full((slots,), 1 << 30, dtype=torch.int32, device=device))


def _time_rounds(round_fn, device, chains: int, num_steps: int) -> float:
    """ms a step: one warm-up round, then the best of 3 chains of
    `chains` rounds."""
    seconds = timed_chain(round_fn, device, chain=chains, repeats=3,
                          reduce=min)
    return seconds * 1000.0 / num_steps


def measure(impl: str, preset: str, slots: int, cache_t: int,
            num_steps: int = 64, chains: int = 4,
            kv_write: str = "select", device=None) -> float:
    """Chained dense-step time, ms a step, in the `kv_write` KV write
    with the `impl` inner loop (the block write has one inner loop)."""
    from .. import resolve_device
    from ..serving import _round_step_for

    device = resolve_device(device)
    config = _decode_config(preset)
    params = _params(config, device)
    step = _round_step_for(config, False, 0, 0, device, kv_write, impl)
    shape = (slots, config.num_kv_heads, cache_t, config.head_dim)
    k = [torch.zeros(shape, dtype=config.dtype, device=device)
         for _ in range(config.num_layers)]
    v = [torch.zeros_like(cache) for cache in k]
    tokens, lengths, active, budgets = _slot_state(slots, device)

    def one_round():
        nonlocal tokens, lengths
        out = step(params, tokens, lengths, active, budgets, k, v,
                   num_steps=num_steps, eos=-1)
        tokens, lengths = out[2], out[3]

    with torch.no_grad():
        return _time_rounds(one_round, device, chains, num_steps)


def _gather_attention(q, k_pool, v_pool, tables, k_side, v_side,
                      side_valid, entry_lengths, *, groups: int,
                      scale: float | None = None, fold_scales: bool = True):
    """The paged step's attention call answered by the kernel's plain
    version (a gather of the table's blocks) on any device."""
    from ..ops import paged_attention as P
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    return P.paged_decode_attention_reference(
        q, k_pool, v_pool, tables, k_side, v_side, side_valid,
        entry_lengths, groups=groups, scale=scale, fold_scales=fold_scales)


@contextlib.contextmanager
def _bound_attention(function):
    """Bind `function` as the paged step's attention call (the step
    imports ops.paged_attention._paged_decode_attention at call time)
    for the length of the block, in this process only."""
    from ..ops import paged_attention as P
    kept = P._paged_decode_attention
    P._paged_decode_attention = function
    try:
        yield
    finally:
        P._paged_decode_attention = kept


def _paged_state(preset: str, slots: int, cache_t: int, block_tokens: int,
                 device) -> tuple:
    """The paged round's config, weights, zeroed pools and tables: block
    0 is the pool's null block, each slot owns a contiguous run."""
    config = _decode_config(preset)
    params = _params(config, device)
    nb = -(-cache_t // block_tokens)
    pool_shape = (1 + slots * nb, config.num_kv_heads, block_tokens,
                  config.head_dim)
    k = [torch.zeros(pool_shape, dtype=config.dtype, device=device)
         for _ in range(config.num_layers)]
    v = [torch.zeros_like(pool) for pool in k]
    tables = (1 + torch.arange(slots * nb, dtype=torch.int32,
                               device=device)).reshape(slots, nb)
    return config, params, k, v, tables


def _paged_round(config, params, k, v, tables, slots: int, cache_t: int,
                 num_steps: int, device):
    """A callable running one paged round, carrying tokens and lengths
    on from round to round, as the decode A/B does."""
    from ..serving import _round_step_for
    step = _round_step_for(config, True, 0, 0, device)
    tokens, lengths, active, budgets = _slot_state(slots, device)

    def one_round():
        nonlocal tokens, lengths
        out = step(params, tokens, lengths, active, budgets, k, v, tables,
                   num_steps=num_steps, eos=-1, t_cap=cache_t)
        tokens, lengths = out[2], out[3]

    return one_round


def measure_paged(kernel: bool, preset: str, slots: int, cache_t: int,
                  num_steps: int = 64, chains: int = 4,
                  block_tokens: int = 32, device=None) -> float:
    """Chained paged-step time, ms a step: the plain gather version
    (kernel False) or the CUDA kernel reading the pool's blocks through
    the table."""
    from .. import resolve_device
    from ..ops.paged_attention import prepare_paged_kernel

    device = resolve_device(device)
    config, params, k, v, tables = _paged_state(preset, slots, cache_t,
                                                block_tokens, device)
    if kernel and device.type == "cuda":
        prepare_paged_kernel(config.dtype, config.head_dim)
    one_round = _paged_round(config, params, k, v, tables, slots, cache_t,
                             num_steps, device)
    binding = contextlib.nullcontext() if kernel else \
        _bound_attention(_gather_attention)
    with binding, torch.no_grad():
        return _time_rounds(one_round, device, chains, num_steps)


def _staggered_state(config, slots: int, cache_t: int, span: int,
                     device) -> tuple:
    """Slot state for the check: each slot starts at its own token, and
    the slots' lengths spread evenly from 0 to cache_t + span - 1, so
    they cover every block of the table and the positions past it."""
    index = torch.arange(slots, dtype=torch.int32, device=device)
    tokens = 1 + (index * 131) % (config.vocab - 1)
    lengths = (index * (cache_t + span - 1)) // max(slots - 1, 1)
    return (tokens.to(torch.int32), lengths.to(torch.int32),
            torch.ones((slots,), dtype=torch.bool, device=device),
            torch.full((slots,), 1 << 30, dtype=torch.int32, device=device))


def check_paged(preset: str, slots: int, cache_t: int, num_steps: int = 4,
                block_tokens: int = 32, device=None) -> dict:
    """Two paged rounds of `num_steps` steps at the timed shape (the
    second reads what the first merged into the pool), over pools of
    seeded values with staggered slot lengths (_staggered_state), every
    attention call answered by the kernel and held against the plain
    version run in f32 on the same operands (ops/paged_attention.py
    TOLERANCE for the kernel's path); raises on
    the first call out of tolerance.  Returns the calls held, the worst
    errors and the largest entry length read.  On the CPU the call is
    the plain version itself, held with the tensor-core path's
    tolerance (bf16 probabilities)."""
    from .. import resolve_device
    from ..ops import paged_attention as P
    from ..serving import _round_step_for

    device = resolve_device(device)
    config, params, k, v, tables = _paged_state(preset, slots, cache_t,
                                                block_tokens, device)
    generator = torch.Generator(device=device).manual_seed(5)
    for pool in k + v:
        pool.copy_(torch.randn(pool.shape, generator=generator,
                               device=device, dtype=torch.float32))
    if device.type == "cuda":
        P.prepare_paged_kernel(config.dtype, config.head_dim)
    kernel = P._paged_decode_attention
    held = {"calls": 0, "max_abs_err": 0.0, "rel_l2": 0.0,
            "bound_ratio": 0.0, "max_entry_length": 0}

    def holding(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                entry_lengths, *, groups, scale=None, fold_scales=True):
        out = kernel(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                     entry_lengths, groups=groups, scale=scale,
                     fold_scales=fold_scales)

        def plain(v_main, v_s):
            return _gather_attention(
                q.float(), k_pool.float(), v_main, tables, k_side.float(),
                v_s, side_valid, entry_lengths, groups=groups, scale=scale)

        path = P.kernel_plan(q.dtype == torch.bfloat16, q.shape[0],
                             q.shape[1], q.shape[2], 1, 1)[0] \
            if q.device.type == "cuda" else P.TENSOR_PATH
        c, rel_l2_limit = P.TOLERANCE[path]
        ref = plain(v_pool.float(), v_side.float())
        magnitude = plain(v_pool.float().abs(), v_side.float().abs())
        err = (out.float() - ref).abs()
        rel_l2 = (err.norm() / ref.norm().clamp_min(1e-30)).item()
        ratio = (err / (c * magnitude).clamp_min(1e-30)).max().item()
        if not torch.isfinite(out).all() or ratio > 1.0 or \
                rel_l2 > rel_l2_limit:
            raise AssertionError(
                f"paged kernel disagrees with its plain version at "
                f"{tuple(q.shape)}: max abs err {err.max().item()}, error "
                f"/ bound {ratio}, relative L2 {rel_l2}")
        held["calls"] += 1
        held["max_abs_err"] = max(held["max_abs_err"], err.max().item())
        held["rel_l2"] = max(held["rel_l2"], rel_l2)
        held["bound_ratio"] = max(held["bound_ratio"], ratio)
        held["max_entry_length"] = max(held["max_entry_length"],
                                       int(entry_lengths.max()))
        return out

    step = _round_step_for(config, True, 0, 0, device)
    tokens, lengths, active, budgets = _staggered_state(
        config, slots, cache_t, 2 * num_steps, device)
    with _bound_attention(holding), torch.no_grad():
        for _ in range(2):
            out = step(params, tokens, lengths, active, budgets, k, v,
                       tables, num_steps=num_steps, eos=-1, t_cap=cache_t)
            tokens, lengths = out[2], out[3]
    return held


def cases(preset: str, slots: int, cache_t: int, device=None,
          **timing) -> list:
    """(label, callable) for the six cases, in the repo tool's order;
    `timing` (num_steps, chains) passes to every case."""
    return [
        ("two_pass/select",
         lambda: measure("two_pass", preset, slots, cache_t,
                         device=device, **timing)),
        ("online/select",
         lambda: measure("online", preset, slots, cache_t,
                         device=device, **timing)),
        ("vpu/select",
         lambda: measure("vpu", preset, slots, cache_t, device=device,
                         **timing)),
        ("two_pass/block",
         lambda: measure("two_pass", preset, slots, cache_t,
                         kv_write="block", device=device, **timing)),
        ("paged/gather",
         lambda: measure_paged(False, preset, slots, cache_t,
                               device=device, **timing)),
        ("paged/kernel",
         lambda: measure_paged(True, preset, slots, cache_t,
                               device=device, **timing)),
    ]


def run(cases_to_run, preset: str, slots: int, cache_t: int,
        device_name: str) -> list:
    """Run each case, printing one row a case; returns the failed
    labels."""
    failed = []
    for label, case in cases_to_run:
        try:
            ms = case()
            print(f"{label:17s}: {ms:.3f} ms/step "
                  f"({preset}, {slots} slots, cache {cache_t}, "
                  f"{device_name})", flush=True)
        except Exception as exc:
            print(f"{label:17s}: FAILED {exc!r}", flush=True)
            failed.append(label)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return failed


def main(argv=None, device=None) -> int:
    from .. import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    preset = argv[0] if len(argv) > 0 else "1b"
    slots = int(argv[1]) if len(argv) > 1 else 256
    cache_t = int(argv[2]) if len(argv) > 2 else 256
    device = resolve_device(device)
    device_name = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    to_run = cases(preset, slots, cache_t, device=device)
    failed = []
    try:
        held = check_paged(preset, slots, cache_t, device=device)
        print(f"paged/kernel held against paged/gather: {held['calls']} "
              f"calls, entry lengths to {held['max_entry_length']}, max "
              f"abs err {held['max_abs_err']:.3g}, relative L2 "
              f"{held['rel_l2']:.3g}, error / bound "
              f"{held['bound_ratio']:.3g}", flush=True)
    except Exception as exc:
        print(f"paged/check      : FAILED {exc!r}", flush=True)
        failed.append("paged/check")
        # the paged pair is not timed against a kernel that disagrees
        to_run = to_run[:4]
    failed += run(to_run, preset, slots, cache_t, device_name)
    if failed:
        print(f"FAILED cases: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
