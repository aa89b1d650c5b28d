# diagnostic harness: the console readout is the product
# graft: disable-file=lint-print
# What HBM streaming read rate can THIS card actually reach?  The port's
# copy of tools/diag_membw.py.  Every bound in chip_smoke.py divides by
# the H100's data-sheet 3.35 TB/s; "bandwidth-bound" claims mean
# something only against the best ACHIEVABLE rate, which this probe
# measures, and the decode-attention diagnostics
# (diag_attn_patterns.py, diag_whisper_tail.py) divide by it.
#
# Measurement rules on the card:
#   1. Two-point rep fit: every pattern runs at two rep counts (64 and
#      256) and reports the marginal rate
#      bytes * (reps_hi - reps_lo) / (T_hi - T_lo): the launch of the
#      chain and the first call's costs cancel.  Each time brackets the
#      chained device work with CUDA events (timing.timed_chain).
#   2. The L2 (50 MB on the H100) must not serve the reads: each
#      pattern's working set is a seeded random array of at least
#      1 GiB, 20x the L2, and each rep reads all of it.  A rate over the
#      data sheet's 3.35 TB/s means the probe read from the L2.
#   3. Eager torch has no compiler to hoist or fold a read (XLA rewrote
#      sum(x + c) as sum(x) + N*c and hoisted it: the JAX tool's hazard),
#      but each rep still takes the previous rep's result: slicesum's
#      window starts at an offset that moves every rep and its sum joins
#      the carry; matvec's vector is the previous product, scaled.
#
# Patterns:
#   slicesum — f32 sum of a 1 GiB - 512 B window of a 1 GiB bf16 array
#   matvec   — [2^18, 4096] bf16 (2 GiB) @ v, v fed back from the result
#
#   python -m aiko_services_tpu_torch.tools.diag_membw
#
# On the card only (the default device); the functions take
# device="cpu" and smaller sizes for the tests.

from __future__ import annotations

import sys

import torch

from .timing import timed_chain

__all__ = ["REPS_LO", "REPS_HI", "SPEC_BYTES_PER_S", "marginal_rate",
           "slicesum", "matvec", "measure", "main"]

REPS_LO, REPS_HI = 64, 256
SPEC_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SLICE_OFFSETS = 256


def marginal_rate(name: str, build, traffic_bytes_per_rep: float, device,
                  repeats: int = 5, reps=(REPS_LO, REPS_HI)) -> dict:
    """build(reps) → a callable that runs `reps` chained reps on the
    device; each is timed (median of `repeats`, CUDA events on the
    card) and the marginal rate is the bytes of the extra reps over
    their extra time.  Prints one row; returns {"name", "gbps", "lo_ms",
    "hi_ms", "gb_per_rep", "share_of_spec"}."""
    lo, hi = reps
    seconds = {count: timed_chain(build(count), device, chain=1,
                                  repeats=repeats) for count in (lo, hi)}
    dt = seconds[hi] - seconds[lo]
    gbps = traffic_bytes_per_rep * (hi - lo) / dt / 1e9 if dt > 0 \
        else float("inf")
    row = {"name": name, "gbps": gbps, "lo_ms": seconds[lo] * 1e3,
           "hi_ms": seconds[hi] * 1e3,
           "gb_per_rep": traffic_bytes_per_rep / 1e9,
           "share_of_spec": gbps * 1e9 / SPEC_BYTES_PER_S}
    print(f"{name:12s} {gbps:8.1f} GB/s marginal "
          f"({row['share_of_spec']:.1%} of 3.35 TB/s; lo {row['lo_ms']:.2f}"
          f" ms, hi {row['hi_ms']:.2f} ms, {row['gb_per_rep']:.3f} GB/rep)",
          flush=True)
    return row


def slicesum(x):
    """build(reps) for the slicesum pattern over the 1-D array x: rep i
    sums the window of len(x) - SLICE_OFFSETS elements starting at
    37 i mod SLICE_OFFSETS, in f32, into the carry.  Returns (build,
    bytes a rep reads)."""
    window = x.numel() - SLICE_OFFSETS

    def build(reps):
        def run():
            acc = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(reps):
                offset = (37 * i) % SLICE_OFFSETS
                acc = acc + torch.sum(x.narrow(0, offset, window),
                                      dtype=torch.float32)
            return acc
        return run
    return build, window * x.element_size()


def matvec(a, v0):
    """build(reps) for the matvec pattern: v ← (a @ v)[:K] / max|·|,
    reps times (a [M, K], v [K]).  Returns (build, bytes a rep reads)."""
    width = a.shape[1]

    def build(reps):
        def run():
            v = v0
            for _ in range(reps):
                y = torch.mv(a, v).float()[:width]
                v = (y / y.abs().amax().clamp_min(1e-6)).to(a.dtype)
            return v
        return run
    return build, a.numel() * a.element_size() + v0.numel() * 2


def measure(device=None, slice_elements: int = 1 << 29,
            matrix_rows: int = 1 << 18, width: int = 4096,
            repeats: int = 5, reps=(REPS_LO, REPS_HI)) -> dict:
    """Both patterns on seeded random bf16 data: {"slicesum": row,
    "matvec": row, "ceiling_gbps": the larger rate}."""
    from .. import resolve_device

    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((slice_elements,), generator=generator, device=device,
                    dtype=torch.bfloat16)
    build, nbytes = slicesum(x)
    with torch.no_grad():
        rows = {"slicesum": marginal_rate("slicesum", build, nbytes, device,
                                          repeats, reps)}
    del x
    a = torch.randn((matrix_rows, width), generator=generator,
                    device=device, dtype=torch.bfloat16)
    v0 = torch.randn((width,), generator=generator, device=device,
                     dtype=torch.bfloat16)
    build, nbytes = matvec(a, v0)
    with torch.no_grad():
        rows["matvec"] = marginal_rate("matvec", build, nbytes, device,
                                       repeats, reps)
    del a
    rows["ceiling_gbps"] = max(rows["slicesum"]["gbps"],
                               rows["matvec"]["gbps"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def device_line(device) -> str:
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return f"device: {name}"


def main(argv=None, device=None) -> int:
    from .. import resolve_device

    device = resolve_device(device)
    print(device_line(device), flush=True)
    rows = measure(device)
    print(f"ceiling      {rows['ceiling_gbps']:8.1f} GB/s "
          f"({rows['ceiling_gbps'] * 1e9 / SPEC_BYTES_PER_S:.1%} of "
          f"3.35 TB/s)", flush=True)
    over = [name for name in ("slicesum", "matvec")
            if rows[name]["share_of_spec"] > 1.0]
    if over:
        print(f"FAILED: {', '.join(over)} read over the data sheet's "
              f"rate (the L2 served it)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
