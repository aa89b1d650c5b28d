"""The A/B tools' timer: seconds a call of a chained device program
takes, in place of the repo's tools/diag_membw.py timed_chain.

On the card the chain is bracketed by two CUDA events recorded on the
current stream, as chip_smoke.py's time_ms brackets a kernel: the events
take in every launch of the chain and the card's idle time between them
(an eager program's host launches are part of its step time), and one
synchronize ends each measurement.  On the CPU the host clock brackets
the chain (only the tests run there, at sizes where a time means
nothing)."""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["timed_chain"]


def timed_chain(fn, device, chain: int = 4, repeats: int = 5,
                reduce=statistics.median) -> float:
    """Per-call seconds of `chain` back-to-back calls of fn(), after one
    warm-up call, reduced over `repeats` measurements (the median by
    default; the decode A/B takes min, its best of three)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / chain)
        else:
            begin = time.perf_counter()
            for _ in range(chain):
                fn()
            times.append((time.perf_counter() - begin) / chain)
    return reduce(times)
