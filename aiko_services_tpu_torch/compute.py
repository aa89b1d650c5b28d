# ComputeRuntime: the port's execution backend on one CUDA card.
#
# Counterpart of aiko_services_tpu/compute.py: a table of programs
# ("fn(bucket, batch) -> results") behind a BatchingScheduler, so frames
# from many streams coalesce into batches of one padded shape.  The
# batch-processing logic (collate → run → split, first-call times kept
# apart from steady service times) is the JAX package's; the service-time
# feedback that deadline admission reads arrives with deadlines.  PyTorch runs eagerly,
# so a program is a plain callable; split() is where the device
# synchronises.  The Actor base and its EC share, the event-engine timer
# that drives drain(), and the pipelined results worker arrive with the
# host-plane slice; until then the owner calls scheduler.drain().

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from . import resolve_device
from .observe.metrics import default_registry
from .ops.batching import BatchingScheduler, ShapeBuckets

__all__ = ["ComputeRuntime", "CompiledProgram"]


@dataclass
class CompiledProgram:
    name: str
    fn: Callable                  # fn(bucket, batch) -> results
    buckets: ShapeBuckets | None
    scheduler: BatchingScheduler | None
    first_call_times: dict       # bucket -> first-call wall seconds
                                 # (first execution, including one-time
                                 # kernel builds and library warm-up)
    recent_service: Any = field(default_factory=lambda: deque(maxlen=512))
                                 # deque[(bucket, seconds)] after the
                                 # first call


class ComputeRuntime:
    """Hosts programs on one device and schedules their batches.

    device=None means the CUDA card (raises when there is none);
    device="cpu" runs the same programs on the CPU."""

    def __init__(self, name: str = "compute", device=None):
        self.name = name
        self.device = resolve_device(device)
        self.programs: dict[str, CompiledProgram] = {}
        self.device_kind = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        self.memory_free = self.memory_total = None
        self.refresh_device_health()

    def refresh_device_health(self) -> None:
        """Read the card's free and total memory (bytes); None on the
        CPU, which reports no such figures."""
        if self.device.type == "cuda":
            self.memory_free, self.memory_total = \
                torch.cuda.mem_get_info(self.device)

    # -- direct (unbatched) programs ---------------------------------------
    def register_program(self, name: str, fn) -> None:
        """Register a callable for direct invocation via run()."""
        self.programs[name] = CompiledProgram(name, fn, None, None, {})

    def run(self, name: str, *args):
        program = self.programs[name]
        start = time.perf_counter()
        result = program.fn(*args)
        program.first_call_times.setdefault("direct",
                                            time.perf_counter() - start)
        return result

    # -- batched programs ---------------------------------------------------
    def register_batched(self, name: str, fn, buckets, collate, split,
                         max_batch: int = 32,
                         max_wait: float = 0.05) -> BatchingScheduler:
        """Register a batched program.

        fn(bucket, batch) -> batch_results;
        collate(bucket, payloads) -> batch (tensors on self.device);
        split(batch_results, count) -> list of per-item results (where
        the host waits for the device).  Returns the scheduler."""
        def process_batch(bucket, items):
            payloads = [item.payload for item in items]
            batch = collate(bucket, payloads)
            start = time.perf_counter()
            results = fn(bucket, batch)
            per_item = split(results, len(items))    # device sync
            elapsed = time.perf_counter() - start
            if bucket not in program.first_call_times:
                # the first call carries one-time costs: keep it out of
                # the steady service times
                program.first_call_times[bucket] = elapsed
            else:
                program.recent_service.append((bucket, elapsed))
            self._publish_stats(name, scheduler)
            return per_item

        if not isinstance(buckets, ShapeBuckets):
            buckets = ShapeBuckets(buckets)
        scheduler = BatchingScheduler(process_batch, buckets,
                                      max_batch=max_batch,
                                      max_wait=max_wait,
                                      clock=time.monotonic,
                                      metrics_labels={"program": name})
        program = CompiledProgram(name, fn, buckets, scheduler, {})
        self.programs[name] = program
        return scheduler

    def submit(self, name: str, stream_id: str, payload, length: int,
               callback) -> None:
        program = self.programs[name]
        if program.scheduler is None:
            raise ValueError(f"program {name} is not batched")
        program.scheduler.submit(stream_id, payload, length, callback)

    def _publish_stats(self, name: str, scheduler) -> None:
        registry = default_registry()
        labels = {"program": name}
        registry.gauge("batch_mean_size", "mean dispatched batch size",
                       labels).set(round(scheduler.mean_batch_size(), 2))
        registry.gauge("batch_mean_wait_ms", "mean batch-former queue wait",
                       labels).set(round(scheduler.mean_wait() * 1000.0, 2))
