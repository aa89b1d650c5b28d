# ComputeRuntime: the port's execution backend service on one CUDA card.
#
# Counterpart of aiko_services_tpu/compute.py: an Actor (protocol
# "compute") that hosts a table of programs ("fn(bucket, batch) ->
# results") behind BatchingSchedulers driven off its process's event
# engine, so frames from many streams coalesce into batches of one padded
# shape.  Its EC share carries the device (count, platform, kind, memory
# occupancy), the program count and each bucket's first-call seconds, so
# dashboards see device health.  PyTorch runs eagerly, so a program is a
# plain callable; split() is where the host waits for the device.  The
# pipelined results worker (a batch's device sync on a worker thread) is
# not ported yet.

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from . import resolve_device
from .actor import Actor
from .observe.metrics import default_registry
from .ops.batching import BatchingScheduler, ShapeBuckets
from .service import ServiceProtocol
from .utils import get_logger

__all__ = ["ComputeRuntime", "CompiledProgram", "PROTOCOL_COMPUTE",
           "resolve_pipelined", "PIPELINED_NOT_PORTED"]

PROTOCOL_COMPUTE = ServiceProtocol("compute")
PIPELINED_NOT_PORTED = ("pipelined results (pipelined=True) are not ported "
                        "yet (ROADMAP.md Queue 1 item 2)")


def resolve_pipelined(pipelined, mode: str) -> bool:
    """Pipelined results complete on a LATER event-loop turn; a sync
    caller blocking on scheduler.drain(force=True) would hang forever.
    Every element that exposes both knobs must route them through here."""
    return bool(pipelined) and mode != "sync"


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


class ComputeRuntime(Actor):
    """Hosts programs on one device and schedules their batches.

    device=None means the CUDA card (raises when there is none);
    device="cpu" runs the same programs on the CPU.  Batched programs'
    schedulers read the engine clock and are drained by an engine timer
    every `drive_period` seconds."""

    def __init__(self, runtime, name: str = "compute", device=None,
                 drive_period: float = 0.005):
        # resolve first: a runtime without the card must not register a
        # service that cannot run anything
        self.device = resolve_device(device)
        share = {"device_count": 0, "program_count": 0}
        super().__init__(runtime, name, PROTOCOL_COMPUTE, share=share)
        self.logger = get_logger(f"compute.{name}")
        self.drive_period = drive_period
        self.programs: dict[str, CompiledProgram] = {}
        self._timers: list[int] = []
        on_card = self.device.type == "cuda"
        self.device_kind = torch.cuda.get_device_name(self.device) \
            if on_card else "cpu"
        self.memory_free = self.memory_total = None
        self.ec_producer.update("device_count", 1)
        self.ec_producer.update("platform", "gpu" if on_card else "cpu")
        self.ec_producer.update("device_kind", self.device_kind)
        self.refresh_device_health()
        # keep device health LIVE: dashboards must see memory pressure
        # building, not a boot-time snapshot
        self._timers.append(runtime.event.add_timer_handler(
            self.refresh_device_health, period=10.0))

    def refresh_device_health(self) -> None:
        """Read the card's free and total memory (bytes) and publish its
        occupancy as device.0.mem_pct; the CPU reports no such figures
        (memory_free None, mem_pct -1)."""
        value = -1
        if self.device.type == "cuda":
            self.memory_free, self.memory_total = \
                torch.cuda.mem_get_info(self.device)
            value = round(100.0 * (self.memory_total - self.memory_free)
                          / self.memory_total, 1)
        # dedup: EC updates fan out to every leaseholder — no-op
        # republishes every 10 s would spam each consumer forever
        if self.ec_producer.get("device.0.mem_pct") != value:
            self.ec_producer.update("device.0.mem_pct", value)

    # -- direct (unbatched) programs ---------------------------------------
    def register_program(self, name: str, fn) -> None:
        """Register a callable for direct invocation via run()."""
        self.programs[name] = CompiledProgram(name, fn, None, None, {})
        self.ec_producer.update("program_count", len(self.programs))

    def run(self, name: str, *args):
        program = self.programs[name]
        start = time.perf_counter()
        result = program.fn(*args)
        program.first_call_times.setdefault("direct",
                                            time.perf_counter() - start)
        return result

    # -- batched programs ---------------------------------------------------
    def register_batched(self, name: str, fn, buckets, collate, split,
                         max_batch: int = 32, max_wait: float = 0.05,
                         pipelined: bool = False) -> BatchingScheduler:
        """Register a batched program.

        fn(bucket, batch) -> batch_results;
        collate(bucket, payloads) -> batch (tensors on self.device);
        split(batch_results, count) -> list of per-item results (where
        the host waits for the device).  Returns the scheduler, attached
        to the runtime's event engine."""
        if pipelined:
            raise NotImplementedError(PIPELINED_NOT_PORTED)

        def process_batch(bucket, items):
            payloads = [item.payload for item in items]
            batch = collate(bucket, payloads)
            start = time.perf_counter()
            results = fn(bucket, batch)
            per_item = split(results, len(items))    # device sync
            elapsed = time.perf_counter() - start
            if bucket not in program.first_call_times:
                # the first call carries one-time costs: keep it out of
                # the service estimate, or deadline admission would fire
                # spuriously for the whole warm period
                program.first_call_times[bucket] = elapsed
                self.ec_producer.update(f"first_call.{name}.{bucket}",
                                        round(elapsed, 3))
            else:
                scheduler.observe_service_time(bucket, elapsed)
                program.recent_service.append((bucket, elapsed))
            self._publish_stats(name, scheduler)
            return per_item

        if not isinstance(buckets, ShapeBuckets):
            buckets = ShapeBuckets(buckets)
        scheduler = BatchingScheduler(process_batch, buckets,
                                      max_batch=max_batch,
                                      max_wait=max_wait,
                                      clock=self.runtime.event.clock.now,
                                      metrics_labels={"program": name})
        program = CompiledProgram(name, fn, buckets, scheduler, {})
        self.programs[name] = program
        self._timers.append(scheduler.attach(self.runtime.event,
                                             self.drive_period))
        self.ec_producer.update("program_count", len(self.programs))
        return scheduler

    def submit(self, name: str, stream_id: str, payload, length: int,
               callback, deadline: float | None = None) -> None:
        program = self.programs[name]
        if program.scheduler is None:
            raise ValueError(f"program {name} is not batched")
        program.scheduler.submit(stream_id, payload, length, callback,
                                 deadline=deadline)

    def _publish_stats(self, name: str, scheduler) -> None:
        self.ec_producer.update(f"batch.{name}.batches",
                                scheduler.stats["batches"])
        mean_size = round(scheduler.mean_batch_size(), 2)
        mean_wait_ms = round(scheduler.mean_wait() * 1000.0, 2)
        self.ec_producer.update(f"batch.{name}.mean_size", mean_size)
        self.ec_producer.update(f"batch.{name}.mean_wait_ms",
                                mean_wait_ms)
        registry = default_registry()
        labels = {"program": name}
        registry.gauge("batch_mean_size", "mean dispatched batch size",
                       labels).set(mean_size)
        registry.gauge("batch_mean_wait_ms", "mean batch-former queue wait",
                       labels).set(mean_wait_ms)

    def stop(self) -> None:
        for timer in self._timers:
            self.runtime.event.remove_timer_handler(timer)
        self._timers.clear()
        for program in self.programs.values():
            if program.scheduler is not None:
                program.scheduler.drain(force=True)
        super().stop()
