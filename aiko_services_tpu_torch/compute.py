# ComputeRuntime: the port's execution backend service on one CUDA card.
#
# Counterpart of aiko_services_tpu/compute.py: an Actor (protocol
# "compute") that hosts a table of programs ("fn(bucket, batch) ->
# results") behind BatchingSchedulers driven off its process's event
# engine, so frames from many streams coalesce into batches of one padded
# shape.  Its EC share carries the device (count, platform, kind, memory
# occupancy), the program count and each bucket's first-call seconds, so
# dashboards see device health.  PyTorch runs eagerly, so a program is a
# plain callable; split() is where the host waits for the device.
#
# Pipelined programs (pipelined=True) move that wait off the event loop:
# the dispatching thread queues the batch's work, then one non-blocking
# device-to-host copy of its results into pinned buffers, and records a
# CUDA event after it; a worker thread waits on the event (the wait
# releases the GIL), runs split() on the host copies and hands the
# results back through the engine's event queue.  Batch N+1 collates and
# uploads while batch N computes; a dispatch gate bounds the batches in
# flight at max_in_flight.

from __future__ import annotations

import pickle
import queue
import threading
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
           "resolve_pipelined"]

PROTOCOL_COMPUTE = ServiceProtocol("compute")


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
    in_flight: dict | None = None   # pipelined: {"now": N, "peak": N}


def _to_host(results, device: torch.device):
    """A program's results (a tensor, or a tuple or list of them) →
    (host copies, the CUDA event recorded after the copies, or None).
    On the card each tensor is copied with non_blocking=True into a
    pinned buffer: the host does not wait, and the copies are valid
    once the event has fired."""
    if device.type != "cuda":
        return results, None

    def copy(value):
        if isinstance(value, torch.Tensor):
            if value.device.type != "cuda":
                return value
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            return host.copy_(value, non_blocking=True)
        if isinstance(value, (tuple, list)):
            return type(value)(copy(v) for v in value)
        return value

    host = copy(results)
    event = torch.cuda.Event()
    event.record()
    return host, event


class ComputeRuntime(Actor):
    """Hosts programs on one device and schedules their batches.

    device=None means the CUDA card (raises when there is none);
    device="cpu" runs the same programs on the CPU.  mesh: a DeviceMesh
    (parallel.create_mesh) whose rank this process is; the runtime's
    device is the mesh's, place_params gives this rank's shards, and
    every rank of the mesh runs the same programs on the same inputs
    (sharded serving: each program's collectives pair up across the
    ranks; serving.py's header says how the decoder keeps them in
    step).  Batched programs' schedulers read the engine clock and are
    drained by an engine timer every `drive_period` seconds.  On a mesh
    (one rank included) their batch cuts are agreed instead: one timer
    drives every batched program, and each tick that has something
    queued starts one host-side exchange over a gloo group of the mesh
    (none on one rank) of every program's note (ops/batching.py: the
    items each rank holds, by stream id and per-stream sequence, and
    rank 0's cuts, by its clock and estimates); every rank then runs
    the same batches in rank 0's order, so a program's collectives pair
    up.  The exchange is asynchronous: a rank with items goes on serving
    until the others' next tick with items completes it, and an idle
    rank makes no call.  A sync caller's forced drain runs its own item
    at once, as off a mesh."""

    def __init__(self, runtime, name: str = "compute", device=None,
                 drive_period: float = 0.005, mesh=None):
        # resolve first: a runtime without the card must not register a
        # service that cannot run anything
        if mesh is not None:
            from .parallel.sharding import mesh_device
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self._mesh = mesh
        share = {"device_count": 0, "program_count": 0}
        super().__init__(runtime, name, PROTOCOL_COMPUTE, share=share)
        self.logger = get_logger(f"compute.{name}")
        self.drive_period = drive_period
        self.programs: dict[str, CompiledProgram] = {}
        self._timers: list[int] = []
        # pipelined results: the worker thread waits for the device, and
        # deliveries cross back onto the event loop through this queue
        self._results_queue = f"compute.results.{name}"
        self._worker = None
        self._worker_queue = None
        # the agreed batch cut on a mesh: its timer and gloo group, made
        # at the first batched program
        self._agree_timer = None
        self._agree_group = None
        self._agreement = None          # an exchange in flight
        runtime.event.add_queue_handler(self._deliver_results,
                                        self._results_queue)
        on_card = self.device.type == "cuda"
        self.device_kind = torch.cuda.get_device_name(self.device) \
            if on_card else "cpu"
        self.memory_free = self.memory_total = None
        self.ec_producer.update("device_count",
                                1 if mesh is None else mesh.size())
        self.ec_producer.update("mesh", {} if mesh is None else dict(
            zip(mesh.mesh_dim_names, mesh.mesh.shape)))
        self.ec_producer.update("platform", "gpu" if on_card else "cpu")
        self.ec_producer.update("device_kind", self.device_kind)
        self.refresh_device_health()
        # keep device health LIVE: dashboards must see memory pressure
        # building, not a boot-time snapshot
        self._timers.append(runtime.event.add_timer_handler(
            self.refresh_device_health, period=10.0))

    @property
    def sharding_mesh(self):
        """The mesh place_params shards over: the one the runtime was
        given, or None on one device."""
        return self._mesh

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

    @property
    def mesh(self):
        """The runtime's mesh: the one it was given, else a mesh of its
        one device (built at first use)."""
        if self._mesh is None:
            from .parallel import single_device_mesh
            self._mesh = single_device_mesh(device=self.device)
        return self._mesh

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
                         pipelined: bool = False,
                         max_in_flight: int = 4) -> BatchingScheduler:
        """Register a batched program.

        fn(bucket, batch) -> batch_results;
        collate(bucket, payloads) -> batch (tensors on self.device);
        split(batch_results, count) -> list of per-item results (where
        the host waits for the device).  Returns the scheduler, attached
        to the runtime's event engine.

        pipelined=True runs split() on a worker thread, on host copies of
        the results made without a host wait (_to_host), and delivers the
        callbacks through the engine's event queue: they fire on a later
        event-loop turn, so callers must drive the engine
        (drain(force=True) alone does not complete items).
        max_in_flight bounds the dispatched batches whose results have
        not been delivered (>= 2 for any overlap)."""
        in_flight = {"now": 0, "peak": 0}

        def process_batch(bucket, items):
            payloads = [item.payload for item in items]
            batch = collate(bucket, payloads)
            start = time.perf_counter()
            results = fn(bucket, batch)
            if pipelined:
                host, event = _to_host(results, self.device)
                in_flight["now"] += 1
                in_flight["peak"] = max(in_flight["peak"], in_flight["now"])
                # the batch and the device results stay referenced until
                # the event has fired
                self._worker_submit((program, bucket, items, host, event,
                                     (batch, results), split, start))
                return None                   # ownership transferred
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
        gate = (lambda: in_flight["now"] < int(max_in_flight)) \
            if pipelined else None
        room = (lambda: int(max_in_flight) - in_flight["now"]) \
            if pipelined else None
        agreed = self._mesh is not None
        scheduler = BatchingScheduler(process_batch, buckets,
                                      max_batch=max_batch,
                                      max_wait=max_wait,
                                      clock=self.runtime.event.clock.now,
                                      dispatch_gate=gate,
                                      metrics_labels={"program": name},
                                      agreed=agreed, dispatch_room=room)
        program = CompiledProgram(name, fn, buckets, scheduler, {})
        program.in_flight = in_flight
        self.programs[name] = program
        if not agreed:
            self._timers.append(scheduler.attach(self.runtime.event,
                                                 self.drive_period))
        elif self._agree_timer is None:
            if self._mesh.size() > 1:
                # a gloo group of its own: the decoder's round notes
                # gather on the default group, at other moments
                import torch.distributed as dist
                self._agree_group = dist.new_group(backend="gloo")
            self._agree_timer = self.runtime.event.add_timer_handler(
                self._agree_batches, self.drive_period)
            self._timers.append(self._agree_timer)
        self.ec_producer.update("program_count", len(self.programs))
        return scheduler

    def _agree_batches(self) -> None:
        """On a mesh, one drive tick of every batched program: exchange
        the programs' notes (ops/batching.py BatchingScheduler.note) when
        this rank holds an item of any, and apply rank 0's cuts on every
        rank (apply_note), program by program in rank 0's order.  On more
        than one rank the exchange never blocks the event loop: its two
        gathers (the notes' sizes, then their bytes) are asynchronous on
        the runtime's own gloo group, polled at each tick, so a rank
        waiting for the others' notes goes on serving (a decoder's round
        note gathers meanwhile) and the exchange completes at a later
        tick, the same exchange on every rank."""
        schedulers = {name: program.scheduler
                      for name, program in self.programs.items()
                      if program.scheduler is not None and
                      program.scheduler.agreed}
        if self._agree_group is None:
            mine = {name: note for name, note in
                    ((name, scheduler.note(True))
                     for name, scheduler in schedulers.items())
                    if note is not None}
            if mine:
                self._apply_batch_notes(schedulers, [mine])
            return
        import torch.distributed as dist
        if self._agreement is None:
            lead = dist.get_rank(self._agree_group) == 0
            mine = {name: note for name, note in
                    ((name, scheduler.note(lead))
                     for name, scheduler in schedulers.items())
                    if note is not None}
            if not mine:
                return
            payload = torch.frombuffer(bytearray(pickle.dumps(mine)),
                                       dtype=torch.uint8)
            size = torch.tensor([payload.numel()], dtype=torch.int64)
            sizes = [torch.zeros_like(size) for _ in
                     range(dist.get_world_size(self._agree_group))]
            self._agreement = {"payload": payload, "sizes": sizes,
                               "work": dist.all_gather(
                                   sizes, size, group=self._agree_group,
                                   async_op=True)}
        agreement = self._agreement
        if not agreement["work"].is_completed():
            return
        agreement["work"].wait()
        if "notes" not in agreement:
            longest = max(int(size) for size in agreement["sizes"])
            padded = torch.zeros((longest,), dtype=torch.uint8)
            padded[:agreement["payload"].numel()] = agreement["payload"]
            agreement["notes"] = [torch.zeros_like(padded) for _ in
                                  agreement["sizes"]]
            agreement["work"] = dist.all_gather(
                agreement["notes"], padded, group=self._agree_group,
                async_op=True)
            if not agreement["work"].is_completed():
                return
            agreement["work"].wait()
        self._agreement = None
        every = [pickle.loads(note[:int(size)].numpy().tobytes())
                 for note, size in zip(agreement["notes"],
                                       agreement["sizes"])]
        self._apply_batch_notes(schedulers, every)

    @staticmethod
    def _apply_batch_notes(schedulers: dict, every: list) -> None:
        for name in every[0]:
            schedulers[name].apply_note([notes.get(name)
                                         for notes in every])

    def submit(self, name: str, stream_id: str, payload, length: int,
               callback, deadline: float | None = None) -> None:
        program = self.programs[name]
        if program.scheduler is None:
            raise ValueError(f"program {name} is not batched")
        program.scheduler.submit(stream_id, payload, length, callback,
                                 deadline=deadline)

    # -- pipelined results path ---------------------------------------------
    def _worker_submit(self, job) -> None:
        if self._worker is None:
            self._worker_queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._worker_loop, name=f"compute.{self.name}",
                daemon=True)
            self._worker.start()
        self._worker_queue.put(job)

    def _worker_loop(self) -> None:
        """Off the event loop: wait for each batch's event, split its host
        copies.  Touches no device tensor (the batch and the device
        results only ride along until the event has fired)."""
        while True:
            job = self._worker_queue.get()
            if job is None:
                return
            program, bucket, items, host, event, _keep, split, start = job
            try:
                if event is not None:
                    event.synchronize()         # releases the GIL
                per_item = split(host, len(items))
                if len(per_item) != len(items):
                    raise RuntimeError(
                        f"split returned {len(per_item)} results for "
                        f"{len(items)} items")
            except Exception as exc:
                per_item = [exc] * len(items)
            elapsed = time.perf_counter() - start
            del job, _keep
            self.runtime.event.queue_put(
                self._results_queue,
                (program, bucket, items, per_item, elapsed))

    def _deliver_results(self, _queue_name, job, _put_time) -> None:
        program, bucket, items, per_item, elapsed = job
        if program.in_flight is not None:
            program.in_flight["now"] = max(0, program.in_flight["now"] - 1)
        if bucket not in program.first_call_times:
            # keyed by the program's fixed bucket ladder — bounded:
            # graft: disable=lint-unbounded-cache
            program.first_call_times[bucket] = elapsed
            self.ec_producer.update(f"first_call.{program.name}.{bucket}",
                                    round(elapsed, 3))
        elif program.scheduler is not None:
            program.scheduler.observe_service_time(bucket, elapsed)
            # audited: deque(maxlen=512)  # graft: disable=lint-unbounded-queue
            program.recent_service.append((bucket, elapsed))
        if program.scheduler is not None:
            self._publish_stats(program.name, program.scheduler)
        for item, result in zip(items, per_item):
            item.callback(item.stream_id, result)

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

    # -- placement ----------------------------------------------------------
    def place_params(self, params, param_axes=None, rules=None):
        """Place a parameter tree (a torch module) on this runtime's
        mesh.  On one device (no mesh, or a mesh of one) that is the
        device, whatever the axes say.  On a larger mesh a tree with axes
        becomes this rank's shards, plain tensors cut by their logical
        axes (parallel.local_shards: nested dicts and lists, what the
        serving programs read; a vocabulary that does not divide is
        padded to equal chunks, parallel/sharding.py); a tree without
        axes, or whose axes cut nothing on this mesh (Whisper's on an
        expert-only mesh), is replicated: every rank holds it whole, as
        JAX places an axis-free tree, and it stays the module."""
        if self._mesh is None or self._mesh.size() == 1 or \
                param_axes is None:
            return params.to(self.device)
        from .parallel.sharding import cuts_any, local_shards
        if not cuts_any(params, param_axes, self._mesh, rules):
            return params.to(self.device)
        placed, _ = local_shards(params, param_axes, self._mesh, rules)
        return placed

    def stop(self) -> None:
        for timer in self._timers:
            self.runtime.event.remove_timer_handler(timer)
        self._timers.clear()
        for program in self.programs.values():
            if program.scheduler is not None:
                program.scheduler.drain(force=True)
        if self._worker is not None:
            self._worker_queue.put(None)
            self._worker.join(timeout=10.0)
            self._worker = None
        self.runtime.event.remove_queue_handler(self._results_queue)
        super().stop()
