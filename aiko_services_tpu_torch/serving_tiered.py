# Tiered KV: host-memory block offload with async promotion.
#
# Counterpart of aiko_services_tpu/serving_tiered.py.  Idle
# conversations' KV lives in host memory and streams back just in time:
#
#   * HostBlockStore - the host tier.  The device BlockPool's block
#     geometry (per-layer [H, B, D] rows, int8 {"q", "s"} dicts
#     included) in PINNED host tensors, keyed by the prefix cache's
#     content-addressed chain keys, with its own LRU, global and
#     per-tenant byte budgets, kv_host_bytes{store, tenant} gauges and
#     kv_host_events_total counters (the JAX package's families).
#     Demotion (PrefixKVCache._evict with a store attached, and the
#     SessionTable's demotion wheel through demote_sessions) copies a
#     pool block's rows down once and frees the device block; the chain
#     key survives.
#
#   * AsyncPromoter - the prefetcher.  prefetch(tenant, tokens) captures
#     the host rows of the chain's non-resident tail ON the event loop and
#     hands them to one worker thread, which stages the per-layer
#     [M, H, B, D] stacks on the card; poll() (every admit round) and
#     promote_for() (the admit-time fallback) land the stacks in freshly
#     allocated pool blocks and register the chain with insert_block.
#     Bound by a decoder on a mesh, the promoter kicks at the round note
#     that agrees an arrival, stages the job at once on its own stream
#     (no worker thread), and lands it at the next note, before the
#     admit that waits for it (AsyncPromoter's docstring).
#
# Copies without a host sync.  A demotion stacks the block's per-layer
# rows on the card and copies them into a pinned host buffer with
# non_blocking=True on the stream that runs the rounds, then records an
# event: the pool block is released at once, and any later write into it
# (the next round's) is queued behind the copy on that stream.  Nothing on
# the event loop reads a pinned buffer: promotion copies it back to the
# card on the worker's own stream after waiting (on that stream) for the
# demotion's event, stacks it there and records a staging event; the
# event loop makes its stream wait on that event before the stacks are
# written into the pool (and marks them used on its stream for the
# caching allocator).  No .cpu(), .item() or synchronize anywhere.  On the
# CPU every copy is a plain tensor copy.
#
# Single-threaded discipline, as in JAX: every structure mutation (store
# dicts, cache inserts, pool alloc and write) happens on the event loop;
# the worker thread only reads the host rows it was handed and builds new
# tensors.

from __future__ import annotations

import logging
import queue
import threading
from collections import OrderedDict

import torch

from .observe.metrics import MirroredStats, default_registry
from .utils import Lock

__all__ = ["HostBlockStore", "AsyncPromoter"]


def _planes(leaf):
    """A block leaf's planes: {"q", "s"} for int8 storage, else {"": leaf}."""
    return leaf if isinstance(leaf, dict) else {"": leaf}


def _form(planes: dict):
    return planes[""] if set(planes) == {""} else planes


def _to_host(layers) -> tuple:
    """(per-layer host rows, stacked host planes, event): one block's
    per-layer leaves stacked to [L, ...] per plane and copied to pinned
    host memory without a host sync (the D2H of demotion); on the CPU
    the stack is the copy.  The per-layer rows are views of the stack."""
    stacked, event = {}, None
    for name in _planes(layers[0]):
        plane = torch.stack([torch.as_tensor(_planes(leaf)[name])
                             for leaf in layers])
        if plane.is_cuda:
            # the demotion's pinned host copy, one per demoted block set
            host = torch.empty(plane.shape, dtype=plane.dtype,  # graft: disable=lint-hot-alloc
                               pin_memory=True)
            host.copy_(plane, non_blocking=True)
            plane = host
            if event is None:
                event = torch.cuda.Event()
        stacked[name] = plane
    if event is not None:
        event.record()
    rows = [_form({name: plane[i] for name, plane in stacked.items()})
            for i in range(len(layers))]
    return rows, stacked, event


class _HostBlock:
    """One demoted block: per-layer host K/V rows (views of the stacked
    pinned planes), the demotion copy's event, and the chain bookkeeping
    promotion needs (parent key, tenant, bytes)."""

    __slots__ = ("key", "parent", "tenant", "k_rows", "v_rows", "k_host",
                 "v_host", "ready", "nbytes")

    def __init__(self, key, parent, tenant, k_layers, v_layers, nbytes):
        self.key = key
        self.parent = parent
        self.tenant = tenant
        self.k_rows, self.k_host, k_ready = _to_host(k_layers)
        self.v_rows, self.v_host, v_ready = _to_host(v_layers)
        # both copies queue on one stream: the later event covers both
        self.ready = v_ready or k_ready
        self.nbytes = int(nbytes)


class HostBlockStore:
    """Host-memory tier of the two-tier KV store.

    Holds demoted prefix-cache blocks in pinned host tensors under their
    content-addressed chain keys.  LRU over one OrderedDict (oldest first,
    like PrefixKVCache) with a global byte budget plus an optional
    per-tenant cap, so one tenant's idle history cannot evict everyone
    else's.  Gauges kv_host_bytes{store, tenant} and kv_host_blocks
    {store}; counters kv_host_events_total{event=demoted | promoted |
    evicted | refused}.  Called only from the event loop."""

    def __init__(self, max_bytes: int | None = 2 << 30,
                 tenant_max_bytes: int | None = None,
                 name: str = "host_kv", registry=None):
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.tenant_max_bytes = int(tenant_max_bytes) \
            if tenant_max_bytes else None
        self.name = str(name)
        self._nodes: OrderedDict = OrderedDict()
        self._tenant_bytes: dict = {}
        self.bytes_used = 0
        self.logger = logging.getLogger(f"serving.host_kv.{name}")
        self._registry = registry or default_registry()
        self.stats = MirroredStats(
            {"demoted": 0, "promoted": 0, "evicted": 0, "refused": 0,
             "demote_bytes": 0, "promote_bytes": 0},
            metric="kv_host_events_total",
            help="host KV tier events by kind",
            registry=self._registry,
            skip=("demote_bytes", "promote_bytes"),
            labels={"store": self.name})
        self._gauge_blocks = self._registry.gauge(
            "kv_host_blocks", "host-tier resident KV blocks",
            labels={"store": self.name})
        self._tenant_gauges: dict = {}
        # the KV memory ledger: host byte deltas report exactly where
        # _tenant_bytes moves, so its host totals equal bytes_used
        self._ledger = None

    def attach_ledger(self, ledger) -> None:
        self._ledger = ledger
        if ledger is not None:
            ledger.attach_host(self)

    # -- residency ---------------------------------------------------------
    def has(self, key: str) -> bool:
        return key in self._nodes

    def get(self, key: str):
        return self._nodes.get(key)

    def __len__(self) -> int:
        return len(self._nodes)

    def tenant_bytes(self, tenant: str) -> int:
        return self._tenant_bytes.get(str(tenant or "default"), 0)

    def put_from_device(self, tenant: str, parent: str, key: str,
                        k_rows, v_rows, nbytes: int) -> bool:
        """Demote one block: copy the pool's per-layer row views to
        pinned host memory (queued on the stream, no host sync) and
        register them under the chain key.  Returns False when the host
        budgets refused it (the block is then truly evicted)."""
        tenant = str(tenant or "default")
        if key in self._nodes:
            self._nodes.move_to_end(key)
            return True
        if self.max_bytes is not None and nbytes > self.max_bytes:
            self.stats["refused"] += 1
            return False
        node = _HostBlock(key, parent, tenant, k_rows, v_rows, nbytes)
        self._nodes[key] = node
        self.bytes_used += node.nbytes
        self._tenant_bytes[tenant] = \
            self._tenant_bytes.get(tenant, 0) + node.nbytes
        self.stats["demoted"] += 1
        self.stats["demote_bytes"] += node.nbytes
        if self._ledger is not None:
            self._ledger.host_delta(tenant, node.nbytes, "demote")
        self._evict_to_budget(tenant)
        if key not in self._nodes:      # the budget evicted the newcomer
            self.stats["refused"] += 1
            self._publish_gauges(tenant)
            return False
        if self._ledger is not None:
            self._ledger.move(tenant, "demote")
        self._publish_gauges(tenant)
        return True

    def touch(self, key: str) -> None:
        if key in self._nodes:
            self._nodes.move_to_end(key)

    def chain_nodes(self, keys) -> list:
        """The contiguous host-resident run of `keys` from the front: the
        promotable segment (a gap ends it)."""
        nodes = []
        for key in keys:
            node = self._nodes.get(key)
            if node is None:
                break
            nodes.append(node)
        return nodes

    def pop_promoted(self, keys) -> int:
        """Drop promoted blocks from the host tier (they live on the
        device again); returns bytes released."""
        released = 0
        tenants = set()
        for key in keys:
            node = self._nodes.pop(key, None)
            if node is None:
                continue
            released += node.nbytes
            self._drop_bytes(node)
            tenants.add(node.tenant)
            self.stats["promoted"] += 1
            self.stats["promote_bytes"] += node.nbytes
            if self._ledger is not None:
                self._ledger.host_delta(node.tenant, -node.nbytes,
                                        "promote")
                self._ledger.move(node.tenant, "promote")
        for tenant in tenants:
            self._publish_gauges(tenant)
        return released

    # -- budgets -----------------------------------------------------------
    def _drop_bytes(self, node: _HostBlock) -> None:
        self.bytes_used -= node.nbytes
        remaining = self._tenant_bytes.get(node.tenant, 0) - node.nbytes
        if remaining > 0:
            self._tenant_bytes[node.tenant] = remaining
        else:
            self._tenant_bytes.pop(node.tenant, None)

    def _over_budget(self, tenant: str) -> str | None:
        if self.tenant_max_bytes is not None and \
                self._tenant_bytes.get(tenant, 0) > self.tenant_max_bytes:
            return tenant
        if self.max_bytes is not None and \
                self.bytes_used > self.max_bytes:
            return ""                   # global breach: any tenant
        return None

    def _evict_to_budget(self, tenant: str) -> None:
        # plain LRU from the front: host blocks are terminal (no third
        # tier), and a mid-chain eviction only shortens the promotable run
        while True:
            scope = self._over_budget(tenant)
            if scope is None:
                return
            victim = None
            for node in self._nodes.values():
                if scope and node.tenant != scope:
                    continue
                victim = node
                break
            if victim is None:
                return
            del self._nodes[victim.key]
            self._drop_bytes(victim)
            self.stats["evicted"] += 1
            if self._ledger is not None:
                self._ledger.host_delta(victim.tenant, -victim.nbytes,
                                        "host_evict")
            self._publish_gauges(victim.tenant)

    def _publish_gauges(self, tenant: str) -> None:
        self._gauge_blocks.set(len(self._nodes))
        gauge = self._tenant_gauges.get(tenant)
        if gauge is None:
            gauge = self._registry.gauge(
                "kv_host_bytes", "host-tier resident KV bytes by tenant",
                labels={"store": self.name, "tenant": tenant})
            self._tenant_gauges[tenant] = gauge
        gauge.set(self._tenant_bytes.get(tenant, 0))


class _PromoteJob:
    __slots__ = ("key", "tenant", "keys", "parent", "rows", "device",
                 "stacks", "event", "done", "identity", "superseded",
                 "notes")

    def __init__(self, key, tenant, keys, parent, nodes, device,
                 kick: int = 0):
        self.key = key              # dedup key: the first host-tier key
        self.tenant = tenant
        self.keys = keys            # chain keys being promoted
        self.parent = parent        # device-resident parent ("" root)
        # captured on the loop: (stacked K planes, stacked V planes, the
        # demotion copy's event) per block
        self.rows = [(node.k_host, node.v_host, node.ready)
                     for node in nodes]
        self.device = device
        self.stacks = None          # staged (k_layers, v_layers)
        self.event = None           # the staging copies' event
        self.done = threading.Event()
        # what the ranks of a mesh compare (AsyncPromoter.landed), and
        # whether an admit staged its blocks inline instead
        self.identity = (kick, key, tuple(keys), parent)
        self.superseded = False
        self.notes = 0              # round notes since an agreed kick


def _stage_stacks(rows, device, stream) -> tuple:
    """Per-layer [M, H, B, D] stacks (int8: {"q", "s"}) of the captured
    blocks on `device`: on the card each block's stacked host planes
    copy over on `stream` once their demotion event has passed there, and
    one stack per plane builds the layer-major [L, M, ...] tensor."""
    if device.type == "cuda":
        for _, _, ready in rows:
            if ready is not None:
                stream.wait_event(ready)
    staged = []
    for side in (0, 1):
        planes = {}
        for name in rows[0][side]:
            parts = [block[side][name] for block in rows]
            if device.type == "cuda":
                parts = [part.to(device, non_blocking=True)
                         for part in parts]
            planes[name] = torch.stack(parts, dim=1)   # [L, M, ...]
        layers = planes[next(iter(planes))].shape[0]
        staged.append([_form({name: plane[i]
                              for name, plane in planes.items()})
                       for i in range(layers)])
    return tuple(staged)


class AsyncPromoter:
    """Off-event-loop prefetcher for the host KV tier.

    prefetch() captures host row references on the event loop and hands
    them to ONE daemon worker, which copies them to the card on its own
    stream and stacks them per layer, handing back a CUDA event.  poll()
    (every admit round) and promote_for() (the admit-time fallback) run
    on the loop: wait on the event on the loop's stream, allocate pool
    blocks, write the staged stacks, register the chain with
    insert_block, and drop the host copies.  A prompt whose prefetch
    landed before its admit round pays nothing at admit
    (installs_async); one that races its admit waits out the in-flight
    staging (installs_wait) or stages inline (installs_sync).  Staging
    is bounded: at most `max_batch_blocks` blocks a kick and
    `max_inflight` chains at once (kv_promote_deferred_total counts the
    rest, which re-kicks on the chain's next probe).

    `agreed` (set by a cache bound on a mesh): the ranks must kick and
    land the same promotions in the same rounds, so nothing depends on
    a thread's timing or on when a rank saw a prompt.  prefetch kicks
    only when the decoder's round note asks (`agreed_kick`: an arrival
    every rank holds, in rank 0's order, so every rank's jobs are the
    same), and stages the job at once on the loop, its copies queued on
    the promoter's own stream (no worker thread: what is staged by the
    next note is then no matter of timing); poll() lands nothing; the
    note gathers each rank's landed() jobs and every rank installs,
    through land(), the ones staged on every rank, at the first note
    after the kick.  Until then pending() holds the admit of the kick's
    prompt back, so it sees the landed blocks as hits; a job that has
    not landed after `age(bound)` counted `bound` notes is given up on
    every rank alike, and promote_for then stages the chain inline."""

    def __init__(self, cache, store: HostBlockStore,
                 name: str | None = None, registry=None,
                 wait_s: float = 2.0, max_batch_blocks: int = 16,
                 max_inflight: int = 4):
        self.cache = cache
        self.store = store
        self.name = str(name or f"{store.name}.promote")
        self.wait_s = float(wait_s)
        self.max_batch_blocks = max(1, int(max_batch_blocks))
        self.max_inflight = max(1, int(max_inflight))
        self.logger = logging.getLogger(f"serving.promote.{self.name}")
        self._jobs: dict = {}           # first key -> _PromoteJob
        self._ready: list = []          # staged, awaiting install
        self.agreed = False
        self._kicks = 0                 # numbers each job (its identity)
        self._lock = Lock(f"{self.name}._ready")
        self._queue: queue.Queue = queue.Queue()
        self._thread = None
        self._stream = None             # the worker's CUDA stream
        self._registry = registry or default_registry()
        self.stats = MirroredStats(
            {"kicks": 0, "staged": 0, "installs": 0,
             "installs_async": 0, "installs_sync": 0,
             "installs_wait": 0, "stale": 0},
            metric="kv_promote_events_total",
            help="host-tier KV promotion events by kind",
            registry=self._registry,
            labels={"promoter": self.name})
        self._deferred = self._registry.counter(
            "kv_promote_deferred_total",
            "prefetch blocks deferred by the staging depth cap or the "
            "in-flight chain limit",
            labels={"promoter": self.name})

    # -- event-loop side ---------------------------------------------------
    @property
    def ready(self) -> bool:
        """Staged promotions wait for poll() (plain list truthiness)."""
        return bool(self._ready)

    @property
    def inflight(self) -> bool:
        """Kicked jobs not installed, dropped or given up yet."""
        return bool(self._jobs)

    def _segment(self, tenant: str, tokens) -> tuple:
        """(keys, device-resident blocks, host nodes) of the chain's
        promotable tail: the device-resident run first, then the
        host-resident continuation."""
        cache = self.cache
        block = cache.block_tokens
        count = max(0, len(tokens) - 1) // block
        if count == 0 or not len(self.store):
            return [], 0, []
        keys = cache.keys_for(tenant, tokens[:count * block])
        device = 0
        while device < count and cache.has(keys[device]):
            device += 1
        if device >= count:
            return keys, device, []
        return keys, device, self.store.chain_nodes(keys[device:])

    def _job(self, tenant, keys, device: int, nodes) -> _PromoteJob:
        self._kicks += 1
        return _PromoteJob(keys[device], str(tenant or "default"),
                           keys[device:device + len(nodes)],
                           keys[device - 1] if device else "", nodes,
                           self.cache.pool.device, self._kicks)

    def prefetch(self, tenant: str, tokens,
                 agreed_kick: bool = False) -> int:
        """Kick an async promotion of the host-resident tail of this
        prompt's chain; returns the tokens being promoted (0: nothing
        host-resident, already resident, already in flight, deferred by
        the staging bounds, or agreed and not an agreed kick).
        Non-blocking."""
        if self.agreed and not agreed_kick:
            return 0
        keys, device, nodes = self._segment(tenant, tokens)
        if not nodes or self.cache.pool is None:
            return 0
        if keys[device] in self._jobs:
            return 0                     # already staging or staged
        if len(self._jobs) >= self.max_inflight:
            self._deferred.inc(len(nodes))
            return 0
        if len(nodes) > self.max_batch_blocks:
            self._deferred.inc(len(nodes) - self.max_batch_blocks)
            nodes = nodes[:self.max_batch_blocks]
        job = self._job(tenant, keys, device, nodes)
        self._jobs[job.key] = job
        self.stats["kicks"] += 1
        if self.agreed:
            # staged now, on the promoter's stream: the note after this
            # one finds it staged on every rank
            self._stage(job)
            with self._lock:
                self._ready.append(job)
            job.done.set()
        else:
            self._ensure_thread()
            self._queue.put(job)
        return len(nodes) * self.cache.block_tokens

    def pending(self, tenant: str, tokens) -> bool:
        """Agreed: an agreed kick of this prompt's host-resident chain
        tail waits to land at a later note (the admit waits with it)."""
        if not self.agreed:
            return False
        keys, device, nodes = self._segment(tenant, tokens)
        if not nodes:
            return False
        job = self._jobs.get(keys[device])
        return job is not None and not job.superseded

    def age(self, bound: int) -> None:
        """Agreed: one more round note passed.  A job kicked `bound`
        notes ago that has not landed is given up (its chain's admit
        stages inline), the same job on every rank."""
        for key, job in list(self._jobs.items()):
            job.notes += 1
            if job.notes > bound and not job.superseded:
                job.superseded = True
                self._jobs.pop(key)

    def landed(self) -> list:
        """Identities of the staged jobs ready to install, in kick
        order: (kick number, first key, keys, parent), what the ranks'
        copies of one agreed kick share.  A job an admit passed over
        (promote_for) is dropped here: it never lands."""
        with self._lock:
            self._ready = [job for job in self._ready
                           if not job.superseded]
            ready = list(self._ready)
        return sorted(job.identity for job in ready)

    def land(self, identities) -> int:
        """Install the staged jobs named by `identities`, in that order
        (event loop only); returns tokens landed."""
        wanted = set(identities)
        with self._lock:
            jobs = {job.identity: job for job in self._ready
                    if job.identity in wanted}
            self._ready = [job for job in self._ready
                           if job.identity not in wanted]
        landed = sum(self._install(jobs[identity], kind="installs_async")
                     for identity in identities if identity in jobs)
        # a staged job whose chain is resident now (promoted inline at an
        # admit, or re-prefilled) never lands: drop it, or it would hold
        # its in-flight place
        cache = self.cache
        with self._lock:
            stale = [job for job in self._ready if cache.has(job.key)]
            self._ready = [job for job in self._ready
                           if not cache.has(job.key)]
        for job in stale:
            if self._jobs.get(job.key) is job:
                self._jobs.pop(job.key)
        return landed

    def poll(self) -> int:
        """Install every staged promotion (event loop only); returns
        tokens landed.  Agreed: lands nothing (land does)."""
        if not self._ready or self.agreed:
            return 0
        with self._lock:
            jobs, self._ready = self._ready, []
        landed = 0
        for job in jobs:
            landed += self._install(job, kind="installs_async")
        return landed

    def promote_for(self, tenant: str, tokens) -> int:
        """Admit-time fallback: make the host-resident tail of this
        prompt's chain device-resident now.  A staged job installs at
        once; an in-flight one is waited out (bounded by wait_s: the
        worker's host-side queueing, not the card); with no job the
        stacks stage inline on the loop's stream.  Returns tokens
        promoted."""
        self.poll()
        keys, device, nodes = self._segment(tenant, tokens)
        if not nodes or self.cache.pool is None:
            return 0
        job = self._jobs.get(keys[device])
        if job is not None and self.agreed:
            # never wait: the decoder admits only once pending() is
            # false, so a job here was kicked for another prompt of the
            # chain; stage inline, and the passed-over job never lands
            # (every rank passes over the same one)
            job.superseded = True
        elif job is not None:
            if not job.done.wait(self.wait_s):
                return 0                 # mid-stage: lands next round
            with self._lock:
                if job in self._ready:
                    self._ready.remove(job)
            return self._install(job, kind="installs_wait")
        job = self._job(tenant, keys, device, nodes)
        self._jobs[job.key] = job
        self._stage(job, inline=True)
        return self._install(job, kind="installs_sync")

    def _install(self, job: _PromoteJob, kind: str) -> int:
        if self._jobs.get(job.key) is job:
            self._jobs.pop(job.key)
        cache = self.cache
        pool = cache.pool
        if pool is None or job.stacks is None:
            self.stats["stale"] += 1
            return 0
        if job.parent and not cache.has(job.parent):
            # the device-resident parent left while we staged: the blocks
            # would be unreachable by match; the next kick re-segments
            self.stats["stale"] += 1
            return 0
        skip = 0
        while skip < len(job.keys) and cache.has(job.keys[skip]):
            skip += 1                   # re-prefilled while staging
        keys = job.keys[skip:]
        if not keys:
            self.stats["stale"] += 1
            return 0
        k_layers, v_layers = job.stacks
        if job.event is not None:
            stream = torch.cuda.current_stream(job.device)
            stream.wait_event(job.event)
            for layers in (k_layers, v_layers):
                for leaf in layers:
                    for plane in _planes(leaf).values():
                        plane.record_stream(stream)
        if skip:
            k_layers = [_slice_stack(s, skip) for s in k_layers]
            v_layers = [_slice_stack(s, skip) for s in v_layers]
        ids = pool.alloc_blocks(len(keys), tenant=job.tenant)
        pool.write_blocks(ids, k_layers, v_layers)
        parent = job.keys[skip - 1] if skip else job.parent
        installed = 0
        for j, key in enumerate(keys):
            if not cache.insert_block(job.tenant, parent, key, ids[j]):
                break                   # device budget refused: stop
            parent = key
            installed += 1
        pool.release_blocks(ids, tenant=job.tenant)
        if installed:
            self.store.pop_promoted(keys[:installed])
            cache.stats["promoted"] += installed
            self.stats["installs"] += installed
            self.stats[kind] += installed
        return installed * cache.block_tokens

    # -- worker side -------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name=self.name, daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._stage(job)
            except Exception:
                self.logger.exception("promotion staging failed")
                job.stacks = None
            with self._lock:
                self._ready.append(job)
            job.done.set()

    def _stage(self, job: _PromoteJob, inline: bool = False) -> None:
        """Build the per-layer [M, H, B, D] stacks write_blocks takes, on
        the pool's device: on the worker's own stream (handing back an
        event), or inline on the loop's current stream."""
        device = job.device
        if device.type != "cuda":
            job.stacks = _stage_stacks(job.rows, device, None)
        elif inline:
            job.stacks = _stage_stacks(
                job.rows, device, torch.cuda.current_stream(device))
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=device)
            with torch.cuda.stream(self._stream):
                job.stacks = _stage_stacks(job.rows, device, self._stream)
                event = torch.cuda.Event()
                event.record(self._stream)
            job.event = event
        self.stats["staged"] += len(job.keys)

    def stop(self) -> None:
        """Stop the worker (idempotent).  In-flight jobs finish staging
        and are dropped unpolled; the store keeps the host copies."""
        thread = self._thread
        if thread is not None and thread.is_alive():
            self._queue.put(None)
            thread.join(timeout=5.0)
        self._thread = None


def _slice_stack(stack, skip: int):
    if isinstance(stack, dict):
        return {"q": stack["q"][skip:], "s": stack["s"][skip:]}
    return stack[skip:]
