# Disaggregated prefill / decode serving and session migration.
#
# The port's own copy of aiko_services_tpu/serving_disagg.py.  Prefill
# and decode run in separately scaled pools, so prompt bursts do not
# dilate the decode pool's inter-token latency:
#
#   * PrefillRuntime: a role-tagged actor owning a ContinuousDecoder and
#     PrefixKVCache whose only job is prompt KV.  Each request prefills
#     (max_new_tokens 1), the retire harvest drops the prompt blocks into
#     its cache, and the chain ships to the decode side as KV-transfer
#     envelopes (transport/wire.py encode_kv_transfer), chunk by chunk
#     while a long prompt is still prefilling;
#   * PrefillClient: the decode side.  It routes prompts to a discovered
#     prefill runtime by remaining deadline (ops/admission.DeadlineRouter),
#     installs the shipped chain into the decode decoder's PrefixKVCache
#     (install_chain) or, cacheless and paged, straight into its pool
#     (install_shipped_blocks), and submits the request: the chain admits
#     as a prefix hit and only the ragged suffix prefills here.  Blocks
#     the decode side already holds cross as handles (an index, never
#     bytes).  No pool, a transfer timeout after its retries, a corrupt
#     payload or a layout mismatch all fall back to local prefill,
#     counted, never a dropped request;
#   * SessionMigrator: both roles of moving pinned conversations (chain
#     and SessionTable record) between two serving runtimes;
#   * DisaggHarness: the two-pool plane in one process (registrar, peer-
#     enabled prefill and decode runtimes over one MemoryBroker and one
#     real-clock EventEngine), and its colocated A/B.
#
# From JAX to PyTorch: a shipped chain is gathered on the device, one
# index_select per layer and plane (paged) or one stack (dense), into one
# device buffer, copied into one pinned host buffer with non_blocking=True
# on the stream that runs the decode rounds (so a later write to those
# blocks, an eviction or a copy-on-extend, queues behind the copy), and a
# CUDA event marks it.  The envelope is encoded and posted once the event
# has completed, polled from the engine, in FIFO order (the receiver's
# ordered-cursor guard drops chunks that arrive out of order): shipping
# makes no host sync.  An install stages its rows in one fresh pinned
# buffer and copies them with non_blocking=True (serving.install_chain).
# On the CPU the copies are plain and every envelope posts at once.

from __future__ import annotations

import pickle
import time
import uuid
from collections import deque

import numpy as np
import torch

from .actor import Actor
from .observe import tracing
from .observe.metrics import MirroredStats, default_registry
from .ops.admission import DeadlineRouter
from .service import ServiceFilter, ServiceProtocol, ServiceTags
from .serving import check_block_geometry
from .transport import wire
from .utils import get_logger

__all__ = ["PROTOCOL_PREFILL", "ROLE_PREFILL", "ROLE_DECODE",
           "ROLE_COLOCATED", "role_tag", "tag_role", "PrefillRuntime",
           "PrefillClient", "SessionMigrator", "two_pool_autoscalers",
           "DisaggHarness"]

PROTOCOL_PREFILL = ServiceProtocol("prefill")
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_COLOCATED = "colocated"


def role_tag(role: str) -> str:
    """The discovery-record tag form of a serving role."""
    return f"role={role}"


def tag_role(service, role: str) -> None:
    """Tag a service's registrar record with its serving role and
    re-register, so the changed record propagates (the registrar drops
    identical re-adds but forwards changed ones)."""
    service.add_tags([role_tag(role)])
    runtime = service.runtime
    if runtime.registrar is not None and runtime.message is not None:
        runtime._register_service(service)


# -- shipping chain blocks to the host --------------------------------------

class _HostRows:
    """Chain blocks on their way to the host for the wire: `blocks` is
    [per block [per layer {"k": leaf, "v": leaf}]] of host tensors, valid
    once ready() (the device-to-host copy's CUDA event has completed;
    at once on the CPU)."""

    __slots__ = ("blocks", "event")

    def __init__(self, blocks, event=None):
        self.blocks = blocks
        self.event = event

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _chain_wire_blocks(cache, keys) -> _HostRows:
    """Cached chain blocks -> host rows for the wire, in the donor's
    storage layout (int8 {"q", "s"} leaves plane by plane, bit-exact).
    Paged, the blocks are gathered from the pool with one index_select
    per layer and plane; dense, each layer's node rows are stacked.  On
    the card the gathers fill one device buffer that is copied into one
    pinned host buffer without a host sync (_to_host)."""
    nodes = cache.nodes(keys)
    if not nodes:
        return _HostRows([])
    if cache.paged:
        pool = cache.pool
        index = pool._ids([node.pool_id for node in nodes])
        sides = (pool.k_pools, pool.v_pools)

        def source(side, layer, key):
            pools = sides[side][layer]
            return pools if key is None else pools[key]

        def fill(side, layer, key, out):
            return torch.index_select(source(side, layer, key), 0, index,
                                      out=out)
    else:
        def source(side, layer, key):
            leaf = cache.block_rows(nodes[0])[side][layer]
            return leaf if key is None else leaf[key]

        def fill(side, layer, key, out):
            planes = []
            for node in nodes:
                leaf = cache.block_rows(node)[side][layer]
                planes.append(leaf if key is None else leaf[key])
            return torch.stack(planes, out=out)
    first = cache.block_rows(nodes[0])[0]
    keys_of = ("q", "s") if isinstance(first[0], dict) else (None,)
    layers = len(first)
    specs = []
    for side in (0, 1):
        for layer in range(layers):
            for key in keys_of:
                plane = source(side, layer, key)
                shape = tuple(plane.shape[1:]) if cache.paged \
                    else tuple(plane.shape)
                specs.append((side, layer, key, plane.dtype, shape))
    stacks, event = _to_host(specs, fill, len(nodes),
                             source(0, 0, keys_of[0]).device)
    blocks = []
    for j in range(len(nodes)):
        per_layer = [{} for _ in range(layers)]
        for (side, layer, key, *_), stack in zip(specs, stacks):
            if key is None:
                per_layer[layer]["kv"[side]] = stack[j]
            else:
                per_layer[layer].setdefault("kv"[side], {})[key] = stack[j]
        blocks.append(per_layer)
    return _HostRows(blocks, event)


def _to_host(specs, fill, count: int, device):
    """Run each spec's gather into [count, *shape] stacks and bring them
    to the host: (host stacks, CUDA event or None).  On the card the
    stacks fill typed views of one device buffer, which is copied into
    one pinned buffer with non_blocking=True on the current stream, and
    the event marks the copy; on the CPU the gathers are the stacks."""
    if device.type != "cuda":
        return [fill(side, layer, key, None)
                for side, layer, key, _, _ in specs], None
    spans, total = [], 0
    for *_, dtype, shape in specs:
        nbytes = count * int(np.prod(shape)) * \
            torch.empty((), dtype=dtype).element_size()
        spans.append((total, nbytes))
        total += -(-nbytes // 16) * 16
    flat = torch.empty((total,), dtype=torch.uint8, device=device)
    for (side, layer, key, dtype, shape), (start, nbytes) in \
            zip(specs, spans):
        fill(side, layer, key, flat[start:start + nbytes].view(dtype)
             .view((count,) + shape))
    host = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return [host[start:start + nbytes].view(dtype).view((count,) + shape)
            for (*_, dtype, shape), (start, nbytes) in
            zip(specs, spans)], event


class _Outbox:
    """Envelopes whose rows are still crossing to the host, posted in
    FIFO order once each one's copy has completed: a flatout handler
    polls the engine while any wait (it is removed when the queue
    drains), and put() posts at once whatever is ready."""

    def __init__(self, engine):
        self._engine = engine
        self._queue: deque = deque()
        self._polling = False

    def put(self, rows: _HostRows, send) -> None:
        self._queue.append((rows, send))
        self.poll()

    def poll(self) -> None:
        while self._queue and self._queue[0][0].ready():
            _, send = self._queue.popleft()
            send()
        self._arm(bool(self._queue))

    def flush(self) -> None:
        """Post everything owed now, waiting for the copies (teardown)."""
        while self._queue:
            rows, send = self._queue.popleft()
            rows.wait()
            send()
        self._arm(False)

    def _arm(self, on: bool) -> None:
        if on and not self._polling:
            self._engine.add_flatout_handler(self.poll)
            self._polling = True
        elif not on and self._polling:
            self._engine.remove_flatout_handler(self.poll)
            self._polling = False


# -- a prefill side or a migrator on a mesh -----------------------------------
# A decoder (or a prefix cache) sharded over a mesh of more than one rank
# holds this rank's KV heads of each block, and its ranks must be handed
# the same requests.  The lead (global rank 0) is the side's address: it
# alone receives the wire's calls, hands each to the other ranks over a
# link, and alone posts envelopes; before a ship, the ranks of its model
# group gather their KV-head slices of the blocks to it, which it joins
# in kv_head_range order into whole blocks, under the model's layout:
# the envelope an unsharded side would send, its rows computed
# tensor-parallel (past the first layer they differ from an unsharded
# model's by the row-parallel sums' rounding).  The link is two gloo
# groups of its own, host-side:
# the calls ride broadcasts from the lead, for which the other ranks
# keep one standing; a shipment's slices ride one all_gather over the
# lead's model group, joined by each rank once its rows' device-to-host
# copy has completed (its CUDA event).  Nothing on the link blocks: every
# collective is asynchronous and polled (the other ranks poll the calls
# from an engine timer, the lead its gathers from the outbox that waits
# for them), and the decoder's round note alone agrees when a request
# joins.

_LINK_TIMEOUT = 60.0                 # bound on every wait at teardown


def _leaves(blocks):
    """Every tensor of shipped blocks ([per block [per layer {"k", "v"}]],
    a leaf a tensor or an int8 {"q", "s"} dict), in one fixed order."""
    for block in blocks:
        for layer in block:
            for side in ("k", "v"):
                leaf = layer[side]
                if isinstance(leaf, dict):
                    yield from (leaf["q"], leaf["s"])
                else:
                    yield leaf


def _rows_bytes(blocks) -> torch.Tensor:
    """Shipped blocks' leaves as one flat uint8 host tensor."""
    leaves = [leaf.contiguous().reshape(-1).view(torch.uint8)
              for leaf in _leaves(blocks)]
    return torch.cat(leaves) if leaves else torch.empty((0,), torch.uint8)


def _join_heads(mine, theirs: list):
    """Whole blocks from the lead's KV-head slices `mine` and the other
    ranks' slices (flat uint8 tensors, _rows_bytes), in model order:
    each leaf's rows [H/n, B, (D)] concatenated along the head axis."""
    parts = []
    for data in theirs:
        offset, leaves = 0, []
        for leaf in _leaves(mine):
            nbytes = leaf.numel() * leaf.element_size()
            leaves.append(data[offset:offset + nbytes].view(leaf.dtype)
                          .view(leaf.shape))
            offset += nbytes
        parts.append(iter(leaves))

    def join(leaf):
        return torch.cat([leaf] + [next(part) for part in parts], dim=0)

    return [[{side: ({key: join(layer[side][key]) for key in ("q", "s")}
                     if isinstance(layer[side], dict)
                     else join(layer[side])) for side in ("k", "v")}
             for layer in block] for block in mine]


class _MeshLink:
    """The lead's link to the other ranks of a mesh (the section above):
    call() on the lead hands a picklable call to every other rank, whose
    `on_call` runs it when its timer's poll finds it; gathered() on the
    lead wraps its own rows of a shipment as the whole blocks the
    gather of its model group's slices completes; gather() on another
    rank of that group joins the gather of the next shipment.
    Built on every rank of the default group alike (its groups are new
    ones)."""

    def __init__(self, engine, mesh, on_call, poll_period: float = 0.002):
        import torch.distributed as dist
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.lead = self.rank == 0
        names = tuple(mesh.mesh_dim_names)
        grid = mesh.mesh
        if "model" in names:
            dim = names.index("model")
            grid = grid.movedim(dim, 0).reshape(grid.shape[dim], -1)[:, 0]
        else:
            grid = grid.reshape(-1)[:1]
        self.model_ranks = [int(rank) for rank in grid.tolist()]
        self._calls = dist.new_group(backend="gloo")
        self._slices = dist.new_group(ranks=sorted(self.model_ranks),
                                      backend="gloo")
        self._engine = engine
        self._on_call = on_call
        self._pending: list = []       # (work, tensors) not yet complete
        self._standing = None          # another rank: the calls' receive
        self._timer = None
        self.closed = False
        if not self.lead:
            self._stand()
            self._timer = engine.add_timer_handler(self.poll, poll_period)

    @property
    def heads(self) -> int:
        """How many ranks' KV-head slices make a whole block."""
        return len(self.model_ranks)

    def _keep(self, work, *tensors) -> None:
        self._pending = [(w, t) for w, t in self._pending
                         if not w.is_completed()] + [(work, tensors)]

    def _stand(self, size: int | None = None) -> None:
        """Another rank: post the receive of the calls' next header (or
        of the body of `size` bytes its header announced)."""
        import torch.distributed as dist
        buffer = torch.zeros((1,), dtype=torch.int64) if size is None \
            else torch.empty((size,), dtype=torch.uint8)
        self._standing = (dist.broadcast(buffer, src=0, group=self._calls,
                                         async_op=True), buffer,
                          size is None)

    def call(self, message) -> None:
        """Lead: hand `message` to every other rank, in order."""
        self._broadcast(pickle.dumps(message))

    def _broadcast(self, data: bytes | None) -> None:
        import torch.distributed as dist
        head = torch.tensor([-1 if data is None else len(data)],
                            dtype=torch.int64)
        self._keep(dist.broadcast(head, src=0, group=self._calls,
                                  async_op=True), head)
        if data:
            body = torch.frombuffer(bytearray(data), dtype=torch.uint8)
            self._keep(dist.broadcast(body, src=0, group=self._calls,
                                      async_op=True), body)

    def poll(self) -> None:
        """Another rank: run every call the lead has handed over."""
        while self._standing is not None and \
                self._standing[0].is_completed():
            work, buffer, is_head = self._standing
            work.wait()
            if not is_head:
                self._stand()
                self._on_call(pickle.loads(buffer.numpy().tobytes()))
            elif int(buffer[0]) < 0:
                self._standing = None
                self.closed = True
            elif int(buffer[0]) == 0:
                self._stand()
            else:
                self._stand(int(buffer[0]))

    def gather(self, rows):
        """Join the next shipment's gather over the lead's model group
        with this rank's rows (ready): (work, parts by model index), or
        None for a rank outside the group or an empty shipment (every
        rank ships the same block count)."""
        import torch.distributed as dist
        if self.rank not in self.model_ranks or not rows.blocks:
            return None
        mine = _rows_bytes(rows.blocks)
        parts = [torch.empty_like(mine) for _ in self.model_ranks]
        work = dist.all_gather(parts, mine, group=self._slices,
                               async_op=True)
        self._keep(work, mine, *parts)
        order = sorted(self.model_ranks)
        return work, [parts[order.index(rank)] for rank in self.model_ranks]

    def gathered(self, rows) -> "_GatheredRows":
        return _GatheredRows(self, rows)

    def close(self) -> None:
        """Every rank at teardown: the lead tells the others the link
        closes; each waits (bounded) for its collectives and, another
        rank, for the lead's word."""
        if self._timer is not None:
            self._engine.remove_timer_handler(self._timer)
            self._timer = None
        if self.lead:
            self._broadcast(None)
        deadline = time.monotonic() + _LINK_TIMEOUT
        while time.monotonic() < deadline and (
                not all(work.is_completed() for work, _ in self._pending)
                or not (self.lead or self.closed)):
            if not self.lead:
                self.poll()
            time.sleep(0.001)


class _GatheredRows:
    """The lead's rows of one shipment and, once the gather of its model
    group's KV-head slices has completed, the whole blocks (`blocks`)."""

    def __init__(self, link, rows):
        self._link, self._rows = link, rows
        self._gather = None
        self._blocks = None

    def ready(self) -> bool:
        if self._blocks is not None:
            return True
        if not self._rows.ready():
            return False
        if self._gather is None:
            self._gather = self._link.gather(self._rows) or (None, None)
        work, parts = self._gather
        if work is None:
            self._blocks = self._rows.blocks
            return True
        if not work.is_completed():
            return False
        work.wait()
        self._blocks = _join_heads(self._rows.blocks, parts[1:])
        return True

    def wait(self) -> None:
        self._rows.wait()
        deadline = time.monotonic() + _LINK_TIMEOUT
        while not self.ready():
            if time.monotonic() > deadline:
                raise RuntimeError("the KV-head slices' gather never "
                                   "completed")
            time.sleep(0.001)

    @property
    def blocks(self):
        return self._blocks


def _queue_rows(outbox, link, rows, send) -> None:
    """Queue a shipment's rows: send(blocks) posts them once they are on
    the host; on the lead of a mesh once joined into whole blocks
    (link.gathered); another rank of a mesh joins the gather of its KV
    heads to the lead instead, and posts nothing."""
    if link is not None and not link.lead:
        outbox.put(rows, lambda: link.gather(rows))
        return
    if link is not None:
        rows = link.gathered(rows)
    outbox.put(rows, lambda: send(rows.blocks))


def _whole_layout(layout, heads: int) -> tuple:
    """A rank's wire layout with its KV heads multiplied back to the
    model's (`heads` ranks' slices): what an envelope of whole blocks
    declares."""
    layout = list(layout)
    layout[1] = str(int(layout[1]) * heads)
    return tuple(layout)


def _prompt_cap(decoder) -> int:
    """The prompt length decoder.submit admits (its tail-truncation
    cap).  Both sides truncate with this before keying anything, so the
    harvested chain, the shipped tokens and the decode-side probe agree
    on one prompt."""
    if decoder.prefill_chunk:
        return decoder.max_seq - 1
    return min(decoder.max_seq - 1, decoder.prefill_buckets[-1])


def _landing(wire_blocks) -> list:
    """Wire blocks -> install_chain's [{"k": per-layer, "v": ...}] form
    (install_chain stages the rows onto the device itself)."""
    return [{"k": [layer["k"] for layer in block],
             "v": [layer["v"] for layer in block]}
            for block in wire_blocks]


# -- the prefill pool --------------------------------------------------------

class PrefillRuntime(Actor):
    """A prefill-pool member: computes prompt KV and ships it.

    RPC (binary envelope on {topic_path}/in):
        (prefill transfer_id reply_topic tenant have_tokens
         {"tokens": i32[*]})
    The reply is a KV-transfer envelope on `reply_topic` carrying chain
    blocks [have_tokens / block, ...): blocks the caller declared it
    holds are handles, not bytes.

    The decoder is an ordinary ContinuousDecoder with a bound
    PrefixKVCache: a request prefills, emits one token, retires, and the
    retire harvest inserts its prompt blocks (repeated prefixes prefill
    once here too).  Its geometry must match the decode pool's; the
    transfer declares the donor layout and the decode side refuses a
    mismatch.

    A decoder sharded over a mesh of more than one rank takes a
    PrefillRuntime on every rank, built alike; the lead's (global rank
    0's) is the side's address.  The lead hands each request to the
    other ranks over its link (the section above _prompt_cap), every
    rank submits it and the decoder's round note agrees when it joins;
    the rounds, the harvest and the ship decisions are then the same on
    every rank, each rank of the lead's model group sends the lead its
    KV heads of every shipped block, and the lead alone posts the
    envelope of whole blocks, each the ranks' KV heads joined."""

    def __init__(self, runtime, name: str = "prefill", *,
                 params=None, config=None, decoder=None, cache=None,
                 block_tokens: int = 32, cache_mb: int = 256,
                 max_slots: int = 8, prefill_buckets=(128,),
                 steps_per_sync: int = 1,
                 prefill_chunk: int | None = None,
                 decoder_opts: dict | None = None,
                 pump_period: float = 0.002,
                 batch_window: float = 0.0,
                 chunk_stream: bool | None = None, registry=None):
        super().__init__(runtime, name, PROTOCOL_PREFILL,
                         tags=[role_tag(ROLE_PREFILL)])
        from .serving import ContinuousDecoder, PrefixKVCache
        self.logger = get_logger(f"disagg.prefill.{name}")
        self._registry = registry or default_registry()
        if decoder is not None:
            self.cache = cache if cache is not None \
                else decoder.prefix_cache
            self.decoder = decoder
        else:
            self.cache = cache or PrefixKVCache(
                block_tokens=int(block_tokens),
                max_bytes=int(cache_mb) << 20,
                name=f"{name}.cache", registry=self._registry)
            self.decoder = ContinuousDecoder(
                params, config, max_slots=int(max_slots),
                prefill_buckets=tuple(prefill_buckets),
                steps_per_sync=int(steps_per_sync),
                # chunked prefill forced on (the largest bucket): without
                # it the decoder truncates prompts to the bucket, the
                # harvest keys the truncated tail and a ship matches
                # nothing
                prefill_chunk=int(prefill_chunk)
                if prefill_chunk else max(prefill_buckets),
                name=name, prefix_cache=self.cache,
                registry=self._registry, **(decoder_opts or {}))
        if self.cache is None:
            raise ValueError(
                "PrefillRuntime needs a decoder with a bound "
                "PrefixKVCache (the harvest is what it ships)")

        # chunk streaming: ship each chunk's finished blocks as the chunk
        # lands, overlapping the transfer with the rest of the prefill.
        # On whenever chunked prefill is on
        if chunk_stream is None:
            chunk_stream = bool(self.decoder.prefill_chunk)
        self.chunk_stream = bool(chunk_stream)
        # pump_period <= 0 pumps flat-out (once per engine step) instead
        # of from a periodic timer (what the one-engine harness uses)
        self._flatout = pump_period is not None and pump_period <= 0
        if self._flatout:
            runtime.event.add_flatout_handler(self.decoder.pump)
        else:
            self.decoder.attach(runtime.event, period=pump_period)
        self._outbox = _Outbox(runtime.event)
        self._link = _MeshLink(
            runtime.event, self.decoder.mesh, self._on_link_call,
            pump_period if pump_period and pump_period > 0 else 0.002) \
            if self.decoder.sharded else None
        self.stats = MirroredStats(
            {"requests": 0, "computed": 0, "blocks_shipped": 0,
             "bytes_shipped": 0, "handle_blocks": 0, "refused": 0,
             "empty_ships": 0, "envelopes": 0, "batched_envelopes": 0,
             "chunks_shipped": 0, "chunk_blocks": 0},
            metric="prefill_runtime_events_total",
            help="prefill-runtime events by kind",
            registry=self._registry, skip=("bytes_shipped",),
            labels={"runtime": name})
        # transfers to one destination finishing within batch_window
        # seconds coalesce into one kv_transfer_batch envelope; 0 ships
        # each on its own
        self.batch_window = max(0.0, float(batch_window))
        self._ship_queue: dict[str, list] = {}
        self._ship_timers: dict[str, int] = {}
        self._batched_counter = self._registry.counter(
            "disagg_transfer_batched_total",
            "KV transfers that rode a coalesced batch envelope",
            labels={"runtime": name})
        # the prefill pool's own scale signal: prompts waiting for KV
        self._queue_gauge = self._registry.gauge(
            "prefill_queue_depth",
            "prompts queued or resident in the prefill runtime",
            labels={"runtime": name})

    def _publish_depth(self) -> None:
        self._queue_gauge.set(len(self.decoder._pending) +
                              self.decoder.active_count)

    # -- RPC ---------------------------------------------------------------
    def prefill(self, transfer_id, reply_topic, tenant, have_tokens,
                box) -> None:
        """Compute prompt KV for `tokens` and ship the chain blocks the
        caller does not hold already.  On a mesh the lead hands the
        request to every other rank first; another rank takes requests
        from the lead alone."""
        self.stats["requests"] += 1
        try:
            tokens = [int(t) for t in np.asarray(box["tokens"])]
            have = max(0, int(str(have_tokens)))
        except (TypeError, KeyError, ValueError) as exc:
            self.stats["refused"] += 1
            self.logger.warning("prefill %s: malformed request %r: %r",
                                self.name, transfer_id, exc)
            return
        if self._link is not None:
            if not self._link.lead:
                self.stats["refused"] += 1
                self.logger.warning(
                    "prefill %s: request %r sent to rank %d, not the "
                    "lead of its mesh: refused", self.name, transfer_id,
                    self._link.rank)
                return
            self._link.call(("prefill", (str(transfer_id),
                                         str(reply_topic), str(tenant),
                                         have, tokens)))
        self._prefill(transfer_id, reply_topic, tenant, have, tokens)

    def _on_link_call(self, message) -> None:
        """Another rank of a mesh: a request the lead handed over."""
        name, args = message
        if name == "prefill":
            self.stats["requests"] += 1
            self._prefill(*args)

    def _wire_layout(self) -> tuple:
        """The layout an envelope declares: the cache's, on a mesh with
        the model's KV heads (the lead ships whole blocks)."""
        layout = self.cache.wire_layout()
        return layout if self._link is None else \
            _whole_layout(layout, self._link.heads)

    def _prefill(self, transfer_id, reply_topic, tenant, have: int,
                 tokens) -> None:
        # truncate exactly as decoder.submit will, so the harvest, the
        # match and the shipped tokens key one prompt
        tokens = tokens[-_prompt_cap(self.decoder):] or [0]
        tenant = str(tenant)
        context = tracing.current_trace()
        # the chunk-stream cursor: the next chain block to ship, shared
        # by the progress callback and the final ship so each block
        # crosses once
        state = {"cursor": None}

        def computed(_rid, generated):
            self._publish_depth()
            with tracing.activate(context):
                self._ship(str(transfer_id), str(reply_topic), tenant,
                           have, tokens,
                           int(generated[0]) if generated else None,
                           cursor=state["cursor"])

        progress = None
        if self.chunk_stream:
            def progress(request, finished):
                if finished:
                    return   # the final ship (with first_token) owns it
                with tracing.activate(context):
                    self._ship_chunk(str(transfer_id), str(reply_topic),
                                     tenant, have, tokens, request, state)

        def refused(_rid, _reason):
            # a decoder on a mesh refuses at its round note
            self.stats["refused"] += 1

        accepted = self.decoder.submit(str(transfer_id), tokens, 1,
                                       computed, tenant=tenant,
                                       progress_callback=progress,
                                       on_refused=refused)
        if not accepted:
            self.stats["refused"] += 1
        self._publish_depth()

    def _trace_fields(self):
        context = tracing.current_trace()
        return context.to_fields(self.runtime.event.clock.now()) \
            if context is not None else None

    def _ship(self, transfer_id: str, reply_topic: str, tenant: str,
              have: int, tokens, first_token, cursor=None) -> None:
        self.stats["computed"] += 1
        cache = self.cache
        block = cache.block_tokens
        keys, hit = cache.match(tenant, tokens)
        if hit == 0 and len(tokens) >= block:
            # the computed prompt left no cached chain (the budget
            # refused every insert): ship nothing, but say so
            self.stats["empty_ships"] += 1
            self.logger.warning(
                "prefill %s: transfer %s computed %d tokens but the "
                "cache holds none of its chain; shipping empty",
                self.name, transfer_id, len(tokens))
        start_block = min(have // block, hit // block)
        # handle accounting keys on the caller's holdings, before the
        # chunk cursor moves the window
        self.stats["handle_blocks"] += start_block
        if cursor:
            # chunk streaming shipped the blocks below the cursor; the
            # final envelope carries the tail (and first_token, always)
            start_block = min(max(start_block, int(cursor)), hit // block)
        rows = _chain_wire_blocks(cache, keys[start_block:hit // block])
        trace, layout = self._trace_fields(), self._wire_layout()

        def send(blocks):
            payload = wire.encode_kv_transfer(
                transfer_id, tenant, tokens, start_block, block, layout,
                blocks, first_token=first_token, trace=trace)
            self.stats["blocks_shipped"] += len(blocks)
            self.stats["bytes_shipped"] += len(payload)
            self._post(reply_topic, payload)
        _queue_rows(self._outbox, self._link, rows, send)

    def _ship_chunk(self, transfer_id: str, reply_topic: str,
                    tenant: str, have: int, tokens, request,
                    state: dict) -> None:
        """Ship the chain blocks a finished prefill chunk made durable.
        Runs from the decoder's progress callback while the request is
        resident: its rows harvest into the cache first and ship from
        there, by the final ship's path."""
        cache = self.cache
        block = cache.block_tokens
        self.decoder.harvest_progress(request)
        pos = int(request.prefill_pos)
        keys, hit = cache.match(tenant, list(tokens[:pos]))
        if state["cursor"] is None:
            # blocks the caller holds never ship: start at the handle
            # boundary
            state["cursor"] = min(have // block, hit // block)
        cursor = state["cursor"]
        end = hit // block
        if end <= cursor:
            return
        rows = _chain_wire_blocks(cache, keys[cursor:end])
        trace, layout = self._trace_fields(), self._wire_layout()
        state["cursor"] = end
        self.stats["chunks_shipped"] += 1

        def send(blocks):
            payload = wire.encode_kv_transfer(
                transfer_id, tenant, list(tokens[:end * block]), cursor,
                block, layout, blocks, final=False, trace=trace)
            self.stats["chunk_blocks"] += len(blocks)
            self.stats["blocks_shipped"] += len(blocks)
            self.stats["bytes_shipped"] += len(payload)
            self._post(reply_topic, payload)
        _queue_rows(self._outbox, self._link, rows, send)

    def _post(self, reply_topic: str, payload: bytes) -> None:
        """Ship one envelope: at once, or coalesced with others to the
        same destination inside the batch window.  It rides the peer
        channel when the caller's reply topic is pinned, else the
        broker."""
        if self.batch_window <= 0:
            self.stats["envelopes"] += 1
            self.runtime.publish(reply_topic, payload)
            return
        queue = self._ship_queue.setdefault(reply_topic, [])
        queue.append(payload)
        if reply_topic not in self._ship_timers:
            self._ship_timers[reply_topic] = \
                self.runtime.event.add_oneshot_handler(
                    lambda: self._flush_ships(reply_topic),
                    self.batch_window)

    def _flush_ships(self, reply_topic: str) -> None:
        self._ship_timers.pop(reply_topic, None)
        payloads = self._ship_queue.pop(reply_topic, None)
        if not payloads:
            return
        self.stats["envelopes"] += 1
        if len(payloads) == 1:
            self.runtime.publish(reply_topic, payloads[0])
            return
        self.stats["batched_envelopes"] += 1
        self._batched_counter.inc(len(payloads))
        self.runtime.publish(reply_topic, wire.encode_kv_batch(payloads))

    def stop(self) -> None:
        self._outbox.flush()                 # owed transfers ship now
        for reply_topic, timer in list(self._ship_timers.items()):
            self.runtime.event.remove_timer_handler(timer)
            self._ship_timers.pop(reply_topic, None)
            self._flush_ships(reply_topic)
        if self._flatout:
            self.runtime.event.remove_flatout_handler(self.decoder.pump)
        else:
            self.decoder.detach(self.runtime.event)
        if self._link is not None:
            self._link.close()
        super().stop()


# -- the decode side ---------------------------------------------------------

class PrefillClient:
    """The decode side of the split: remote prefill with a local
    fallback ladder.

    submit() routes the prompt to a discovered prefill runtime
    (deadline-aware, least-loaded under pressure); on the KV-transfer
    reply it installs the chain into the decode decoder's PrefixKVCache
    (or, cacheless and paged, into its pool) and submits the request,
    which admits as a prefix hit: only the ragged suffix prefills here.
    Failures degrade in order: a retry against another candidate, then
    local prefill on the decode runtime.  Every rung is counted; none
    drops the request.  Single-threaded on the owning runtime's engine,
    like the decoder it feeds.

    On a mesh (the decoder's, one rank included) every rank's client is
    handed every request, and rank 0's alone sends it, owns its
    transfer's timeout, retries and local fallback, and reads its clock
    and cache: what it decides (a streamed chunk's or the final
    envelope's landing, with the shipped rows, a fallback to local
    prefill, a retry's release of streamed blocks) rides the decoder's
    round note (a note hook), and every rank applies it in that round,
    once every rank holds the request.  A landing installs each rank's
    own KV heads of the rows (ContinuousDecoder.shard_kv_blocks) and
    submits the request, agreed at once with rank 0's verdict and
    deadline (admit_agreed); its admit, at the next round, is ordered
    after the install's copies by the stream.  The other ranks' clients
    send nothing."""

    def __init__(self, runtime, decoder, services_cache=None,
                 name: str = "disagg",
                 transfer_timeout: float = 5.0, retries: int = 1,
                 urgent_budget_s: float = 1.0,
                 min_remote_tokens: int | None = None,
                 registry=None):
        if decoder.prefix_cache is None and \
                not getattr(decoder, "paged", False):
            raise ValueError(
                "PrefillClient needs a decoder with a bound "
                "PrefixKVCache, or a paged decoder (the shipped KV has "
                "to land somewhere: a cache chain or a direct slot-table "
                "install)")
        self.runtime = runtime
        self.decoder = decoder
        # cacheless paged decoders land shipped KV by
        # install_shipped_blocks: pool blocks aliased into the request's
        # slot table
        self.cache = decoder.prefix_cache
        self.block_tokens = self.cache.block_tokens \
            if self.cache is not None else decoder.kv_block
        self.name = str(name)
        self.logger = get_logger(f"disagg.client.{name}")
        self.transfer_timeout = float(transfer_timeout)
        self.retries = max(0, int(retries))
        # a prompt shorter than one block has nothing to ship
        self.min_remote_tokens = int(min_remote_tokens) \
            if min_remote_tokens is not None else self.block_tokens
        self._registry = registry or default_registry()
        self.router = DeadlineRouter(urgent_budget_s=urgent_budget_s,
                                     name=name, registry=self._registry)
        self.loads: dict[str, int] = {}     # topic_path -> in flight
        self._endpoints: dict[str, str | None] = {}
        self._pending: dict[str, dict] = {}
        self.reply_topic = \
            f"{runtime.topic_path}/0/kv.{uuid.uuid4().hex[:8]}"
        runtime.add_message_handler(self._on_reply, self.reply_topic,
                                    binary=True)
        self.stats = MirroredStats(
            {"transfers": 0, "transfer_bytes": 0, "installs": 0,
             "installed_blocks": 0, "handle_blocks": 0,
             "raw_blocks": 0, "retries": 0, "transfer_timeouts": 0,
             "transfer_corrupt": 0, "layout_mismatch": 0,
             "local_fallbacks": 0, "local_short": 0,
             "local_no_pool": 0, "local_cached": 0,
             "install_shed": 0, "direct_installs": 0,
             "batched_replies": 0, "chunk_installs": 0,
             "chunk_blocks": 0, "chunk_dropped": 0,
             "chunk_streamed": 0, "transfer_overlap_s": 0.0},
            metric="disagg_client_events_total",
            help="disaggregated serving client events by kind",
            registry=self._registry,
            skip=("transfer_bytes", "transfer_overlap_s"),
            labels={"client": name})
        self._transfer_seconds = self._registry.histogram(
            "disagg_transfer_seconds",
            "prefill request -> installed KV wall seconds",
            labels={"client": name})
        self.transfer_samples: deque = deque(maxlen=4096)
        # on a mesh: each rank's requests awaiting rank 0's decision (by
        # request id), and rank 0's decisions not yet applied, numbered
        self.agreed = bool(getattr(decoder, "agreed", False))
        self.lead = True
        self._held: dict[str, dict] = {}
        self._decisions: list = []
        self._decided = 0
        if self.agreed:
            if decoder.sharded:
                import torch.distributed as dist
                self.lead = dist.get_rank(decoder._agree_group) == 0
            decoder.add_note_hook(self._note_propose, self._note_apply,
                                  self._note_pending, every=True)
        self._cache_handler = None
        if services_cache is not None:
            self._services_cache = services_cache
            self._cache_handler = self._on_discovery
            # protocol and role: a pipeline tagged role=prefill has no
            # `prefill` RPC, and a transfer routed there would stall a
            # whole timeout
            services_cache.add_handler(
                self._cache_handler,
                ServiceFilter(protocol=str(PROTOCOL_PREFILL),
                              tags=[role_tag(ROLE_PREFILL)]))

    # -- discovery ---------------------------------------------------------
    def _on_discovery(self, command, fields) -> None:
        if command == "add":
            self.loads.setdefault(fields.topic_path, 0)
            endpoint = ServiceTags.to_dict(fields.tags).get("peer")
            self._endpoints[fields.topic_path] = endpoint
            if endpoint and self.runtime.peer is not None:
                # pin the transfer path onto a direct channel: our
                # requests to its /in, its KV replies to our reply topic;
                # the broker stays the standing fallback
                try:
                    self.runtime.peer.negotiate(
                        fields.topic_path, endpoint,
                        pin_topics=[f"{fields.topic_path}/in"],
                        reply_topics=[self.reply_topic])
                except Exception:
                    self.logger.exception(
                        "disagg %s: peer negotiation with %s failed; "
                        "the broker path stays", self.name,
                        fields.topic_path)
        elif command == "remove":
            self.loads.pop(fields.topic_path, None)
            self._endpoints.pop(fields.topic_path, None)
            if self.runtime.peer is not None:
                self.runtime.peer.release(f"{fields.topic_path}/in")

    def add_candidate(self, topic_path: str,
                      endpoint: str | None = None) -> None:
        """Register a prefill runtime by hand (static fleets, tests)."""
        self.loads.setdefault(topic_path, 0)
        self._endpoints[topic_path] = endpoint

    # -- submit path -------------------------------------------------------
    def submit(self, request_id: str, prompt, max_new_tokens: int,
               callback, deadline: float | None = None,
               tenant: str | None = None, on_refused=None) -> bool:
        """Route one request through the split.  True when it is in
        flight somewhere (a remote transfer pending, or submitted
        locally); False only when the decoder's own deadline admission
        refused a synchronous local submit (the caller owns that
        refusal, as with ContinuousDecoder.submit)."""
        # truncate with the decode decoder's own cap first: the probe,
        # the shipped tokens and the final submit must key one prompt
        prompt = ([int(t) for t in prompt] or
                  [0])[-_prompt_cap(self.decoder):]
        tenant_key = str(tenant or "")
        # synchronous local rungs return the refusal (notify=False):
        # calling on_refused too would signal one shed twice
        if len(prompt) < self.min_remote_tokens:
            self.stats["local_short"] += 1
            return self._local(request_id, prompt, max_new_tokens,
                               callback, deadline, tenant, on_refused,
                               notify=False)
        entry = {
            "request_id": str(request_id), "prompt": prompt,
            "max_new": int(max_new_tokens), "callback": callback,
            "deadline": deadline, "tenant": tenant,
            "on_refused": on_refused, "attempts": 0,
            "started": time.perf_counter(),
            "trace": tracing.current_trace(),
        }
        if self.agreed:
            if entry["request_id"] in self._held:
                raise ValueError(
                    f"request id {request_id!r} is in flight already: "
                    f"the ranks of a mesh agree a transfer by request id")
            self._held[entry["request_id"]] = entry
            if not self.lead:
                return True         # rank 0 decides; the note applies
        have = 0
        if self.cache is not None:
            _, have = self.cache.match(tenant_key, prompt)
            complete = (len(prompt) // self.block_tokens) * \
                self.block_tokens
            if have < complete and self.cache.tiered:
                # the probe kicks promotion of host-resident chain
                # blocks while the transfer is in flight
                self.cache.prefetch(tenant_key, prompt)
            if complete and have >= complete:
                # the decode side holds the whole chain: a remote hop
                # would ship nothing, so prefix-admit locally
                return self._effect("local", entry, stat="local_cached",
                                    notify=False)
        remaining = None
        if deadline is not None:
            remaining = float(deadline) - time.monotonic()
        target = self.router.route(self.loads, remaining)
        if target is None:
            return self._effect("local", entry, stat="local_no_pool",
                                notify=False)
        transfer_id = f"kv-{uuid.uuid4().hex[:12]}"
        entry["target"] = target
        self._pending[transfer_id] = entry
        self._send(transfer_id, entry, target, have)
        return True

    def _send(self, transfer_id: str, entry: dict, target: str,
              have: int) -> None:
        entry["target"] = target
        entry["timer"] = self.runtime.event.add_oneshot_handler(
            lambda: self._transfer_expired(transfer_id),
            self.transfer_timeout)
        self.loads[target] = self.loads.get(target, 0) + 1
        self.stats["transfers"] += 1
        context = entry.get("trace")
        payload = wire.encode_envelope(
            "prefill",
            [transfer_id, self.reply_topic,
             str(entry["tenant"] or ""), str(int(have)),
             {"tokens": np.asarray(entry["prompt"], np.int32)}],
            trace=context.to_fields(self.runtime.event.clock.now())
            if context is not None else None)
        self.runtime.publish(f"{target}/in", payload)

    def _settle(self, transfer_id: str):
        entry = self._pending.pop(transfer_id, None)
        if entry is None:
            return None
        timer = entry.pop("timer", None)
        if timer is not None:
            self.runtime.event.remove_timer_handler(timer)
        target = entry.get("target")
        if target in self.loads:
            self.loads[target] = max(0, self.loads[target] - 1)
        return entry

    def _drop_chunks(self, entry: dict) -> None:
        """Forget a transfer's streamed-chunk progress.  Cache installs
        stay (content-addressed: a retry's have probe reuses them);
        direct pool blocks belong to the stream and are released (on a
        mesh by every rank, at the note)."""
        entry.pop("chunk_next", None)
        entry.pop("chunk_first", None)
        entry.pop("chunk_base", None)
        self._effect("drop", entry)

    def _release_direct(self, entry: dict) -> None:
        ids = entry.pop("direct_ids", None)
        if ids:
            self.decoder.pool.release_blocks(
                ids, tenant=str(entry.get("tenant") or ""))

    # -- the fallback ladder ----------------------------------------------
    def _transfer_expired(self, transfer_id: str) -> None:
        entry = self._pending.get(transfer_id)
        if entry is None:
            return
        entry.pop("timer", None)
        target = entry.get("target")
        if target in self.loads:
            self.loads[target] = max(0, self.loads[target] - 1)
        self.stats["transfer_timeouts"] += 1
        if entry["attempts"] < self.retries:
            # rung 1: retry against another candidate (a late duplicate
            # transfer from the first only re-confirms cached blocks)
            entry["attempts"] += 1
            others = {c: load for c, load in self.loads.items()
                      if c != target}
            remaining = None
            if entry["deadline"] is not None:
                remaining = float(entry["deadline"]) - time.monotonic()
            retry_target = self.router.route(others or self.loads,
                                             remaining)
            if retry_target is not None:
                self.stats["retries"] += 1
                self._drop_chunks(entry)      # the retry streams afresh
                have = 0
                if self.cache is not None:
                    _, have = self.cache.match(
                        str(entry["tenant"] or ""), entry["prompt"])
                self._send(transfer_id, entry, retry_target, have)
                return
        # rung 2: local prefill, counted, never dropped
        self._pending.pop(transfer_id, None)
        self._drop_chunks(entry)
        self.logger.warning(
            "disagg %s: transfer %s to %s gave up after %d attempt(s); "
            "prefilling locally", self.name, transfer_id, target,
            entry["attempts"] + 1)
        self._effect("local", entry, stat="local_fallbacks")

    def _local_entry(self, entry: dict) -> bool:
        return self._local(entry["request_id"], entry["prompt"],
                           entry["max_new"], entry["callback"],
                           entry["deadline"], entry["tenant"],
                           entry["on_refused"])

    def _in_range(self, out: dict) -> int:
        """How many of a transfer's blocks its tokens cover (the ones an
        install writes)."""
        return max(0, len(out["tokens"]) // self.block_tokens -
                   int(out["start_block"]))

    # -- decisions: applied at once, or on a mesh at the round note ---------
    def _effect(self, kind: str, entry: dict, **args):
        """Apply one decision ("local", "chunk", "land", "drop") to
        `entry` now; on a mesh queue it for the decoder's next round
        note, where every rank applies it (_note_apply).  Returns what
        a local submit returned (True when queued)."""
        if self.agreed:
            self._decided += 1
            self._decisions.append((self._decided, kind,
                                    entry["request_id"], args))
            return True
        return getattr(self, f"_apply_{kind}")(entry, **args)

    def _apply_local(self, entry: dict, stat=(), notify: bool = True,
                     verdict=None) -> bool:
        """The local-prefill rung for `entry`, counting `stat` (a name
        or names); on a mesh (`verdict`: rank 0's shed verdict and
        deadline) the request is agreed at once."""
        for name in (stat,) if isinstance(stat, str) else stat:
            self.stats[name] += 1
        accepted = self._local(entry["request_id"], entry["prompt"],
                               entry["max_new"], entry["callback"],
                               entry["deadline"], entry["tenant"],
                               entry["on_refused"], notify=notify)
        if verdict is not None:
            self.decoder.admit_agreed(entry["request_id"], *verdict)
        return accepted

    def _apply_drop(self, entry: dict, verdict=None) -> None:
        entry.pop("applied_next", None)
        self._release_direct(entry)

    def _note_pending(self) -> bool:
        """An idle decoder makes round notes while a request waits for
        rank 0's decision, or one waits to be applied."""
        return bool(self._held) or bool(self._decisions)

    def _note_propose(self) -> dict:
        """This rank's part of the note: the requests it holds; rank 0's
        adds its decisions, each submitting one with rank 0's verdict
        (shed or not, by its clock and admit-wait estimate, as an
        arrival's) and deadline."""
        value = {"held": sorted(self._held)}
        if self.lead and self._decisions:
            now = time.monotonic()
            decisions = []
            for number, kind, request_id, args in self._decisions:
                entry = self._held.get(request_id)
                if kind in ("local", "land") and entry is not None:
                    deadline = entry["deadline"]
                    wait = self.decoder.estimated_admit_wait(
                        prompt=entry["prompt"],
                        tenant=str(entry["tenant"] or ""))
                    shed = deadline is not None and wait is not None and \
                        now + wait >= float(deadline)
                    args = {**args, "verdict": (shed, deadline)}
                decisions.append((number, kind, request_id, args))
            value["decisions"] = decisions
        return value

    def _note_apply(self, values: list) -> None:
        """Apply rank 0's decisions on this rank, in order, for the
        requests every rank holds (a later decision of a request some
        rank does not hold yet waits with it); a request leaves the held
        set at its landing or fallback."""
        held = set.intersection(*(set(value["held"]) for value in values))
        waiting, applied = set(), set()
        for number, kind, request_id, args in \
                values[0].get("decisions", ()):
            if request_id not in held or request_id in waiting:
                waiting.add(request_id)
                continue
            entry = self._held[request_id]
            if kind in ("local", "land"):
                del self._held[request_id]
            getattr(self, f"_apply_{kind}")(entry, **args)
            applied.add(number)
        if applied:
            self._decisions = [decision for decision in self._decisions
                               if decision[0] not in applied]

    def _local(self, request_id, prompt, max_new, callback, deadline,
               tenant, on_refused, notify: bool = True) -> bool:
        """The local-prefill rung.  `notify` fires on_refused on a shed:
        True only on asynchronous paths (timeout fallback, reply
        install, teardown) where submit() returned long ago.  A decoder
        on a mesh refuses at its round note, after every path has
        returned, so that refusal always fires on_refused."""
        def refused(rid, _reason):
            self.stats["install_shed"] += 1
            if on_refused is not None:
                on_refused(rid)

        accepted = self.decoder.submit(request_id, prompt, max_new,
                                       callback, deadline=deadline,
                                       tenant=tenant, on_refused=refused)
        if not accepted:
            self.stats["install_shed"] += 1
            if notify and on_refused is not None:
                on_refused(request_id)
        return accepted

    # -- KV admit (the reply path) -----------------------------------------
    def _on_reply(self, _topic, payload) -> None:
        try:
            command, params = wire.decode_envelope(payload)
        except wire.WireError as exc:
            # a truncated or foreign payload: dropped; the transfer timer
            # retries, then the ladder prefills locally
            self.stats["transfer_corrupt"] += 1
            self.logger.warning("disagg %s: corrupt KV transfer "
                                "dropped: %s", self.name, exc)
            return
        if command == wire.KV_BATCH_COMMAND:
            # coalesced transfers: each member runs the lone envelope's
            # validation and install, so a corrupt member fails alone
            try:
                members = wire.kv_batch_members(command, params)
            except wire.WireError as exc:
                self.stats["transfer_corrupt"] += 1
                self.logger.warning(
                    "disagg %s: corrupt KV transfer batch dropped: %s",
                    self.name, exc)
                return
            self.stats["batched_replies"] += 1
            for member in members:
                try:
                    inner_command, inner_params = \
                        wire.decode_envelope(member)
                except wire.WireError as exc:
                    self.stats["transfer_corrupt"] += 1
                    self.logger.warning(
                        "disagg %s: corrupt batch member dropped: %s",
                        self.name, exc)
                    continue
                self._handle_transfer(member, inner_command, inner_params)
            return
        self._handle_transfer(payload, command, params)

    def _local_layout(self) -> tuple:
        """The layout a transfer must declare: the cache's (or the
        cacheless decoder's); on a mesh the model's, whose KV heads
        each rank cuts to its own at the install."""
        if self.cache is not None and \
                getattr(self.decoder, "kv_heads", None) is None:
            return self.cache.wire_layout()
        return self.decoder.kv_wire_layout()

    def _handle_transfer(self, payload, command, params) -> None:
        try:
            out = wire.validate_kv_transfer_params(command, params)
        except wire.WireError as exc:
            self.stats["transfer_corrupt"] += 1
            self.logger.warning("disagg %s: corrupt KV transfer "
                                "dropped: %s", self.name, exc)
            return
        if not out.get("final", True):
            # a streamed chunk: install it without settling (the final
            # envelope still owes first_token and the submit)
            self._handle_chunk(payload, out)
            return
        entry = self._settle(out["transfer_id"])
        if entry is None:
            return              # a late duplicate after timeout/fallback
        # out["first_token"] goes unused: the decode-side suffix extend
        # recomputes the first token, so parity never depends on donor
        # state (the field is a wire-level diagnostic)
        elapsed = time.perf_counter() - entry["started"]
        self.stats["transfer_bytes"] += len(payload)
        self._transfer_seconds.observe(elapsed)
        self.transfer_samples.append(elapsed)
        local_layout = self._local_layout()
        if out["blocks"] and \
                tuple(str(f) for f in out["layout"]) != local_layout:
            self.logger.warning(
                "disagg %s: transfer %s layout %r does not match the "
                "decode cache %r; prefilling locally", self.name,
                out["transfer_id"], out["layout"], local_layout)
            self._drop_chunks(entry)
            self._effect("local", entry,
                         stat=("layout_mismatch", "local_fallbacks"))
            return
        blocks = _landing(out["blocks"])
        try:
            for block in blocks[:self._in_range(out)]:
                check_block_geometry(local_layout, self.block_tokens, block)
        except (ValueError, TypeError, IndexError) as exc:
            self._refused_install(entry, out["transfer_id"], exc)
            return
        # a streamed transfer's final start_block sits at the chunk
        # cursor: only blocks below the stream's low-water mark crossed
        # as handles
        handle = out["start_block"]
        base = entry.get("chunk_base")
        if base is not None:
            handle = min(handle, int(base))
        self._effect("land", entry, tokens=out["tokens"],
                     start=out["start_block"], blocks=blocks,
                     handle=handle, raw=len(out["blocks"]),
                     transfer_id=out["transfer_id"], nbytes=len(payload),
                     elapsed=elapsed)

    def _refused_install(self, entry: dict, transfer_id: str, exc) -> None:
        # schema-legal but geometry-wrong blocks are refused before any
        # row lands; the ladder prefills locally
        self.logger.warning(
            "disagg %s: transfer %s refused at install (%s); "
            "prefilling locally", self.name, transfer_id, exc)
        self._drop_chunks(entry)
        self._effect("local", entry,
                     stat=("transfer_corrupt", "local_fallbacks"))

    def _apply_land(self, entry: dict, tokens, start: int, blocks,
                    handle: int, raw: int, transfer_id: str, nbytes: int,
                    elapsed: float, verdict=None) -> None:
        """Install a final envelope's blocks (this rank's KV heads of
        them on a mesh) and submit the request."""
        tenant_key = str(entry["tenant"] or "")
        direct_ids: list = []
        try:
            if self.cache is not None:
                installed = self.cache.install_chain(
                    tenant_key, tokens, start,
                    self.decoder.shard_kv_blocks(blocks))
            else:
                # direct slot-table install: streamed chunks landed a
                # contiguous prefix already; the final span must continue
                # it exactly (the ordered-cursor guard), or the prefix
                # alone is used
                prior = entry.get("direct_ids") or []
                if prior and entry.get("applied_next") == start:
                    _, ids = self.decoder.install_shipped_blocks(
                        tokens, start, blocks, tenant=tenant_key)
                    direct_ids = prior + ids
                elif prior:
                    self.stats["chunk_dropped"] += 1
                    direct_ids = prior
                else:
                    if start != 0:
                        raise ValueError(
                            "direct install cannot start mid-chain "
                            f"(start_block={start}) with no streamed "
                            "prefix")
                    _, direct_ids = self.decoder.install_shipped_blocks(
                        tokens, 0, blocks, tenant=tenant_key)
                entry.pop("direct_ids", None)
                installed = len(direct_ids)
                self.stats["direct_installs"] += 1
        except (ValueError, TypeError, IndexError) as exc:
            self.logger.warning(
                "disagg %s: transfer %s refused at install (%s); "
                "prefilling locally", self.name, transfer_id, exc)
            self._release_direct(entry)
            self._apply_local(entry, ("transfer_corrupt",
                                      "local_fallbacks"), True, verdict)
            return
        self.stats["installs"] += 1
        self.stats["installed_blocks"] += installed
        self.stats["handle_blocks"] += handle
        self.stats["raw_blocks"] += raw
        chunk_first = entry.get("chunk_first")
        if chunk_first is not None:
            # the stream began landing KV while the donor was prefilling:
            # the time since the first chunk was hidden behind compute
            self.stats["chunk_streamed"] += 1
            self.stats["transfer_overlap_s"] += \
                max(0.0, time.perf_counter() - chunk_first)
        trc = tracing.tracer
        if trc.enabled and entry.get("trace") is not None:
            trc.record("kv_transfer", entry["started"], elapsed,
                       context=entry["trace"], cat="disagg",
                       proc=self.name, span_id=tracing.new_span_id(),
                       args={"bytes": nbytes, "raw_blocks": raw,
                             "handle_blocks": start,
                             "installed": installed})
        # the decode-side submit: the probe longest-matches the installed
        # chain (paged: aliases its pool blocks) and only the ragged
        # suffix prefills; a cacheless pool hands the ids over instead.
        # Labelled "remote" for the TTFT sketches and journeys
        with tracing.activate(entry.get("trace")):
            if self.cache is None:
                covered = installed * self.decoder.kv_block
                self._submit_installed(entry,
                                       kv_blocks=(covered, direct_ids),
                                       verdict=verdict)
            else:
                self._submit_installed(entry, verdict=verdict)

    def _handle_chunk(self, payload, out: dict) -> None:
        """Install one streamed chunk of a pending transfer.  Chunks are
        best effort: a gap, a layout drift or an install refusal drops
        the chunk and leaves correctness to the final envelope's ladder
        (cache installs are content-addressed; direct installs keep only
        a contiguous-from-zero prefix)."""
        transfer_id = out["transfer_id"]
        entry = self._pending.get(transfer_id)
        if entry is None:
            return          # a late chunk after settle/timeout/fallback
        if not out["blocks"] or \
                tuple(str(f) for f in out["layout"]) != \
                self._local_layout():
            self.stats["chunk_dropped"] += 1
            return
        expected = entry.get("chunk_next")
        if expected is not None and out["start_block"] != expected:
            # the ordered-cursor guard: a lost sibling left a gap
            self.stats["chunk_dropped"] += 1
            return
        if self.cache is None and expected is None and \
                out["start_block"] != 0:
            # a direct stream is usable only from block 0
            self.stats["chunk_dropped"] += 1
            return
        blocks = _landing(out["blocks"])
        try:
            for block in blocks[:self._in_range(out)]:
                check_block_geometry(self._local_layout(),
                                     self.block_tokens, block)
        except (ValueError, TypeError, IndexError) as exc:
            self.stats["chunk_dropped"] += 1
            self.logger.warning(
                "disagg %s: streamed chunk for %s refused at install "
                "(%s); dropped", self.name, transfer_id, exc)
            return
        if "chunk_first" not in entry:
            entry["chunk_first"] = time.perf_counter()
            # the stream's low-water mark: blocks below it crossed as
            # handles, blocks above it as streamed bytes
            entry["chunk_base"] = out["start_block"]
        entry["chunk_next"] = out["start_block"] + len(out["blocks"])
        self.stats["transfer_bytes"] += len(payload)
        self._effect("chunk", entry, tokens=out["tokens"],
                     start=out["start_block"], blocks=blocks)
        # a streaming donor is alive: restart the timeout per chunk, so
        # a long prompt's stream outlives a budget sized for one envelope
        timer = entry.pop("timer", None)
        if timer is not None:
            self.runtime.event.remove_timer_handler(timer)
            entry["timer"] = self.runtime.event.add_oneshot_handler(
                lambda: self._transfer_expired(transfer_id),
                self.transfer_timeout)

    def _apply_chunk(self, entry: dict, tokens, start: int, blocks,
                     verdict=None) -> None:
        """Install one streamed chunk's blocks (this rank's KV heads of
        them on a mesh)."""
        tenant_key = str(entry["tenant"] or "")
        try:
            if self.cache is not None:
                installed = self.cache.install_chain(
                    tenant_key, tokens, start,
                    self.decoder.shard_kv_blocks(blocks))
            else:
                _, ids = self.decoder.install_shipped_blocks(
                    tokens, start, blocks, tenant=tenant_key)
                entry.setdefault("direct_ids", []).extend(ids)
                installed = len(ids)
        except (ValueError, TypeError, IndexError) as exc:
            self.stats["chunk_dropped"] += 1
            self.logger.warning(
                "disagg %s: streamed chunk for %s refused at install "
                "(%s); dropped", self.name, entry["request_id"], exc)
            return
        entry["applied_next"] = start + len(blocks)
        self.stats["chunk_installs"] += 1
        self.stats["chunk_blocks"] += installed
        self.stats["raw_blocks"] += len(blocks)

    def _submit_installed(self, entry: dict,
                          kv_blocks: tuple | None = None,
                          verdict=None) -> None:
        def refused(rid, _reason):
            # a decoder on a mesh refuses at its round note, and releases
            # the request's installed blocks itself
            self.stats["install_shed"] += 1
            if entry["on_refused"] is not None:
                entry["on_refused"](rid)

        accepted = self.decoder.submit(
            entry["request_id"], entry["prompt"], entry["max_new"],
            entry["callback"], deadline=entry["deadline"],
            tenant=entry["tenant"], prefill_label="remote",
            kv_blocks=kv_blocks, on_refused=refused)
        if verdict is not None:
            self.decoder.admit_agreed(entry["request_id"], *verdict)
            return
        if not accepted:
            self.stats["install_shed"] += 1
            if kv_blocks is not None and kv_blocks[1]:
                # ownership never passed: the shed request must not leak
                # its installed pool blocks
                self.decoder.pool.release_blocks(
                    kv_blocks[1], tenant=str(entry["tenant"] or ""))
            if entry["on_refused"] is not None:
                entry["on_refused"](entry["request_id"])

    def handle_hit_rate(self) -> float:
        """Fraction of transferred chain blocks that crossed as handles
        instead of bytes (chains the decode side held)."""
        total = self.stats["handle_blocks"] + self.stats["raw_blocks"]
        return self.stats["handle_blocks"] / total if total else 0.0

    def pending_count(self) -> int:
        return len(self._pending)

    def stop(self) -> None:
        for transfer_id in list(self._pending):
            entry = self._settle(transfer_id)
            if entry is not None and not self.agreed:
                # teardown owes every in-flight request a local home
                self._drop_chunks(entry)
                self.stats["local_fallbacks"] += 1
                self._local_entry(entry)
        # on a mesh every rank gives each request it holds a local home
        # (submitted, so agreed by the decoder's note as any arrival)
        held, self._held, self._decisions = self._held, {}, []
        for entry in held.values():
            self._apply_drop(entry)
            self.stats["local_fallbacks"] += 1
            self._local_entry(entry)
        if self._cache_handler is not None:
            self._services_cache.remove_handler(self._cache_handler)
            self._cache_handler = None
        if self.runtime.peer is not None:
            # this client's reply topic must not be re-pinned on later
            # redials of the shared channel
            self.runtime.peer.unregister_reply_topic(self.reply_topic)
        self.runtime.remove_message_handler(self._on_reply,
                                            self.reply_topic)


# -- session migration -------------------------------------------------------

class SessionMigrator:
    """Both halves of session KV migration.

    A draining runtime's sessions (pinned prefix-cache chains and their
    SessionTable records) ship to a destination, so a migrated
    conversation's next turn is a prefix hit there, not a full
    re-prefill.  One instance serves both roles on one binary topic,
    {runtime.topic_path}/migrate:

      source:  migrate(dest) offers each live session (encode_kv_migrate:
               the tokens the pinned chain covers and the history); on
               the destination's ack it ships the chain as chunk-streamed
               KV_TRANSFER envelopes (blocks the destination holds cross
               as handles; host-tier rows are promoted first, promote_for)
               and the done leg releases the local pin and record;
      dest:    probes its cache for the offered chain, acks with its
               resident-block count, installs arriving chunks under the
               ordered-cursor guard, and on the final envelope re-pins
               the chain under the session handle, re-creates the record
               and sends done.

    Failure degrades, never corrupts: a timed-out transfer keeps the
    session at the source, a shed destination table.create releases the
    pin it took and withholds done, and a layout or gap anomaly drops
    chunks (the destination lands history only and re-prefills).
    Single-threaded on the owning runtime's engine.

    On a mesh (a cache bound by a decoder on one, one rank included; a
    migrator on every rank, built alike and handed that `decoder`) the
    lead (global rank 0) is the migrator's address and sole voice.  On
    a cache sharded over more than one rank, its migrate() call, every
    envelope it receives and every timeout it decides reach the other
    ranks over its link (the section above _prompt_cap), which run them
    alike without a clock of their own; migrate() on another rank sends
    nothing (its on_done fires when the lead's migration has settled
    there), and a ship's blocks are joined from every rank of the lead's
    model group's KV heads, so the destination receives whole blocks.
    As a destination every rank queues what reaches it, in the lead's
    order: offers, transfers (each with this rank's KV heads of its
    blocks, cut by the decoder's shard_kv_blocks and checked as
    install_chain checks them) and the lead's expiries.  The decoder's
    round note applies them on every rank in the same round, once every
    rank holds them: an offer's host-tier promotion (promote_for,
    installed in that round) and probe, a chunk's install (refused on
    every rank where any rank's check refused it), a landing's
    session_store and table.create (a shed create withholds done on
    every rank), an expiry.  Only the lead acks, sends done and runs
    the timers."""

    def __init__(self, runtime, cache, table=None, name: str = "migrate",
                 chunk_blocks: int = 8, transfer_timeout: float = 5.0,
                 registry=None, decoder=None):
        if cache is None:
            raise ValueError("SessionMigrator needs a PrefixKVCache "
                             "(the pinned chains are the cargo)")
        if cache.agreed and (decoder is None or
                             decoder.prefix_cache is not cache):
            raise ValueError(
                "a SessionMigrator on a prefix cache bound on a mesh takes "
                "the decoder bound to it (decoder=): its round note lands "
                "the migrated sessions")
        self.runtime = runtime
        self.cache = cache
        self.table = table
        self.decoder = decoder
        self.name = str(name)
        self.logger = get_logger(f"disagg.migrate.{name}")
        self.chunk_blocks = max(1, int(chunk_blocks))
        self.transfer_timeout = float(transfer_timeout)
        self._registry = registry or default_registry()
        self.topic = f"{runtime.topic_path}/migrate"
        runtime.add_message_handler(self._on_message, self.topic,
                                    binary=True)
        self._outbound: dict[str, dict] = {}     # source-role transfers
        self._inbound: dict[str, dict] = {}      # destination-role
        self._done_callback = None
        self._outbox = _Outbox(runtime.event)
        self._link = _MeshLink(runtime.event, cache.mesh,
                               self._on_link_call) if cache.sharded \
            else None
        self._mirrored = False      # another rank: the lead's migrate()
        # on a mesh: the destination's arrivals that no note has applied,
        # [(number, kind, args)] in the lead's order
        self.agreed = cache.agreed
        self._arrived: list = []
        self._numbered = 0
        if self.agreed:
            decoder.add_note_hook(self._note_propose, self._note_apply,
                                  self._note_pending, every=True)
        self.stats = MirroredStats(
            {"offers": 0, "received": 0, "acks": 0, "chunks": 0,
             "shipped_blocks": 0, "handle_blocks": 0,
             "installed_blocks": 0, "landed": 0, "migrated": 0,
             "refused": 0, "expired": 0, "dropped_chunks": 0,
             "corrupt": 0},
            metric="kv_migrate_events_total",
            help="session KV migration events by kind",
            registry=self._registry, labels={"migrator": self.name})

    @property
    def _lead(self) -> bool:
        """This rank speaks for the migrator: off a mesh, or its lead."""
        return self._link is None or self._link.lead

    def _trace_fields(self):
        context = tracing.current_trace()
        return context.to_fields(self.runtime.event.clock.now()) \
            if context is not None else None

    # -- source role -------------------------------------------------------
    def migrate(self, dest_topic: str, on_done=None) -> int:
        """Offer every live session to the migrator at `dest_topic` (a
        peer's .topic).  Returns the offers sent; `on_done(self)` fires
        once every offer has settled (done leg or timeout), at once with
        no sessions.  On a mesh another rank than the lead sends nothing
        and returns 0; its on_done fires once the lead's migration has
        settled on it."""
        self._done_callback = on_done
        if not self._lead:
            if self._mirrored:
                self._maybe_finished()
            return 0
        sessions = self.table.items() if self.table is not None else []
        sent = 0
        for tenant, sid, payload in sessions:
            history, kv_tokens = [], 0
            if isinstance(payload, dict):
                history = [int(t) for t in payload.get("history", ())]
                kv_tokens = max(0, int(payload.get("kv_tokens", 0)))
            # the pinned chain covers a history prefix
            tokens = history[:kv_tokens]
            transfer_id = f"mig-{uuid.uuid4().hex[:12]}"
            entry = {"tenant": str(tenant), "sid": str(sid),
                     "tokens": tokens, "history": history,
                     "dest": str(dest_topic)}
            entry["timer"] = self.runtime.event.add_oneshot_handler(
                lambda tid=transfer_id: self._expired(tid),
                self.transfer_timeout)
            self._outbound[transfer_id] = entry
            self.runtime.publish(str(dest_topic), wire.encode_kv_migrate(
                transfer_id, str(tenant), str(sid), self.topic,
                np.asarray(tokens, np.int32),
                np.asarray(history, np.int32),
                trace=self._trace_fields()))
            self.stats["offers"] += 1
            sent += 1
        if self._link is not None:
            self._link.call(("migrate", [
                (transfer_id, {key: value for key, value in entry.items()
                               if key != "timer"})
                for transfer_id, entry in self._outbound.items()]))
        if sent == 0:
            self._maybe_finished()
        return sent

    def _on_link_call(self, message) -> None:
        """Another rank of a mesh: what the lead did, done alike."""
        name, *args = message
        if name == "migrate":
            for transfer_id, entry in args[0]:
                self._outbound[transfer_id] = dict(entry)
            self._mirrored = True
            self._maybe_finished()
        elif name == "message":
            self._dispatch(args[0])
        elif name == "expired":
            transfer_id, inbound = args
            if inbound and self.agreed:
                self._arrive("expired", transfer_id)
            else:
                self._expired(transfer_id, inbound)

    def _restart_timer(self, entry: dict, transfer_id: str,
                       inbound: bool = False) -> None:
        if not self._lead:
            return              # the lead's clock decides every timeout
        timer = entry.pop("timer", None)
        if timer is not None:
            self.runtime.event.remove_timer_handler(timer)
        entry["timer"] = self.runtime.event.add_oneshot_handler(
            lambda: self._expired(transfer_id, inbound=inbound),
            self.transfer_timeout)

    def _expired(self, transfer_id: str, inbound: bool = False) -> None:
        """A transfer's timer fired (on a mesh the lead's: the link
        hands it to the other ranks).  On a mesh an inbound expiry is an
        arrival, which every rank applies at the same note."""
        entry = (self._inbound if inbound else self._outbound).get(
            transfer_id)
        if entry is None:
            return
        entry.pop("timer", None)            # it fired
        if self._link is not None and self._link.lead:
            self._link.call(("expired", transfer_id, inbound))
        if inbound and self.agreed:
            self._arrive("expired", transfer_id)
            return
        self._expire(transfer_id, inbound)

    def _expire(self, transfer_id: str, inbound: bool) -> None:
        entry = self._settle(transfer_id, inbound=inbound)
        if entry is None:
            return
        self.stats["expired"] += 1
        self.logger.warning(
            "migrate %s: transfer %s (%s/%s) timed out; the session "
            "stays %s", self.name, transfer_id, entry["tenant"],
            entry["sid"], "unlanded" if inbound else "at the source")
        if inbound:
            # a half-streamed chain stays cached (content-addressed), but
            # the session never landed: no pin, no record
            return
        self._maybe_finished()

    def _maybe_finished(self) -> None:
        if self._outbound or self._done_callback is None:
            return
        if not self._lead and not self._mirrored:
            return
        callback, self._done_callback = self._done_callback, None
        callback(self)

    def _settle(self, transfer_id: str, inbound: bool = False):
        table = self._inbound if inbound else self._outbound
        entry = table.pop(transfer_id, None)
        if entry is None:
            return None
        timer = entry.pop("timer", None)
        if timer is not None:
            self.runtime.event.remove_timer_handler(timer)
        return entry

    # -- wire dispatch -----------------------------------------------------
    def _on_message(self, _topic, payload) -> None:
        if self._link is not None:
            if not self._link.lead:
                self.stats["refused"] += 1
                self.logger.warning(
                    "migrate %s: an envelope sent to rank %d, not the lead "
                    "of its mesh: refused", self.name, self._link.rank)
                return
            self._link.call(("message", bytes(payload)))
        self._dispatch(payload)

    def _dispatch(self, payload) -> None:
        try:
            command, params = wire.decode_envelope(payload)
        except wire.WireError as exc:
            self.stats["corrupt"] += 1
            self.logger.warning("migrate %s: corrupt envelope dropped: "
                                "%s", self.name, exc)
            return
        try:
            if command == wire.KV_MIGRATE_COMMAND:
                self._on_offer(command, params)
            elif command == wire.KV_MIGRATE_ACK_COMMAND:
                self._on_ack(command, params)
            elif command == wire.KV_MIGRATE_DONE_COMMAND:
                self._on_done_leg(command, params)
            elif command == wire.KV_TRANSFER_COMMAND:
                self._on_transfer(command, params)
            else:
                self.stats["corrupt"] += 1
                self.logger.warning("migrate %s: unexpected command %r "
                                    "dropped", self.name, command)
        except wire.WireError as exc:
            self.stats["corrupt"] += 1
            self.logger.warning("migrate %s: malformed %s dropped: %s",
                                self.name, command, exc)

    # -- destination role: arrivals, applied at once or at the note --------
    def _on_offer(self, command, params) -> None:
        out = wire.validate_kv_migrate_params(command, params)
        if self.agreed:
            self._arrive("offer", out)
        else:
            self._offer(out)

    def _on_transfer(self, command, params) -> None:
        out = wire.validate_kv_transfer_params(command, params)
        if self.agreed:
            self._arrive("transfer", out, self._cut(out))
        else:
            self._transfer(out, _landing(out["blocks"]))

    def _layout(self) -> tuple:
        """The layout a transfer must declare: the cache's; on a mesh the
        model's (the decoder's kv_wire_layout), whose KV heads each rank
        cuts to its own."""
        if self.agreed:
            return self.decoder.kv_wire_layout()
        return self.cache.wire_layout()

    def _cut(self, out: dict) -> tuple:
        """On a mesh, at receipt: (this rank's KV heads of a transfer's
        blocks, None), checked as install_chain checks them before any
        row lands, or (None, why this rank refuses them); (None, None)
        where the transfer carries no usable blocks."""
        if not out["blocks"] or \
                tuple(str(f) for f in out["layout"]) != self._layout():
            return None, None
        try:
            blocks = self.decoder.shard_kv_blocks(_landing(out["blocks"]))
            self.cache.check_chain(out["tokens"], out["start_block"],
                                   blocks)
        except (ValueError, TypeError, IndexError) as exc:
            return None, str(exc)
        return blocks, None

    def _arrive(self, kind: str, *args) -> None:
        """On a mesh: queue one destination arrival for the round note,
        numbered in the lead's order (every rank receives the lead's
        envelopes and expiries in the order the lead saw them)."""
        self._numbered += 1
        self._arrived.append((self._numbered, kind, args))

    def _note_pending(self) -> bool:
        """An idle decoder makes round notes while an arrival waits."""
        return bool(self._arrived)

    def _note_propose(self) -> dict:
        """This rank's part of the note: how many arrivals it holds, and
        its refusals of those it holds unapplied."""
        return {"upto": self._numbered,
                "refused": {number: args[1][1]
                            for number, kind, args in self._arrived
                            if kind == "transfer" and
                            args[1][1] is not None}}

    def _note_apply(self, values: list) -> None:
        """Apply, on this rank as on every rank, the arrivals that every
        rank holds, in order: a chunk that any rank refused is refused
        on every rank."""
        upto = min(value["upto"] for value in values)
        refused: dict = {}
        for value in values:
            for number, why in value["refused"].items():
                refused.setdefault(number, why)
        while self._arrived and self._arrived[0][0] <= upto:
            number, kind, args = self._arrived.pop(0)
            if kind == "offer":
                self._offer(*args)
            elif kind == "transfer":
                out, (blocks, _) = args
                self._transfer(out, blocks, refused.get(number))
            else:
                self._expire(args[0], inbound=True)

    # -- destination role --------------------------------------------------
    def _offer(self, out: dict) -> None:
        transfer_id = out["transfer_id"]
        tenant = out["tenant"]
        tokens = [int(t) for t in np.asarray(out["tokens"])]
        self.stats["received"] += 1
        have = 0
        if tokens:
            if self.cache.tiered:
                # this chain may be host-resident here already: promote
                # before probing, so the ack's mark spares those blocks
                # the wire.  promote_for has admit semantics ((len - 1) //
                # block); the sentinel token promotes the final block too.
                # On a mesh it stages and installs here, inside the note
                # every rank applies
                self.cache.promote_for(tenant, tokens + tokens[-1:])
            _, have = self.cache.match(tenant, tokens)
        block = self.cache.block_tokens
        entry = {"tenant": tenant, "sid": out["sid"], "tokens": tokens,
                 "history": [int(t) for t in np.asarray(out["history"])],
                 "reply_topic": out["reply_topic"],
                 "cursor": None, "installed": 0}
        self._inbound[transfer_id] = entry
        self._restart_timer(entry, transfer_id, inbound=True)
        if self._lead:
            self.runtime.publish(
                out["reply_topic"],
                wire.encode_kv_migrate_reply(
                    wire.KV_MIGRATE_ACK_COMMAND, transfer_id,
                    have // block, trace=self._trace_fields()))

    def _transfer(self, out: dict, blocks, refusal: str | None = None):
        """Install one arriving chunk (`blocks`: in this cache's storage
        layout; on a mesh this rank's KV heads, or None, and `refusal`
        some rank's reason to refuse them), and land the session on the
        final envelope."""
        transfer_id = out["transfer_id"]
        entry = self._inbound.get(transfer_id)
        if entry is None:
            return              # a late chunk after timeout
        cache = self.cache
        installed = 0
        usable = not out["blocks"] or \
            tuple(str(f) for f in out["layout"]) == self._layout()
        if usable and out["blocks"] and entry["cursor"] is not None \
                and out["start_block"] != entry["cursor"]:
            # the ordered-cursor guard: a lost sibling left a gap
            usable = False
        if usable and out["blocks"]:
            try:
                if refusal is not None:
                    raise ValueError(refusal)
                installed = cache.install_chain(
                    entry["tenant"], out["tokens"], out["start_block"],
                    blocks)
                entry["cursor"] = out["start_block"] + len(out["blocks"])
                entry["installed"] += installed
                self.stats["installed_blocks"] += installed
                ledger = getattr(cache, "_ledger", None)
                if ledger is not None and installed:
                    ledger.event("migrate_in", installed)
            except (ValueError, TypeError, IndexError) as exc:
                self.stats["dropped_chunks"] += 1
                self.logger.warning(
                    "migrate %s: transfer %s chunk refused at install "
                    "(%s); dropped", self.name, transfer_id, exc)
        elif out["blocks"]:
            self.stats["dropped_chunks"] += 1
        if not out["final"]:
            self._restart_timer(entry, transfer_id, inbound=True)
            return
        self._land(transfer_id, self._settle(transfer_id, inbound=True))

    def _land(self, transfer_id: str, entry: dict) -> None:
        """The final envelope arrived: pin the landed chain under the
        session handle, re-create the table record and send done.  A
        shed create withholds done, so the source's timeout keeps the
        session there instead of deleting the only copy."""
        cache = self.cache
        tenant, sid = entry["tenant"], entry["sid"]
        leaf, kv_tokens = cache.session_store(tenant, sid,
                                              entry["history"])
        if self.table is not None and not self.table.create(
                tenant, sid, {"history": entry["history"],
                              "kv": leaf or "", "kv_tokens": kv_tokens}):
            cache.session_release(tenant, sid)
            self.stats["refused"] += 1
            self.logger.warning(
                "migrate %s: transfer %s refused: destination table shed "
                "(%s/%s); withholding done", self.name, transfer_id,
                tenant, sid)
            return
        self.stats["landed"] += 1
        if self._lead:
            self.runtime.publish(
                entry["reply_topic"],
                wire.encode_kv_migrate_reply(
                    wire.KV_MIGRATE_DONE_COMMAND, transfer_id,
                    entry["installed"], trace=self._trace_fields()))

    # -- source role, reply legs -------------------------------------------
    def _on_ack(self, command, params) -> None:
        transfer_id, have_blocks = \
            wire.validate_kv_migrate_reply(command, params)
        entry = self._outbound.get(transfer_id)
        if entry is None:
            return
        self.stats["acks"] += 1
        cache = self.cache
        block = cache.block_tokens
        tenant, tokens = entry["tenant"], entry["tokens"]
        if cache.tiered and tokens:
            # demoted session rows must be pool-resident before they can
            # ship (the admit-semantics sentinel again)
            cache.promote_for(tenant, tokens + tokens[-1:])
        keys, hit = cache.match(tenant, tokens)
        start = min(max(0, int(have_blocks)), hit // block)
        end = hit // block
        self.stats["handle_blocks"] += start
        self.stats["shipped_blocks"] += end - start
        ledger = getattr(cache, "_ledger", None)
        if ledger is not None and end > start:
            ledger.event("migrate_out", end - start)
        trace, layout = self._trace_fields(), cache.wire_layout()
        if self._link is not None:
            layout = _whole_layout(layout, self._link.heads)
        # a chunk-streamed ship: every envelope carries the whole token
        # list (install_chain re-keys from it), blocks in chunk_blocks
        # strides; the final flag rides the last envelope, sent even
        # with no blocks, since it triggers the destination's land
        cursor = start
        while True:
            upto = min(end, cursor + self.chunk_blocks)
            final = upto >= end
            rows = _chain_wire_blocks(cache, keys[cursor:upto])

            def send(blocks, cursor=cursor, final=final):
                self.runtime.publish(entry["dest"], wire.encode_kv_transfer(
                    transfer_id, tenant, tokens, cursor, block, layout,
                    blocks, trace=trace, final=final))
            _queue_rows(self._outbox, self._link, rows, send)
            self.stats["chunks"] += 1
            cursor = upto
            if final:
                break
        self._restart_timer(entry, transfer_id)

    def _on_done_leg(self, command, params) -> None:
        transfer_id, _installed = \
            wire.validate_kv_migrate_reply(command, params)
        entry = self._settle(transfer_id)
        if entry is None:
            return
        # the destination owns the session now: drop the local pin and
        # the record (remove, not demote: its demotion hook must not fire)
        self.cache.session_release(entry["tenant"], entry["sid"])
        if self.table is not None:
            self.table.remove(entry["tenant"], entry["sid"],
                              reason="migrated")
        self.stats["migrated"] += 1
        self._maybe_finished()

    def pending_count(self) -> int:
        """Transfers in flight either way, and on a mesh the arrivals no
        round note has applied yet."""
        return len(self._outbound) + len(self._inbound) + len(self._arrived)

    def stop(self) -> None:
        self._outbox.flush()
        for transfer_id in list(self._outbound):
            self._settle(transfer_id)       # sessions stay local
        for transfer_id in list(self._inbound):
            self._settle(transfer_id, inbound=True)
        self._arrived = []
        self.runtime.remove_message_handler(self._on_message, self.topic)
        if self._link is not None:
            self._link.close()




def two_pool_autoscalers(runtime, prefill_manager, decode_manager,
                         prefill_policy=None, decode_policy=None,
                         interval: float = 2.0,
                         topic_filter: str | None = None):
    """One autoscaler per pool, each armed with its own pool's signals:
    the prefill pool scales on prefill queue depth (only prefill
    runtimes publish the gauge), the decode pool on the fleet-merged ITL
    p95 (only multi-token generation observes ITL).  Both pools
    subscribe the same namespace snapshots, so the default worst-of
    signals (mailbox, batch wait, hop p95, queue depth) are disarmed for
    both: a prompt burst backlogging the prefill runtimes must not grow
    the decode pool through their batch gauges.  Returns
    (prefill_autoscaler, decode_autoscaler), two scale loops over two
    LifeCycleManagers."""
    from .autoscaler import Autoscaler, ScalePolicy
    prefill_policy = prefill_policy or ScalePolicy(
        prefill_queue_up=8.0, prefill_queue_down=1.0,
        mailbox_depth_up=float("inf"), hop_p95_up=float("inf"),
        batch_wait_up=float("inf"), queue_depth_up=float("inf"))
    decode_policy = decode_policy or ScalePolicy(
        itl_p95_up=0.05, itl_p95_down=0.005,
        mailbox_depth_up=float("inf"), hop_p95_up=float("inf"),
        batch_wait_up=float("inf"), queue_depth_up=float("inf"))
    prefill = Autoscaler(runtime, "prefill-pool",
                         manager=prefill_manager,
                         policy=prefill_policy, interval=interval,
                         topic_filter=topic_filter)
    decode = Autoscaler(runtime, "decode-pool", manager=decode_manager,
                        policy=decode_policy, interval=interval,
                        topic_filter=topic_filter)
    return prefill, decode


# -- the two-pool harness ----------------------------------------------------

class DisaggHarness:
    """A two-pool serving plane in one process: a registrar and peer-
    enabled prefill and decode runtimes over one MemoryBroker and one
    real-clock EventEngine.  disagg=False builds the colocated A/B: the
    same decode decoder and cache, no prefill pool, no client.  Both
    sides' decoders take decoder_opts (without a "device": the card) and
    may share one set of parameter tensors."""

    def __init__(self, params, config, *, disagg: bool = True,
                 block_tokens: int = 16, max_slots: int = 8,
                 prefill_slots: int = 4, steps_per_sync: int = 4,
                 prefill_buckets=(64,), prefill_chunk: int | None = None,
                 cache_mb: int = 512, decoder_opts: dict | None = None,
                 fault_plan=None, transfer_timeout: float = 5.0,
                 retries: int = 1, batch_window: float = 0.0,
                 chunk_stream: bool | None = None, registry=None):
        from .event import EventEngine
        from .process import ProcessRuntime
        from .registrar import Registrar
        from .serving import ContinuousDecoder, PrefixKVCache
        from .share import ServicesCache
        from .transport.memory import MemoryBroker, MemoryMessage

        self.engine = EventEngine()
        self.broker = MemoryBroker()
        self.disagg = bool(disagg)
        self._registry = registry or default_registry()

        def make_rt(name):
            def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
                return MemoryMessage(
                    on_message=on_message, broker=self.broker,
                    lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                    lwt_retain=lwt_retain, client_id=name)
            return ProcessRuntime(name=name, engine=self.engine,
                                  transport_factory=factory).initialize()

        self.registrar_rt = make_rt("disagg_reg")
        self.registrar = Registrar(self.registrar_rt)
        opts = dict(decoder_opts or {})

        self.decode_rt = make_rt("disagg_decode")
        self.decode_rt.enable_peer()
        self.cache = PrefixKVCache(
            block_tokens=int(block_tokens), max_bytes=int(cache_mb) << 20,
            name="disagg.decode", registry=self._registry)
        self.decoder = ContinuousDecoder(
            params, config, max_slots=int(max_slots),
            prefill_buckets=tuple(prefill_buckets),
            steps_per_sync=int(steps_per_sync),
            prefill_chunk=prefill_chunk, name="disagg.decode",
            prefix_cache=self.cache, registry=self._registry, **opts)
        # pump flat-out (once per engine step), not from a periodic
        # timer: a short timer against long rounds replays the pump in
        # the engine's catch-up loop and starves the message queues,
        # and a slow one idles the decoder and hides the prefill
        # interference this harness measures
        self.engine.add_flatout_handler(self.decoder.pump)

        self.prefill_rt = None
        self.prefill = None
        self.client = None
        if self.disagg:
            self.prefill_rt = make_rt("disagg_prefill")
            self.prefill_rt.enable_peer(fault_plan=fault_plan)
            self.prefill = PrefillRuntime(
                self.prefill_rt, "disagg_prefill",
                params=params, config=config,
                block_tokens=int(block_tokens), cache_mb=cache_mb,
                max_slots=int(prefill_slots),
                prefill_buckets=tuple(prefill_buckets),
                prefill_chunk=prefill_chunk, decoder_opts=opts,
                pump_period=0, batch_window=batch_window,
                chunk_stream=chunk_stream, registry=self._registry)
            cache = ServicesCache(self.decode_rt)
            self.client = PrefillClient(
                self.decode_rt, self.decoder, services_cache=cache,
                name="disagg", transfer_timeout=transfer_timeout,
                retries=retries, registry=self._registry)
            self._services_cache = cache

    # -- driving ------------------------------------------------------------
    def wait_discovered(self, timeout: float = 10.0) -> bool:
        """Step the engine until the client sees the prefill pool; True
        at once when colocated."""
        if not self.disagg:
            return True
        return self.engine.run_until(lambda: bool(self.client.loads),
                                     timeout=timeout)

    def submit(self, request_id, prompt, max_new, callback,
               tenant: str = "", deadline=None):
        if self.client is not None:
            return self.client.submit(request_id, prompt, max_new,
                                      callback, deadline=deadline,
                                      tenant=tenant)
        return self.decoder.submit(request_id, prompt, max_new, callback,
                                   deadline=deadline, tenant=tenant)

    def run_until(self, predicate, timeout: float = 30.0) -> bool:
        return self.engine.run_until(predicate, timeout=timeout)

    def measure(self, window: float = 6.0, streams: int = 6,
                stream_prompt: int = 12, stream_new: int = 24,
                burst: int = 4, burst_prompt: int = 288,
                burst_new: int = 4, burst_every: float = 1.5,
                seed: int = 11) -> dict:
        """The two-pool workload: `streams` closed-loop decode streams
        (short prompts, long generations, tenant "stream") run the whole
        window; its second half adds a cold-prefill burst (`burst` long
        prompts every `burst_every` seconds, tenant "burst") sharing a
        seeded half-prompt prefix.  Reports the streams' ITL p50 / p95
        per half from the tenant-filtered sketches, the worst stall per
        request, transfer cost and volume, the handle-hit rate, the
        fallback counts and a zero-lost account (submitted == completed
        after the drain)."""
        rng = np.random.default_rng(seed)
        vocab = self.decoder.config.vocab
        state = {"stop": False, "stream_done": 0, "burst_done": 0,
                 "stream_posted": 0, "burst_posted": 0, "seq": 0}
        # after the first burst's harvest the decode side holds the
        # shared prefix, so later transfers ship it as handles
        shared_prefix = rng.integers(
            1, vocab, size=burst_prompt // 2).tolist()

        def post_stream(i):
            state["seq"] += 1
            state["stream_posted"] += 1
            prompt = rng.integers(1, vocab, size=stream_prompt).tolist()

            def on_done(_rid, _tokens):
                state["stream_done"] += 1
                if not state["stop"]:
                    post_stream(i)

            self.submit(f"st{i}.{state['seq']}", prompt, stream_new,
                        on_done, tenant="stream")

        def on_burst_done(_rid, _tokens):
            state["burst_done"] += 1

        def post_burst(count=None):
            for _ in range(count or burst):
                state["seq"] += 1
                state["burst_posted"] += 1
                prompt = shared_prefix + rng.integers(
                    1, vocab,
                    size=burst_prompt - len(shared_prefix)).tolist()
                self.submit(f"bu{state['seq']}", prompt, burst_new,
                            on_burst_done, tenant="burst")

        # warm-up: every dispatch shape (stream admit widths, burst chunk
        # extends, prefix-hit widths, the transfer machinery) runs once
        # before anything is measured, a full burst and a lone prompt
        # among them; gated on the burst completions, since the streams
        # finish early and resubmit
        for i in range(streams):
            post_stream(i)
        post_burst()
        post_burst(1)
        self.run_until(
            lambda: state["burst_done"] >= burst + 1 and
            state["stream_done"] >= streams, timeout=600.0)
        # a second wave with the shared prefix cached: the prefix-hit
        # shapes (and, disaggregated, the handle path) before the window
        post_burst()
        self.run_until(lambda: state["burst_done"] >= 2 * burst + 1,
                       timeout=600.0)
        self.decoder.clear_slo_sketches()
        self.decoder.ttft_samples.clear()
        self.decoder.itl_samples.clear()
        self.decoder.gap_samples.clear()

        def stall_p95():
            samples = sorted(self.decoder.gap_samples)
            self.decoder.gap_samples.clear()
            if not samples:
                return None
            return round(samples[int(0.95 * (len(samples) - 1))] * 1000.0,
                         3)

        deadline = time.perf_counter() + window / 2.0
        self.run_until(lambda: time.perf_counter() >= deadline,
                       timeout=window + 120.0)
        baseline = self.decoder.slo_sketch_stats(tenant="stream")
        baseline_stall = stall_p95()
        base_done = state["stream_done"]
        self.decoder.clear_slo_sketches()

        timer = self.engine.add_timer_handler(post_burst, burst_every)
        deadline = time.perf_counter() + window / 2.0
        self.run_until(lambda: time.perf_counter() >= deadline,
                       timeout=window + 120.0)
        self.engine.remove_timer_handler(timer)
        state["stop"] = True
        drained = self.run_until(
            lambda: self.decoder.idle and
            (self.client is None or self.client.pending_count() == 0),
            timeout=180.0)
        burst_phase = self.decoder.slo_sketch_stats(tenant="stream")
        posted = state["stream_posted"] + state["burst_posted"]
        done = state["stream_done"] + state["burst_done"]
        out = {
            "itl_p95_baseline_ms": baseline["itl_p95_ms"],
            "itl_p50_baseline_ms": baseline["itl_p50_ms"],
            "itl_p95_burst_ms": burst_phase["itl_p95_ms"],
            "itl_p50_burst_ms": burst_phase["itl_p50_ms"],
            # the worst inter-sync stall per request: what prefill
            # interference inflates most directly
            "stall_p95_baseline_ms": baseline_stall,
            "stall_p95_burst_ms": stall_p95(),
            "stream_completions": state["stream_done"],
            "stream_completions_baseline": base_done,
            "burst_completions": state["burst_done"],
            "posted": posted, "completed": done,
            "lost": posted - done, "drained": bool(drained),
        }
        if self.client is not None:
            stats = self.client.stats
            samples = sorted(self.client.transfer_samples)
            out.update({
                "transfers": stats["transfers"],
                "transfer_bytes": stats["transfer_bytes"],
                "transfer_p50_ms": round(
                    samples[len(samples) // 2] * 1000.0, 3)
                if samples else None,
                "transfer_p95_ms": round(
                    samples[int(0.95 * (len(samples) - 1))] * 1000.0, 3)
                if samples else None,
                "handle_hit_rate": round(self.client.handle_hit_rate(), 4),
                "local_fallbacks": stats["local_fallbacks"],
                "install_shed": stats["install_shed"],
                # chunk streaming: transfers that overlapped the donor's
                # prefill, and the transfer time that overlap hid
                "chunk_streamed": stats["chunk_streamed"],
                "chunk_installs": stats["chunk_installs"],
                "chunk_dropped": stats["chunk_dropped"],
                "transfer_overlap_s": round(
                    stats["transfer_overlap_s"], 4),
            })
        return out

    def kill_prefill(self) -> None:
        """Chaos: the prefill pool dies (a crash: its last will removes
        its records and channels collapse).  In-flight transfers ride the
        client's fallback ladder."""
        if self.prefill_rt is not None:
            self.prefill_rt.terminate(graceful=False)
            self.prefill_rt = None
            self.prefill = None

    def stop(self) -> None:
        if self.client is not None:
            self.client.stop()
        if self.prefill is not None:
            self.prefill.stop()
        self.engine.remove_flatout_handler(self.decoder.pump)
        if self.prefill_rt is not None:
            self.prefill_rt.terminate()
        self.decode_rt.terminate()
        self.registrar_rt.terminate()
