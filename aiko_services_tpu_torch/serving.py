# Continuous-batching greedy Llama decoding over a dense slot cache or a
# paged KV block pool, with speculation, the hash-addressed prefix cache
# and its host tier.
#
# Counterpart of aiko_services_tpu/serving.py's ContinuousDecoder and
# PrefixKVCache: the dense slot cache (paged_kv=False, JAX's default:
# plain PyTorch, as JAX computes it with einsums) in the block KV write
# or the select write (AIKO_DECODE_KV, with its two_pass / online / vpu
# inner loops, AIKO_DECODE_ATTENTION) and the paged pool read by the
# paged decode-attention kernel (paged_kv=True, the JAX package's
# ATTENTION_IMPL="paged_kernel"); native or int8 KV (kv_cache_dtype);
# int8 weights (weight_quant) and fused decode projections
# (fuse_projections); bucketed single-shot prefill and chunked prefill
# (prefill_chunk, prefill_budget); greedy decoding, plain or
# self-speculative (speculate_k tokens a step drafted by prompt lookup,
# speculate_ngram, verified in one widened pass: the paged kernel at W =
# 1 + k); a dense SwiGLU or MoE FFN.  A bound PrefixKVCache holds row
# copies for a dense decoder (a hit copies them into the slot) and pool
# blocks for a paged one (a hit aliases them into the slot's table, a
# write into a shared block copies it first, a retiring request's blocks
# become cache entries by refcount; with a host store, evicted blocks
# demote to pinned host memory and promote back, serving_tiered.py);
# either way only the uncached suffix is prefilled, by chunk extends.
# The scheduling is the JAX decoder's: decode-first rounds of up to
# steps_per_sync steps, admits and chunk extends dispatched behind the
# round's decode steps and resolved at the next round's sync, one host
# sync per round; the decoder can pump itself from an event engine
# (attach), sheds requests whose deadline its admit-wait estimate cannot
# meet, bills cache traffic to tenants, keeps a journey and mergeable
# TTFT / ITL sketches per request, reports its KV bytes to a ledger
# (attach_ledger), and drains gracefully (drain, resume).  For
# disaggregated serving (serving_disagg.py) a cache installs shipped
# chain blocks (install_chain), a cacheless paged decoder takes them
# straight into its pool (install_shipped_blocks, submit's kv_blocks),
# and a progress callback sees each prefill chunk land.
#
# Sharded serving (mesh): the decoder takes this rank's shards of the
# weights (ComputeRuntime.place_params with llama_axes, i.e.
# parallel.local_shards) and the mesh, and serves on plain local tensors:
# the round programs launch the same kernels as unsharded with the rank's
# heads, KV heads, ffn and vocab (and experts), the caches, pools and
# ledger bytes are the rank's, and the collectives (the row-parallel sums
# of o and down, the vocab-sharded embedding, the sharded greedy pick,
# the expert sum) run on the mesh axes' groups (models/llama.py,
# models/moe.py, parallel/collectives.py).  JAX partitions one program
# under GSPMD; here every rank runs its own decoder, so the ranks must
# stay in step: a collective paired with another rank's different
# program hangs.  Lockstep holds because every round decision (admits,
# chunk plans, evictions, block allocations, pool shrinks, the extent,
# the number of steps) is a function of the agreed queue and of the round
# count alone, and the one host sync returns the same tokens on every
# rank (the pick is replicated).  The queue is agreed, not assumed, and
# so is every decision that reads a clock or a thread's timing: each
# round that could decide something (a busy decoder, or arrivals or
# drain / resume calls on this rank) opens with the round note, one
# host-side all_gather of every rank's note: its arrivals (ids and a
# digest of each request), its drain and resume calls, the host tier's
# promotions that landed on it, the proposals of note hooks (the agent's
# session-lease expiries), and from rank 0 its clock, its admit-wait
# estimate and its deadline verdict on each of its arrivals.  Rank 0
# decides; every rank applies its decisions in that round
# (_apply_note): the requests that all ranks hold join the queue in rank
# 0's order unless rank 0 shed them (refused through on_refused, never
# by submit's return value); a drain begins once every rank holds its
# call, its deadline checkpoint comes at the round whose rank-0 clock
# passes it; a promotion lands only where every rank staged it (an AND
# of the ranks' landed chains), so an admit's hit and aliased blocks are
# the same everywhere; rank 0's hook proposals apply.  So a rank pumped
# from its own timer, whose frames land in other rounds than another
# rank's, or whose clock runs apart, still admits, sheds, drains and
# promotes in the same round as every other rank; a request id whose
# content differs between ranks raises.  The note runs on every mesh,
# one rank included (there the gather is skipped, the decisions are
# not); an idle decoder with nothing to agree makes no call.  It runs on
# the mesh's gloo group (a gloo group beside an NCCL mesh), so it adds
# no device sync.  A host-tier promotion is kicked at the note that
# agrees its arrival (every rank kicks the same job) and lands at a later
# note, the AND of the ranks' staged jobs; the admit waits for it, within
# rank 0's bound of notes (promote_wait_notes), then stages inline.
# Shipped KV blocks land by note hook: rank 0's PrefillClient alone
# sends, times out and falls back, and every rank installs its KV heads
# of the shipped rows in the round rank 0's landing rides
# (serving_disagg.py).  The SLO stamps and journeys read
# each rank's clock but decide nothing.  Every rank must be handed every
# request and every drain or resume call: one that some rank never
# receives waits in the others' note, and their next agreement waits for
# that rank.
# `plan_digests`, when set to a list, receives a digest of every working
# round's plan, for comparing the ranks after a drive (no collective, no
# sync).
#
# From JAX to PyTorch: the programs run eagerly and update the caches,
# pools, context buffer and token and length vectors IN PLACE; a lax.scan
# becomes a Python loop with no host read inside it (every stop condition
# stays on the device), and JAX's dropped scatter indices are written out
# as explicit masks.

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import os
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .models import layers as L
from .models.llama import LlamaConfig, llama_ffn
from .observe.journey import JourneyLog
from .observe.metrics import MirroredStats, default_registry
from .observe.profiler import PhaseProfiler
from .serving_paged import (BlockPool, _build_paged_spec_step,
                            _build_paged_step, _paged_admit, _paged_extend)

__all__ = ["ContinuousDecoder", "DecodeRequest", "PrefixKVCache",
           "prefix_chain_keys", "check_block_geometry",
           "measure_device_step"]


def _agreement_group(mesh):
    """The host-side group a sharded decoder agrees its queue over:
    every rank of `mesh`, which spans the default process group
    (parallel.create_mesh).  The default group where it is gloo, else a
    gloo group beside it (the NCCL one would stage the gathered bytes
    through the card and sync the stream).  Every rank of the default
    group builds its decoder, and so this group, alike."""
    import torch.distributed as dist
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def _to_device(device: torch.device, *arrays) -> list:
    """Send small host int and bool arrays to `device` in ONE copy.  On
    the card they are packed into a fresh pinned buffer and copied with
    non_blocking=True, so the host does not wait for the work queued on
    the stream (a copy from pageable memory synchronizes the stream).  A
    fresh buffer per call: the caching host allocator keeps it until
    its copy has run, so reused numpy scratch can change meanwhile.
    Returns one tensor per array, of its shape: bool stays bool, every
    other array comes back int32."""
    # each piece starts on a 16-byte boundary
    sizes = [np.asarray(a).size for a in arrays]
    starts = np.concatenate([[0], np.cumsum([-(-n // 4) * 4
                                             for n in sizes])])
    # the fresh buffer the docstring asks for, once per call
    flat = np.zeros((int(starts[-1]),), np.int32)  # graft: disable=lint-hot-alloc
    for a, start, n in zip(arrays, starts, sizes):
        flat[start:start + n] = np.asarray(a).reshape(-1)
    host = torch.from_numpy(flat)
    if device.type == "cuda":
        host = host.pin_memory()
    flat_dev = host.to(device, non_blocking=True)
    out = []
    for a, start, n in zip(arrays, starts, sizes):
        piece = flat_dev[start:start + n].view(np.shape(a))
        out.append(piece.bool() if np.asarray(a).dtype == bool else piece)
    return out


def measure_device_step(decoder, steps_per_sync: int = 64,
                        chains: int = 4) -> float:
    """Milliseconds a decode step of `decoder`'s own round program takes
    on its device at its serving shape: fresh zero caches (paged: fresh
    zero pools at the pool's current capacity, round-robin distinct
    tables at the current table width), `chains` rounds back to back
    after one warm-up round, ONE host sync at the end.  Every round
    starts its slots at length 0 (the JAX probe carries the lengths on,
    past the RoPE tables once enough rounds ran), so a round of
    steps_per_sync steps must fit in max_seq_len.  With speculation it
    is per verify step, which emits up to 1 + speculate_k tokens."""
    slots, device = decoder.max_slots, decoder.device
    if steps_per_sync * (1 + decoder.speculate_k) > \
            decoder.config.max_seq_len:
        raise ValueError(
            f"measure_device_step: {steps_per_sync} steps of "
            f"{1 + decoder.speculate_k} tokens pass max_seq_len "
            f"{decoder.config.max_seq_len}")
    tokens = torch.ones((slots,), dtype=torch.int32, device=device)
    lengths = torch.zeros((slots,), dtype=torch.int32, device=device)
    active = torch.ones((slots,), dtype=torch.bool, device=device)
    budgets = torch.full((slots,), 1 << 30, dtype=torch.int32,
                         device=device)
    context = (torch.zeros((slots, decoder.max_seq), dtype=torch.int32,
                           device=device),) if decoder.speculate_k else ()
    extent = {}
    if decoder.paged:
        pool = decoder.pool
        nb = -(-decoder._cache_t // decoder.kv_block)
        ids = 1 + np.arange(slots * nb) % max(1, pool.num_blocks - 1)
        tables, = _to_device(device, ids.reshape(slots, nb))
        store = (pool._zero_pools(pool.num_blocks),
                 pool._zero_pools(pool.num_blocks), tables)
        extent = {"t_cap": decoder._cache_t}
    else:
        store = (decoder._zero_caches(), decoder._zero_caches())

    def chain(rounds):
        nonlocal tokens
        out = None
        for _ in range(rounds):
            out = decoder._step(decoder.params, tokens, lengths, active,
                                budgets, *context, *store,
                                num_steps=steps_per_sync, eos=-1, **extent)
            tokens = out[2]
        out[0][-1].cpu()                 # one sync for the chain

    with torch.no_grad():
        chain(1)                         # warm-up
        start = time.perf_counter()
        chain(chains)
    return (time.perf_counter() - start) * 1000.0 / \
        (chains * steps_per_sync)


@dataclasses.dataclass
class DecodeRequest:
    request_id: str
    prompt: list                      # token ids
    max_new_tokens: int
    callback: Callable                # callback(request_id, token_list)
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
    # SLO stamps (scheduler clock, time.monotonic): TTFT is first_time -
    # submit_time; tokens arrive in per-sync bursts, so the stall metric
    # is the worst gap BETWEEN bursts (max_gap)
    submit_time: float = 0.0
    first_time: float = 0.0
    last_time: float = 0.0
    max_gap: float = 0.0
    # the request's journey (observe/journey.py) and its end-to-end
    # completion deadline (scheduler clock), judged at completion
    journey: object = None
    deadline: float | None = None
    # chunked prefill: the slot is held while the prompt streams in
    # prefill_chunk tokens per round; prefill_pos of it are written
    prefilling: bool = False
    prefill_pos: int = 0
    # prefix cache: tokens satisfied from the cache at admit (0 = cold),
    # the pinned chain keys (released at retire), whether the cache was
    # already probed (the hit/miss counters count once per request), and
    # the tenant the request bills its cache traffic to
    prefix_hit: int = 0
    prefix_nodes: list = dataclasses.field(default_factory=list)
    prefix_probed: bool = False
    tenant: str = ""
    # in-flight dedup window: dedup_wait holds the leading-block key this
    # request waits on (a duplicate of a prompt prefilling now defers
    # until the leader's prompt blocks land); dedup_hot marks a leader
    # some follower waits on (its prompt harvests at its first token,
    # not at retire); inflight_key is the leader's registration key
    dedup_wait: str = ""
    dedup_hot: bool = False
    inflight_key: str = ""
    # the TTFT / journey population override ("" derives cached / cold
    # from prefix_hit; a disaggregated client stamps "remote")
    prefill_label: str = ""
    # pool block ids a disaggregated client installed for this request
    # on a cacheless paged decoder (install_shipped_blocks): admit
    # aliases them into the slot's table, ownership passing to the slot
    kv_block_ids: list = dataclasses.field(default_factory=list)
    # progress_callback(request, finished) after each prefill chunk
    # advances prefill_pos (a prefill runtime ships the chunk's blocks)
    progress_callback: object = None
    # serving on a mesh: a digest of the request's content, which every
    # rank's copy of it must share (ContinuousDecoder._round_note), and
    # on_refused(request_id, reason) for a refusal at the agreeing round
    # ("shed": rank 0's deadline verdict; "drained")
    agree_key: str = ""
    on_refused: object = None
    calls_before: int = 0             # drain / resume calls handed first


def prefix_chain_keys(tenant: str, tokens, block_tokens: int) -> list:
    """Hash-chain block keys for a token sequence: block i is keyed
    blake2b(parent_key, block_i_tokens), with block 0's parent the
    tenant root, so every key commits to the whole token prefix behind
    it and two tenants never share a block.  Only complete blocks are
    keyed; the ragged tail is always prefilled.  Byte for byte the JAX
    package's keys."""
    tenant = str(tenant or "default")
    parent = b"t\x00" + tenant.encode("utf-8")
    keys = []
    for i in range(len(tokens) // block_tokens):
        digest = hashlib.blake2b(parent, digest_size=16)
        digest.update(np.asarray(
            tokens[i * block_tokens:(i + 1) * block_tokens],
            np.int64).tobytes())
        parent = digest.digest()
        keys.append(parent.hex())
    return keys


def check_block_geometry(layout, block_tokens: int, entry) -> None:
    """Refuse a shipped block whose arrays do not match a bound storage
    layout (layers, KV heads, head dim, ..., int8-ness): a payload with
    the wrong layer count or extents would poison the pool at the next
    hit.  Raises ValueError."""
    layers, heads, head_dim = (int(layout[0]), int(layout[1]),
                               int(layout[2]))
    int8 = str(layout[4]) not in ("False", "0", "")
    for side in ("k", "v"):
        rows = entry[side]
        if len(rows) != layers:
            raise ValueError(
                f"block ships {len(rows)} layers, cache layout "
                f"has {layers}")
        want = (heads, int(block_tokens), head_dim)
        for leaf in rows:
            if isinstance(leaf, dict) != int8:
                raise ValueError(
                    f"block {side} storage form does not match "
                    f"the cache's int8={int8} layout")
            values = leaf["q"] if isinstance(leaf, dict) else leaf
            if tuple(values.shape) != want:
                raise ValueError(
                    f"block {side} rows shape "
                    f"{tuple(values.shape)} != layout {want}")
            if isinstance(leaf, dict) and \
                    tuple(leaf["s"].shape) != want[:2]:
                raise ValueError(
                    f"block {side} scale shape "
                    f"{tuple(leaf['s'].shape)} != {want[:2]}")


def _stack_block_leaves(leaves):
    """Stack per-block leaves ([H, B, D] numpy arrays or tensors, int8
    dicts plane by plane) into one [M, H, B, D] layer stack: the form
    BlockPool.write_blocks installs with one index copy per plane."""
    if isinstance(leaves[0], dict):
        return {key: _stack_planes([leaf[key] for leaf in leaves])
                for key in ("q", "s")}
    return _stack_planes(leaves)


def _stack_planes(planes) -> torch.Tensor:
    if not any(isinstance(plane, torch.Tensor) for plane in planes):
        return torch.from_numpy(np.stack(planes))
    return torch.stack([_as_tensor(plane) for plane in planes])


def _as_tensor(plane) -> torch.Tensor:
    """A plane as a tensor; a numpy array (a read-only wire view,
    perhaps) is copied out."""
    return plane if isinstance(plane, torch.Tensor) \
        else torch.from_numpy(np.array(plane))


def _leaf_planes(leaf) -> list:
    return [leaf["q"], leaf["s"]] if isinstance(leaf, dict) else [leaf]


def _with_planes(leaf, planes):
    """`leaf`'s form (tensor or int8 dict) around new planes."""
    return {"q": planes[0], "s": planes[1]} if isinstance(leaf, dict) \
        else planes[0]


def _to_device_groups(device: torch.device, groups) -> list:
    """Host tensors to `device`, one device buffer per group: the
    planes are packed into ONE fresh pinned buffer (each on a 16-byte
    boundary) and every group's span is copied with non_blocking=True,
    so the host does not wait for the work queued on the stream (a copy
    from pageable memory synchronizes it).  A group's tensors come back
    as typed views of its own buffer, so each group's storage is freed
    on its own.  On the CPU, or for tensors already on `device`, the
    tensors come back as they are."""
    if device.type != "cuda" or all(
            tensor.device.type == "cuda" for group in groups
            for tensor in group):
        return [list(group) for group in groups]
    spans, total = [], 0
    for group in groups:
        start, offsets = total, []
        for tensor in group:
            offsets.append(total - start)
            total += -(-tensor.numel() * tensor.element_size() // 16) * 16
        spans.append((start, total, offsets))
    host = torch.empty((max(total, 1),), dtype=torch.uint8,
                       pin_memory=True)
    out = []
    for group, (start, stop, offsets) in zip(groups, spans):
        for tensor, offset in zip(group, offsets):
            nbytes = tensor.numel() * tensor.element_size()
            host[start + offset:start + offset + nbytes].view(
                tensor.dtype).view(tensor.shape).copy_(tensor)
        flat = host[start:stop].to(device, non_blocking=True)
        out.append([flat[offset:offset + tensor.numel() *
                         tensor.element_size()].view(tensor.dtype)
                    .view(tensor.shape)
                    for tensor, offset in zip(group, offsets)])
    return out


def _install_blocks(pool, entries, tenant: str) -> list:
    """Write shipped blocks ([{"k": per-layer leaves, "v": ...}], host
    arrays or tensors) into fresh pool blocks: each layer's and plane's
    stack staged in one pinned buffer and copied to the card without a
    host sync, then one index copy per layer and plane.  Returns the
    ids, refs=1 owned by the caller."""
    ids = pool.alloc_blocks(len(entries), tenant=tenant)
    layers = len(entries[0]["k"])
    leaves = [_stack_block_leaves([entry[side][i] for entry in entries])
              for side in ("k", "v") for i in range(layers)]
    planes, = _to_device_groups(pool.device, [
        [plane for leaf in leaves for plane in _leaf_planes(leaf)]])
    staged, at = [], 0
    for leaf in leaves:
        width = len(_leaf_planes(leaf))
        staged.append(_with_planes(leaf, planes[at:at + width]))
        at += width
    pool.write_blocks(ids, staged[:layers], staged[layers:])
    return ids


class _PrefixBlock:
    """One cached block: a dense node carries its own per-layer K/V rows
    (k_rows / v_rows), a paged node names its pool block (`pool_id`: the
    cache holds one pool ref on it); plus the tree bookkeeping eviction
    needs (parent/children for leaf-first order, refs for pinning)."""

    __slots__ = ("key", "parent", "tenant", "refs", "children", "nbytes",
                 "k_rows", "v_rows", "pool_id")

    def __init__(self, key, parent, tenant, k_rows, v_rows, nbytes,
                 pool_id=None):
        self.key = key
        self.parent = parent
        self.tenant = tenant
        self.refs = 0
        self.children: set = set()
        self.nbytes = int(nbytes)
        self.k_rows = k_rows
        self.v_rows = v_rows
        self.pool_id = pool_id


class PrefixKVCache:
    """Hash-addressed prefix/KV reuse cache for a ContinuousDecoder.

    Prompts are chunked into fixed `block_tokens` blocks, each keyed by
    hash(parent_key, block tokens) (prefix_chain_keys).  Admit does a
    longest-prefix match and prefill runs only on the uncached suffix: a
    dense decoder copies the cached rows into the slot, a paged one
    aliases the cached pool blocks into the slot's table.  Blocks are
    harvested when a request retires (prompt + every generated token but
    the last, whose K/V is never written), so a conversation's next turn
    longest-matches everything it has said.  Dense nodes hold their own
    rows (insert), paged nodes one pool block each (insert_block); one
    cache holds one kind.

    Budgets: a global byte cap plus an optional per-tenant cap; over
    budget, eviction walks LRU order and takes leaf blocks only (refs ==
    0 and no children), so a block pinned by a live slot or a session
    handle is never dropped.  Session handles (session_store /
    session_release) pin a (tenant, sid) chain between turns; a
    SessionTable's lease expiry and demotion hooks release them.

    Mirrors prefix_cache_events_total, serving_prefix_{hit,miss}_tokens_
    total{cache, tenant}, prefix_cache_bytes and prefix_cache_blocks into
    the registry, under the JAX package's family names.

    The host tier (attach_host_store, serving_tiered.py): a paged cache
    with a HostBlockStore demotes the pool blocks it evicts to pinned
    host memory under their chain keys instead of forgetting them, and
    its AsyncPromoter re-lands them (prefetch, poll_promotions,
    promote_for) before the prompts that need them admit.  The KV memory
    ledger (attach_ledger) reaches the cache, its pool and its host
    store.  Bound by a decoder on a mesh, a promotion lands only where
    the decoder's round note shows it landed on every rank
    (landed_promotions, land_promotions), and the admit-time fallback
    stages inline without waiting on a thread.  install_chain lands shipped chain blocks (the decode side of
    disaggregated serving and a migration destination,
    serving_disagg.py); check_chain checks them without landing them.  Single-threaded like the
    decoder that owns it; decoders of one geometry and one storage kind
    may share it (paged: and then share its pool)."""

    def __init__(self, block_tokens: int = 32,
                 max_bytes: int | None = 512 << 20,
                 tenant_max_bytes: int | None = None,
                 name: str = "prefix", registry=None):
        self.block_tokens = int(block_tokens)
        if self.block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}")
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.tenant_max_bytes = int(tenant_max_bytes) \
            if tenant_max_bytes else None
        self.name = str(name)
        # one OrderedDict is both storage and LRU order (oldest-touched
        # first; eviction walks from the front, touch is move_to_end)
        self._nodes: OrderedDict = OrderedDict()
        self._tenant_bytes: dict = {}
        self._sessions: dict = {}       # (tenant, sid) -> [keys]
        self.bytes_used = 0
        self._layout = None
        self._device = None             # the binding decoder's device
        # a paged decoder attaches its BlockPool: nodes then hold pool
        # block ids and insert / evict move refcounts instead of rows
        self._pool = None
        self._dense_bound = False
        self._agreed = False            # bound by a decoder on a mesh
        self.sharded = False            # ... of more than one rank
        self.mesh = None                # ... that one
        # the host tier: an attached HostBlockStore turns eviction of
        # pool blocks into demotion, and its promoter re-lands them
        self._host = None
        self._promoter = None
        # the KV memory ledger: dense inserts / evictions charge the
        # device tier here (paged bytes are the pool's to report), and a
        # release of an unpinned block is a recorded violation
        self._ledger = None
        self._registry = registry or default_registry()
        self.stats = MirroredStats(
            {"hits": 0, "misses": 0, "hit_tokens": 0, "miss_tokens": 0,
             "inserts": 0, "evictions": 0, "insert_refused": 0,
             "session_handles": 0, "session_released": 0,
             "demoted": 0, "promoted": 0},
            metric="prefix_cache_events_total",
            help="prefix KV cache events by kind",
            registry=self._registry,
            skip=("hit_tokens", "miss_tokens"))
        self._gauge_bytes = self._registry.gauge(
            "prefix_cache_bytes",
            "bytes pinned by cached prefix KV blocks",
            labels={"cache": self.name})
        self._gauge_blocks = self._registry.gauge(
            "prefix_cache_blocks", "cached prefix KV blocks",
            labels={"cache": self.name})
        self._token_counters: dict = {}

    # -- binding -----------------------------------------------------------
    def bind(self, layout: tuple, paged: bool = False,
             device=None, agreed: bool = False,
             sharded: bool = False, mesh=None) -> None:
        """Record (and enforce) the storage layout this cache holds:
        decoders sharing a cache must agree on (layers, KV heads, head
        dim, dtype, int8-ness, block size), or a hit would land rows of
        the wrong shape in a live slot.  `paged` records the binder's
        storage kind, so dense and paged decoders never share one cache
        whichever binds first (a dense node's rows and a paged node's
        pool id are unreadable to the other).  `device` is where a
        dense cache's installed rows land.  `agreed`: the binder serves
        on a mesh, whose round note decides when a promotion lands
        (serving.py's header); `sharded`: a mesh of more than one rank
        (`mesh`), whose blocks hold this rank's KV heads only."""
        if self._layout is None:
            self._layout = tuple(layout)
        elif self._layout != tuple(layout):
            raise ValueError(
                f"prefix cache {self.name!r} already bound to layout "
                f"{self._layout}, decoder wants {tuple(layout)}")
        self._dense_bound = self._dense_bound or not paged
        if agreed:
            self._agreed = True
            if self._promoter is not None:
                self._promoter.agreed = True
        self.sharded = self.sharded or bool(sharded)
        if mesh is not None:
            self.mesh = mesh
        if device is not None and self._device is None:
            self._device = torch.device(device)

    @property
    def layout(self) -> tuple | None:
        """The bound storage layout (None before the first bind): the
        geometry handshake the disaggregated KV transfer carries; the
        decode side refuses a mismatch before any row lands."""
        return self._layout

    @property
    def paged(self) -> bool:
        return self._pool is not None

    @property
    def agreed(self) -> bool:
        """Bound by a decoder on a mesh (one rank included), whose round
        note decides this cache's timed changes."""
        return self._agreed

    @property
    def pool(self):
        """The attached BlockPool, or None: what a second paged decoder
        sharing this cache adopts at construction."""
        return self._pool

    def attach_pool(self, pool) -> None:
        """Bind this cache to a paged decoder's BlockPool: cached blocks
        become refcounted pool residents.  One pool per cache."""
        if self._pool is not None and self._pool is not pool:
            raise ValueError(
                f"prefix cache {self.name!r} is already attached to "
                f"pool {self._pool.name!r}")
        if self._dense_bound:
            raise ValueError(
                f"prefix cache {self.name!r} is bound by a dense "
                f"decoder; dense and paged decoders cannot share a "
                f"cache")
        if self._pool is None and self._nodes:
            raise ValueError(
                f"prefix cache {self.name!r} holds dense blocks; it "
                f"cannot switch to paged storage")
        self._pool = pool
        if self._ledger is not None:
            pool.attach_ledger(self._ledger)

    def attach_ledger(self, ledger) -> None:
        """Wire the KV memory ledger through every tier this cache
        fronts: the pool reports device transitions, the host store
        demotions, host evictions and promotions, and the cache itself
        dense bytes and double releases.  One call covers the stack
        whichever attach order the caller used."""
        self._ledger = ledger
        if ledger is None:
            return
        ledger.attach_cache(self)
        if self._pool is not None:
            self._pool.attach_ledger(ledger)
        if self._host is not None:
            self._host.attach_ledger(ledger)

    def attach_host_store(self, store, promoter=None) -> None:
        """Bring the host KV tier online: pool blocks DEMOTE into
        `store` instead of vanishing when LRU pressure or the
        SessionTable's demotion wheel evicts them, and the promoter's
        prefetch / promote_for seam re-lands them ahead of the prompts
        that need them.  Paged caches only."""
        if self._dense_bound:
            raise ValueError(
                f"prefix cache {self.name!r} is bound by a dense "
                f"decoder; the host tier offloads pool blocks")
        if self._host is not None and self._host is not store:
            raise ValueError(
                f"prefix cache {self.name!r} already has host store "
                f"{self._host.name!r}")
        self._host = store
        if self._ledger is not None:
            store.attach_ledger(self._ledger)
        if self._promoter is None:
            if promoter is None:
                from .serving_tiered import AsyncPromoter
                promoter = AsyncPromoter(self, store,
                                         registry=self._registry)
            self._promoter = promoter
            promoter.agreed = promoter.agreed or self._agreed

    @property
    def host_store(self):
        return self._host

    @property
    def promoter(self):
        return self._promoter

    @property
    def tiered(self) -> bool:
        return self._host is not None

    @property
    def promotions_ready(self) -> bool:
        """Staged async promotions wait for poll_promotions() (checked
        every admit round)."""
        return self._promoter is not None and self._promoter.ready

    def prefetch(self, tenant: str, tokens,
                 agreed_kick: bool = False) -> int:
        """Non-blocking promotion kick for this prompt's host-resident
        chain tail (admission probes, session touches).  No-op without a
        host tier, and bound on a mesh, unless `agreed_kick` (the round
        note's kick for an agreed arrival, made alike on every rank)."""
        if self._promoter is None:
            return 0
        return self._promoter.prefetch(tenant, tokens,
                                       agreed_kick=agreed_kick)

    def landed_promotions(self) -> list:
        """The staged promotions ready to land here, as picklable
        identities, in kick order (a decoder on a mesh sends them in its
        round note)."""
        if self._promoter is None:
            return []
        return self._promoter.landed()

    def land_promotions(self, jobs) -> int:
        """Install the staged promotions named by `jobs` (identities of
        landed_promotions), in order: a decoder on a mesh lands those
        its round note found on every rank.  Returns tokens landed."""
        if self._promoter is None:
            return 0
        return self._promoter.land(jobs)

    def promotion_pending(self, tenant: str, tokens) -> bool:
        """Bound on a mesh: an agreed kick of this prompt's chain tail
        lands at a later round note, and its admit waits for it."""
        return self._promoter is not None and \
            self._promoter.pending(tenant, tokens)

    @property
    def promotions_inflight(self) -> bool:
        """Kicked promotions that have not landed (or been given up)."""
        return self._promoter is not None and self._promoter.inflight

    def age_promotions(self, bound: int) -> None:
        """Bound on a mesh: one more round note passed; agreed kicks
        older than `bound` notes that did not land are given up."""
        if self._promoter is not None:
            self._promoter.age(bound)

    def poll_promotions(self) -> int:
        """Land staged async promotions (event loop only; a no-op when
        bound on a mesh, where the round note lands them)."""
        if self._promoter is None:
            return 0
        return self._promoter.poll()

    def promote_for(self, tenant: str, tokens) -> int:
        """Admit-time fallback: make this prompt's promotable chain
        tail device-resident before the probe runs."""
        if self._promoter is None:
            return 0
        return self._promoter.promote_for(tenant, tokens)

    def wire_layout(self) -> tuple:
        """The bound layout as wire-safe string fields (what
        transport.wire.encode_kv_transfer ships)."""
        return tuple(str(f) for f in (self._layout or ()))

    def layout_compatible(self, fields) -> bool:
        """True when a transfer's declared layout fields match this
        cache's bound layout (compared as strings: the fields crossed a
        text-semantics wire)."""
        return self._layout is not None and \
            tuple(str(f) for f in fields) == self.wire_layout()

    def install_chain(self, tenant: str, tokens, start_block: int,
                      blocks) -> int:
        """Install shipped chain blocks [start_block, start_block +
        len(blocks)) of `tokens`: the decode side's KV admit in
        disaggregated serving.  Keys are recomputed here from the tokens
        (content-addressed: for blocks this cache holds already only the
        index crossed).  `blocks` are [{"k": per-layer leaves, "v": ...}]
        in this cache's storage layout, host arrays or tensors; every
        block's geometry is checked before any row lands.  Paged, the
        rows go into fresh pool blocks, one index copy per layer and
        plane from one pinned staging buffer, and insert_block records
        them; dense, each node owns its rows on the device, staged the
        same way.  Stops at the first budget refusal, so children never
        dangle.  Returns the blocks now resident (keys cached already
        count: the transfer confirmed them)."""
        tokens = [int(t) for t in tokens]
        count = min(len(tokens) // self.block_tokens,
                    start_block + len(blocks))
        if count <= start_block:
            return 0
        keys = self.keys_for(tenant, tokens[:count * self.block_tokens])
        entries = blocks[:count - start_block]
        self.check_chain(tokens, start_block, blocks)
        parent = keys[start_block - 1] if start_block else ""
        installed = 0
        if self.paged:
            # the alloc refs are ours; insert_block retains its own, so
            # the release at the end leaves cached blocks at refs 1 and
            # refused ones free
            pool = self._pool
            ids = _install_blocks(pool, entries, tenant)
            for j in range(start_block, count):
                if not self.insert_block(tenant, parent, keys[j],
                                         ids[j - start_block]):
                    break
                installed += 1
                parent = keys[j]
            pool.release_blocks(ids, tenant=tenant)
            if installed and self._ledger is not None:
                self._ledger.event("install", installed)
            return installed
        # one device buffer per block: each node owns its storage
        groups = [[_as_tensor(plane) for leaf in entry["k"] + entry["v"]
                   for plane in _leaf_planes(leaf)] for entry in entries]
        # a cache bound without a device lands on the card, as every
        # entry point's device=None does (resolve_device raises without
        # one)
        landed = _to_device_groups(resolve_device(self._device), groups)
        for j in range(start_block, count):
            entry, planes = entries[j - start_block], landed[j - start_block]
            rows, at = [], 0
            for leaf in entry["k"] + entry["v"]:
                width = 2 if isinstance(leaf, dict) else 1
                rows.append(_with_planes(leaf, planes[at:at + width]))
                at += width
            layers = len(entry["k"])
            if not self.insert(tenant, parent, keys[j], rows[:layers],
                               rows[layers:]):
                break
            installed += 1
            parent = keys[j]
        return installed

    def check_chain(self, tokens, start_block: int, blocks) -> None:
        """Raise ValueError (or TypeError, IndexError) where install_chain
        would refuse `blocks` before any row lands: a block whose
        geometry is not this cache's bound layout (bound on a mesh, the
        rank's own: its KV heads)."""
        count = min(len(tokens) // self.block_tokens,
                    start_block + len(blocks))
        for entry in blocks[:max(0, count - start_block)]:
            self._check_block_geometry(entry)

    def _check_block_geometry(self, entry) -> None:
        if self._layout is None:
            raise ValueError("install into an unbound prefix cache")
        check_block_geometry(self._layout, self.block_tokens, entry)

    def insert(self, tenant: str, parent: str, key: str,
               k_rows, v_rows) -> bool:
        """Register one dense block (per-layer K / V leaves [H, B, D], or
        the int8 dicts).  Content-addressed: an existing key is just
        touched.  Returns False when the byte budgets refused it (the
        caller must stop its chain there, or children would dangle)."""
        tenant = str(tenant or "default")
        if key in self._nodes:
            self._nodes.move_to_end(key)
            return True
        nbytes = L.kv_rows_nbytes(k_rows) + L.kv_rows_nbytes(v_rows)
        return self._add_node(_PrefixBlock(key, parent, tenant, k_rows,
                                           v_rows, nbytes))

    def insert_block(self, tenant: str, parent: str, key: str,
                     pool_id: int) -> bool:
        """Register one pool block under `key`: the harvest path's
        zero-copy registration retains one pool ref on `pool_id`; the
        slot's own block becomes the cache entry and no rows move.
        Content-addressed: an existing key is just touched.  Returns
        False when the byte budgets refused it (the caller must stop its
        chain there, or children would dangle)."""
        tenant = str(tenant or "default")
        if key in self._nodes:
            self._nodes.move_to_end(key)
            return True
        self._pool.retain([pool_id])
        return self._add_node(_PrefixBlock(
            key, parent, tenant, None, None, self._pool.block_nbytes,
            pool_id=int(pool_id)))

    def _add_node(self, node: _PrefixBlock) -> bool:
        """Link a new node under its parent, account its bytes and evict
        to the budgets; False when the budget evicted the newcomer."""
        self._nodes[node.key] = node
        parent_node = self._nodes.get(node.parent)
        if parent_node is not None:
            parent_node.children.add(node.key)
        self.bytes_used += node.nbytes
        self._tenant_bytes[node.tenant] = \
            self._tenant_bytes.get(node.tenant, 0) + node.nbytes
        self.stats["inserts"] += 1
        if self._ledger is not None and node.pool_id is None:
            # dense: the cache is the device tier's truth source (pool
            # bytes are charged by the pool at alloc)
            self._ledger.device_delta(node.tenant, node.nbytes,
                                      "cache_insert")
        self._evict_to_budget(node.tenant)
        if node.key not in self._nodes:  # the budget evicted the newcomer
            self.stats["insert_refused"] += 1
            self._publish_gauges()
            return False
        self._publish_gauges()
        return True

    def block_rows(self, node) -> tuple:
        """(per-layer K leaves, per-layer V leaves) of a cached block in
        the storage layout: a dense node's own rows, a paged node's views
        into the pool."""
        if node.pool_id is not None:
            return self._pool.block_rows(node.pool_id)
        return node.k_rows, node.v_rows

    # -- lookup ------------------------------------------------------------
    def keys_for(self, tenant: str, tokens) -> list:
        return prefix_chain_keys(tenant, tokens, self.block_tokens)

    def has(self, key: str) -> bool:
        return key in self._nodes

    def nodes(self, keys) -> list:
        return [self._nodes[key] for key in keys]

    def match(self, tenant: str, tokens,
              limit: int | None = None) -> tuple:
        """(chain keys, hit tokens) of the longest cached prefix, over at
        most `limit` tokens (callers cap at len - 1 so at least one
        suffix token remains to produce the first output).  A pure
        probe: no refcounts, no LRU movement, no metrics."""
        cap = len(tokens) if limit is None else min(limit, len(tokens))
        count = max(0, cap) // self.block_tokens
        if count == 0:
            return [], 0
        keys = self.keys_for(tenant, tokens[:count * self.block_tokens])
        hit = 0
        for key in keys:
            if key not in self._nodes:
                break
            hit += 1
        return keys[:hit], hit * self.block_tokens

    def acquire(self, tenant: str, tokens,
                limit: int | None = None) -> tuple:
        """match() + pin: refs += 1 on every chain node (released by the
        owner at retire), LRU touch, and the per-tenant hit/miss token
        counters."""
        keys, hit = self.match(tenant, tokens, limit)
        for key in keys:
            self._nodes[key].refs += 1
            self._nodes.move_to_end(key)
        self.stats["hits" if hit else "misses"] += 1
        self.stats["hit_tokens"] += hit
        self.stats["miss_tokens"] += len(tokens) - hit
        self._count_tokens(tenant, hit, len(tokens) - hit)
        return keys, hit

    def release(self, keys) -> None:
        for key in keys:
            node = self._nodes.get(key)
            if node is None:
                continue        # evicted or purged since the pin
            if node.refs > 0:
                node.refs -= 1
            elif self._ledger is not None:
                # an unpin of an unpinned block is a paired-release bug
                # upstream: record it under the chain key
                self._ledger.violation(
                    "double-release", tenant=node.tenant, chain_key=key,
                    detail=f"cache {self.name}: refs already 0")

    def evictable_bytes(self, tenant=None) -> int:
        """Bytes held by unpinned (refs == 0) cached blocks: the
        ledger's pinned-versus-evictable split."""
        tenant = None if tenant is None else str(tenant or "default")
        return sum(node.nbytes for node in self._nodes.values()
                   if node.refs == 0 and
                   (tenant is None or node.tenant == tenant))

    def hit_rate(self) -> float:
        total = self.stats["hit_tokens"] + self.stats["miss_tokens"]
        return self.stats["hit_tokens"] / total if total else 0.0

    def _count_tokens(self, tenant: str, hit: int, miss: int) -> None:
        tenant = str(tenant or "default")
        counters = self._token_counters.get(tenant)
        if counters is None:
            counters = tuple(self._registry.counter(
                f"serving_prefix_{kind}_tokens_total",
                f"prompt tokens {kind} by the prefix KV cache",
                labels={"cache": self.name, "tenant": tenant})
                for kind in ("hit", "miss"))
            self._token_counters[tenant] = counters
        if hit:
            counters[0].inc(hit)
        if miss:
            counters[1].inc(miss)

    # -- eviction ----------------------------------------------------------
    def tenant_bytes(self, tenant: str) -> int:
        return self._tenant_bytes.get(str(tenant or "default"), 0)

    def _over_budget(self, tenant: str) -> str | None:
        if self.tenant_max_bytes is not None and \
                self.tenant_bytes(tenant) > self.tenant_max_bytes:
            return tenant
        if self.max_bytes is not None and \
                self.bytes_used > self.max_bytes:
            return ""                   # global breach: any tenant
        return None

    def _evict_to_budget(self, tenant: str) -> None:
        """Evict LRU-first leaves (unpinned, childless) until the budgets
        hold.  A pass that frees nothing ends the loop: pinned bytes may
        exceed the budget (a block pinned by a live slot is never
        evicted), and interior blocks become leaves as their subtrees
        drain on later passes."""
        while True:
            scope = self._over_budget(tenant)
            if scope is None:
                return
            victim = None
            for node in self._nodes.values():
                if node.refs or node.children:
                    continue
                if scope and node.tenant != scope:
                    continue
                victim = node
                break
            if victim is None:
                # every evictable leaf is session-pinned: with a host
                # tier, demote the oldest session's chain and retry
                # instead of refusing the insert
                if self._host is not None and \
                        self._demote_oldest_session(scope):
                    continue
                return
            self._evict(victim)

    def _demote_oldest_session(self, scope: str | None) -> int:
        """Demote the oldest session handle (scope-matched on a tenant
        breach) to the host tier; returns device blocks freed (0 ends the
        caller's pressure loop: the remaining pins belong to live
        requests)."""
        for tenant, sid in self._sessions:
            if scope and tenant != scope:
                continue
            return self.demote_sessions([(tenant, sid)])
        return 0

    def demote_sessions(self, pairs) -> int:
        """Batch demotion in SessionTable's on_expired / on_demoted
        callback shape ([(tenant, sid), ...]): release each session's
        pin, then walk its chain leaf to root demoting blocks to the host
        tier; a block still pinned by a live request or shared with
        another chain ends the walk (it stays on the device).  Without a
        host store this is release_sessions exactly.  Returns device
        blocks demoted."""
        demoted = 0
        for tenant, sid in pairs:
            keys = self._sessions.pop(
                (str(tenant or "default"), str(sid)), None)
            if keys is None:
                continue
            self.release(keys)
            self.stats["session_released"] += 1
            if self._ledger is not None:
                self._ledger.event("session_demote")
            if self._host is None:
                continue
            for key in reversed(keys):
                node = self._nodes.get(key)
                if node is None:
                    continue    # already demoted or evicted: walk on up
                if node.refs or node.children:
                    break       # pinned or shared below: stays hot
                self._evict(node)
                demoted += 1
        return demoted

    def _evict(self, node: _PrefixBlock) -> None:
        del self._nodes[node.key]
        if node.pool_id is not None:
            # demote, not forget: with a host tier the rows copy down
            # (queued on the stream ahead of any reuse of the block)
            # before the pool ref goes; only a host-budget refusal makes
            # this a true eviction
            if self._host is not None:
                k_rows, v_rows = self._pool.block_rows(node.pool_id)
                if self._host.put_from_device(
                        node.tenant, node.parent, node.key,
                        k_rows, v_rows, node.nbytes):
                    self.stats["demoted"] += 1
            # the cache's ref goes; the pool block frees when no slot
            # table still aliases it
            self._pool.release_blocks([node.pool_id], tenant=node.tenant)
        elif self._ledger is not None:
            self._ledger.device_delta(node.tenant, -node.nbytes,
                                      "cache_evict")
        parent = self._nodes.get(node.parent)
        if parent is not None:
            parent.children.discard(node.key)
        self.bytes_used -= node.nbytes
        remaining = self._tenant_bytes.get(node.tenant, 0) - node.nbytes
        if remaining > 0:
            self._tenant_bytes[node.tenant] = remaining
        else:
            self._tenant_bytes.pop(node.tenant, None)
        self.stats["evictions"] += 1
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        self._gauge_bytes.set(self.bytes_used)
        self._gauge_blocks.set(len(self._nodes))

    def __len__(self) -> int:
        return len(self._nodes)

    # -- session-resident conversation KV ----------------------------------
    def session_store(self, tenant: str, sid: str, tokens) -> tuple:
        """Pin the longest cached chain for `tokens` under a (tenant,
        sid) handle: the finished turn's history, so the session's
        blocks survive eviction between turns.  Replaces (and releases)
        the session's previous handle.  Returns (leaf key | None, pinned
        tokens)."""
        self.session_release(tenant, sid)
        keys, hit = self.match(tenant, tokens)
        if not keys:
            return None, 0
        for key in keys:
            self._nodes[key].refs += 1
            self._nodes.move_to_end(key)
        self._sessions[(str(tenant or "default"), str(sid))] = keys
        self.stats["session_handles"] += 1
        if self._ledger is not None:
            self._ledger.event("session_pin")
        return keys[-1], hit

    def session_release(self, tenant: str, sid: str) -> bool:
        """Drop a session's pin (lease expiry / demotion): the chain
        stays cached but becomes evictable."""
        keys = self._sessions.pop(
            (str(tenant or "default"), str(sid)), None)
        if keys is None:
            return False
        self.release(keys)
        self.stats["session_released"] += 1
        return True

    def session_tokens(self, tenant: str, sid: str) -> int:
        keys = self._sessions.get(
            (str(tenant or "default"), str(sid)), ())
        return len(keys) * self.block_tokens

    def release_sessions(self, keys) -> None:
        """Batch form of session_release in SessionTable's on_expired /
        on_demoted callback shape: [(tenant, sid), ...]."""
        for tenant, sid in keys:
            self.session_release(tenant, sid)

    def sessions(self) -> list:
        """Live session handles, oldest-pinned first: [(tenant, sid)]."""
        return list(self._sessions)

    def purge(self, demote: bool = True) -> int:
        """Evict everything evictable: release every session pin, then
        strip the tree leaf-first until only request-pinned nodes
        remain (with no live request, the pool then holds no block the
        cache owned).  With demote False a host tier receives nothing
        (the drain endgame: a host copy of state another runtime now
        owns is dead weight).  Returns nodes evicted."""
        for tenant, sid in list(self._sessions):
            self.session_release(tenant, sid)
        host = self._host
        if not demote:
            self._host = None
        evicted = 0
        try:
            progress = True
            while progress:
                progress = False
                for node in list(self._nodes.values()):
                    if node.refs or node.children:
                        continue
                    self._evict(node)
                    evicted += 1
                    progress = True
        finally:
            self._host = host
        return evicted


def _fuse_decode_projections(params) -> dict:
    """The fuse_projections serving transform: each layer's attention
    gains a "qkv" linear (q, k and v weights concatenated to [dim,
    (Hq + 2 Hkv) D]) beside q / k / v, which prefill's attention still
    reads, and "gate_up" ([dim, 2 ffn]) replaces gate and up, which every
    FFN path reads through llama_ffn.  A bias raises ValueError (dropping
    one would corrupt every output).  Returns the tree as nested dicts
    and lists; the decoder's parameter bytes count the duplicate once."""
    tree = L.as_tree(params)
    layers = []
    for layer in tree["layers"]:
        layer = dict(layer)
        attn = dict(layer["attn"])
        if any("b" in attn[name] for name in ("q", "k", "v")):
            raise ValueError(
                "fuse_projections drops linear biases; refusing")
        attn["qkv"] = {"w": torch.cat([attn[name]["w"]
                                       for name in ("q", "k", "v")],
                                      dim=1)}
        layer["attn"] = attn
        if "gate" in layer:
            if "b" in layer["gate"] or "b" in layer["up"]:
                raise ValueError(
                    "fuse_projections drops FFN biases; refusing")
            layer["gate_up"] = {"w": torch.cat(
                [layer["gate"]["w"], layer["up"]["w"]], dim=1)}
            del layer["gate"], layer["up"]
        layers.append(layer)
    return {**tree, "layers": layers}


def _project_qkv(layer, config: LlamaConfig, x):
    """q/k/v [B, H, T, D] for the decode step: one fused product when the
    layer carries the fuse_projections form, else the three."""
    attn = layer["attn"]
    num_heads, num_kv = config.num_heads, config.num_kv_heads
    if "qkv" in attn:
        qkv = L.linear(attn["qkv"], x)
        q_dim = num_heads * config.head_dim
        kv_dim = num_kv * config.head_dim
        return (L._split_heads(qkv[..., :q_dim], num_heads),
                L._split_heads(qkv[..., q_dim:q_dim + kv_dim], num_kv),
                L._split_heads(qkv[..., q_dim + kv_dim:], num_kv))
    q = L._split_heads(L.linear(attn["q"], x), num_heads)
    k = L._split_heads(L.linear(attn["k"], x), num_kv)
    v = L._split_heads(L.linear(attn["v"], x), num_kv)
    return q, k, v


def _token_block_argmax(params, config: LlamaConfig, token_block,
                        attend, mesh=None):
    """Transformer pass over a [S, W] token block: `attend(i, layer,
    normed)` supplies each layer's attention output (and owns the
    cache-write strategy).  Returns the per-position argmax [S, W]
    int32 of f32 logits from the bf16 head (linear_logits): rounding the
    logits to bf16 first can flip near-ties against an f32 reference.
    torch.argmax, like jnp.argmax, returns the first maximal index.  W
    is 1 for the decode step and 1 + speculate_k for the verify.  mesh:
    sharded serving (the vocab-sharded embedding and head, the sharded
    pick; the attention seams sum their own o)."""
    x = L.embedding(params["embed"], token_block, mesh).to(config.dtype)
    for i, layer in enumerate(params["layers"]):
        x = x + attend(i, layer, L.rms_norm(layer["ln_attn"], x))
        x = x + llama_ffn(layer, config, L.rms_norm(layer["ln_mlp"], x),
                          mesh)
    x = L.rms_norm(params["ln_out"], x)
    return L.greedy_tokens(params["lm_head"], x, mesh)


# -- the dense slot cache: attention bodies -----------------------------------
# The dense cache is one [S, Hkv, T, D] tensor per layer (int8: the
# {"q", "s"} serving dict), T the round's extent (_fit_caches).  In the
# "block" KV write (JAX's default, the one the port has) the main cache
# is read-only through a round: the round's K/V go to side buffers and
# merge once at its end.  The bodies below are the numerics of JAX's
# einsums (f32 scores, -1e30 masks, one softmax over main + side, the
# weights cast to the compute dtype before f32-accumulated PV products);
# the paged kernel's plain version computes the same.

def _kv_planes(cache, dtype):
    """(dot-operand values, fold scale or None) of a main-cache leaf:
    an int8 cache's values cast to the compute dtype (exact) and its
    per-(slot, head, position) scale, folded into scores (K) and
    weights (V)."""
    if isinstance(cache, dict):
        return cache["q"].to(dtype), cache["s"]
    return cache, None


def _cache_time(cache) -> int:
    """Time extent of a main-cache leaf (tensor or int8 dict)."""
    return (cache["q"] if isinstance(cache, dict) else cache).shape[2]


def _grouped_block_attention(layer, config: LlamaConfig, x, cos, sin,
                             k_cache, v_cache, k_side, v_side,
                             entry_lengths, lengths, write_index: int,
                             side_valid, mesh=None):
    """The one place the dense decode numerics live: project QKV for
    the [S, W] block at per-slot positions `lengths`, write the block's
    K/V into the side buffers at `write_index` (in place), and attend
    over the read-only main cache (positions < entry_lengths) plus the
    side entries `side_valid` [S, W or 1, P] selects.  The decode step
    (W = 1) and the speculative verify (W = 1 + k) share it, so their
    greedy tokens agree.  Returns the attention output projection."""
    num_heads, num_kv = config.num_heads, config.num_kv_heads
    q, k, v = _project_qkv(layer, config, x)
    q = L.apply_rope(q, cos, sin, lengths)
    k = L.apply_rope(k, cos, sin, lengths)
    slots_n, _, width, head_dim = q.shape
    k_side[:, :, write_index:write_index + width] = k
    v_side[:, :, write_index:write_index + width] = v
    group = num_heads // num_kv
    rows = group * width
    # [S, Hkv, G*W, D]: row g*W + w of KV head h is query head h*G + g
    q_rows = q.reshape(slots_n, num_kv, rows, head_dim).float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))
    k_main, k_fold = _kv_planes(k_cache, x.dtype)
    v_main, v_fold = _kv_planes(v_cache, x.dtype)
    main_t = k_main.shape[2]
    side_len = k_side.shape[2]
    main_valid = (torch.arange(main_t, device=x.device)[None] <
                  entry_lengths[:, None])[:, None, None, :]
    side_ok = side_valid[:, None, None].expand(
        slots_n, 1, group, width, side_len).reshape(slots_n, 1, rows,
                                                    side_len)
    scores_main = torch.matmul(q_rows, k_main.float().transpose(-1, -2)) \
        * scale
    if k_fold is not None:
        scores_main = scores_main * k_fold[:, :, None, :]
    scores_side = torch.matmul(q_rows, k_side.float().transpose(-1, -2)) \
        * scale
    scores = torch.cat([torch.where(main_valid, scores_main, -1e30),
                        torch.where(side_ok, scores_side, -1e30)], dim=-1)
    weights = torch.softmax(scores, dim=-1)
    w_main = weights[..., :main_t]
    if v_fold is not None:
        w_main = w_main * v_fold[:, :, None, :]
    out = torch.matmul(w_main.to(v_main.dtype).float(), v_main.float()) + \
        torch.matmul(weights[..., main_t:].to(v_side.dtype).float(),
                     v_side.float())
    out = out.reshape(slots_n, num_heads, width, head_dim).to(x.dtype)
    return L.row_parallel_linear(layer["attn"]["o"], L._merge_heads(out),
                                 mesh)


def _slot_attention_block(layer, config: LlamaConfig, x, cos, sin,
                          k_cache, v_cache, k_side, v_side, entry_lengths,
                          lengths, step_index: int, mesh=None):
    """Decode attention at loop step `step_index`: the side entries
    written this round up to this step, and none past the slot's own
    take (a slot that stopped keeps its stale side rows masked)."""
    side_positions = torch.arange(k_side.shape[2], device=x.device)
    side_valid = ((side_positions[None] <= step_index) &
                  (side_positions[None] <
                   (lengths - entry_lengths + 1)[:, None]))[:, None, :]
    return _grouped_block_attention(layer, config, x, cos, sin, k_cache,
                                    v_cache, k_side, v_side, entry_lengths,
                                    lengths, step_index, side_valid, mesh)


def _slot_attention_spec(layer, config: LlamaConfig, x, cos, sin, k_cache,
                         v_cache, k_side, v_side, pos_side, entry_lengths,
                         lengths, base: int, mesh=None):
    """The speculative verify's attention: `x` carries W = 1 + k tokens a
    slot at positions lengths + [0, W).  The round's side entries carry
    their absolute positions (`pos_side`; rejected drafts hold
    _POS_INVALID), so causality inside and across verify blocks is one
    comparison, pos_side <= q_pos."""
    width = x.shape[1]
    q_pos = lengths[:, None] + torch.arange(width, device=x.device)[None]
    side_valid = pos_side[:, None, :] <= q_pos[:, :, None]      # [S, W, P]
    return _grouped_block_attention(layer, config, x, cos, sin, k_cache,
                                    v_cache, k_side, v_side, entry_lengths,
                                    lengths, base, side_valid, mesh)


# -- in-place merges with JAX's dropped indices --------------------------------

def _drop_positions(positions, live, extent: int, spare):
    """(positions with every dropped entry sent to its row's `spare`
    position, keep mask): an entry drops where `live` is False or its
    position lies outside [0, extent), as a mode="drop" scatter drops
    it.  A dropped entry writes back what its spare position holds, so
    the write keeps its shape on the device; `spare` [S] must be a
    position no kept entry of the row writes."""
    keep = live & (positions >= 0) & (positions < extent)
    return torch.where(keep, positions, spare[:, None]).long(), keep


def _merge_rows(cache, positions, keep, side) -> None:
    """Write side rows [S, H, P, D] into a dense cache leaf at per-slot
    time positions [S, P] where `keep` holds, in place; the kept
    positions of a row are distinct.  An int8 cache quantizes the side
    rows once, here."""
    rows = torch.arange(positions.shape[0], device=positions.device)[:, None]
    stored = L.quantize_kv_cache(side) if isinstance(cache, dict) else side
    for plane, values in L._plane_pairs(cache, stored):
        values = values.transpose(1, 2).to(plane.dtype)  # [S, P, H, (D)]
        mask = keep.view(*keep.shape, *([1] * (values.ndim - 2)))
        plane[rows, :, positions] = torch.where(mask, values,
                                                plane[rows, :, positions])


def _admit_context(context, slots, prompts, valid) -> None:
    """Seed the drafter's context rows of admitted slots with their
    prompts [A, bucket], in place; pad rows rewrite their own."""
    bucket = prompts.shape[1]
    current = context[slots, :bucket]
    context[slots, :bucket] = torch.where(valid[:, None], prompts, current)


def _extend_context(context, slots, chunk_tokens, offsets, valid) -> None:
    """Write a prompt chunk [A, C] into the drafter's context rows at
    each row's offset, clamped into the row as dynamic_update_slice
    clamps, in place; pad rows rewrite their own."""
    chunk = chunk_tokens.shape[1]
    starts = offsets.clamp(0, context.shape[1] - chunk)
    positions = (starts[:, None] + torch.arange(
        chunk, device=offsets.device)[None]).long()
    rows = slots.long()[:, None]
    context[rows, positions] = torch.where(valid[:, None], chunk_tokens,
                                           context[rows, positions])


# -- the decode and speculative rounds ------------------------------------------

# every decode round runs this: its fresh buffers are a per-round
# allocation, kept until the round step is captured with static ones
# graft: hot-path
def _side_buffers(config: LlamaConfig, slots_n: int, length: int,
                  device) -> tuple:
    """A round's zeroed per-layer K and V side buffers [S, Hkv, length,
    D] in the compute dtype."""
    shape = (slots_n, config.num_kv_heads, length, config.head_dim)
    k_sides = [torch.zeros(shape, dtype=config.dtype, device=device)
               for _ in range(config.num_layers)]
    return k_sides, [torch.zeros_like(side) for side in k_sides]


def _decode_steps(params, config: LlamaConfig, tokens, lengths, active,
                  budgets, eos: int, num_steps: int, attention,
                  mesh=None) -> tuple:
    """`num_steps` greedy steps for every slot with no host sync: a slot
    stops inside the loop the moment it emits `eos` or spends its
    budget.  `attention(i, layer, normed, lengths, step_index, active)`
    is one layer's attention at a step (`active`: the slots still
    decoding).  Returns (emitted [K, S], emitted_active [K, S], tokens,
    lengths)."""
    emitted, emitted_active = [], []
    for step_index in range(num_steps):
        def attend(i, layer, normed, lengths=lengths,
                   step_index=step_index, active=active):
            return attention(i, layer, normed, lengths, step_index, active)

        next_tokens = _token_block_argmax(params, config, tokens[:, None],
                                          attend, mesh)[:, 0]
        next_tokens = torch.where(active, next_tokens, tokens)
        lengths = torch.where(active, lengths + 1, lengths)
        budgets = torch.where(active, budgets - 1, budgets)
        still = active & (budgets > 0) & (next_tokens != eos)
        emitted.append(next_tokens)
        emitted_active.append(active)
        tokens, active = next_tokens, still
    return torch.stack(emitted), torch.stack(emitted_active), tokens, \
        lengths


# -- the "select" KV write ------------------------------------------------------
# JAX's first decode design (AIKO_DECODE_KV=select): each step writes its
# token's K/V into the slot cache at the slot's length (a masked select:
# only slots still decoding write, and a length past the extent writes
# nothing) and attends over the whole cache, positions <= length.  Dense,
# native KV, not speculative.  Its inner loop (AIKO_DECODE_ATTENTION) is
# "two_pass" (scores, softmax, weights), "online" (_online_decode_attention)
# or "vpu" (broadcast-multiply reductions in f32, weights not rounded);
# any other value falls through to two_pass, as in JAX.

_ONLINE_BLOCK = 256         # time block of one online-softmax sweep step


def _online_decode_attention(q_grouped, k_cache, v_cache, lengths,
                             scale: float):
    """Single-sweep GQA decode attention: a loop over 256-position time
    blocks carrying a running (max, sum, accumulator), the flash
    recurrence of JAX's lax.scan in plain PyTorch (masked with -inf, the
    tail zero-padded to a whole block).  q_grouped [S, Hkv, G, 1, D],
    caches [S, Hkv, T, D], lengths [S]; returns [S, Hkv, G, 1, D] f32."""
    slots_n, num_kv, group, num_q, head_dim = q_grouped.shape
    t_total = k_cache.shape[2]
    block = min(_ONLINE_BLOCK, t_total)
    num_blocks = -(-t_total // block)
    pad = num_blocks * block - t_total
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, pad))
    positions = torch.arange(block, device=q_grouped.device)
    q = q_grouped.float()
    shape = (slots_n, num_kv, group, num_q, 1)
    running_max = torch.full(shape, -torch.inf, device=q.device)
    running_sum = torch.zeros(shape, device=q.device)
    acc = torch.zeros((slots_n, num_kv, group, num_q, head_dim),
                      device=q.device)
    for index in range(num_blocks):
        t0 = index * block
        k_blk = k_cache[:, :, t0:t0 + block]
        v_blk = v_cache[:, :, t0:t0 + block]
        valid = ((t0 + positions)[None, :] <=
                 lengths[:, None])[:, None, None, None]   # [S,1,1,1,B]
        scores = torch.einsum("skgqd,skbd->skgqb", q, k_blk.float()) * \
            scale
        scores = torch.where(valid, scores, -torch.inf)
        new_max = torch.maximum(running_max,
                                scores.amax(dim=-1, keepdim=True))
        # rescale the old accumulator into the new max's frame
        correction = torch.exp(running_max - new_max)
        probs = torch.exp(scores - new_max)
        running_sum = running_sum * correction + \
            probs.sum(dim=-1, keepdim=True)
        acc = acc * correction + torch.einsum(
            "skgqb,skbd->skgqd", probs.to(v_blk.dtype).float(),
            v_blk.float())
        running_max = new_max
    return acc / running_sum.clamp_min(1e-30)


def _slot_attention(layer, config: LlamaConfig, x, cos, sin, k_cache,
                    v_cache, lengths, write_mask, attention_impl: str,
                    mesh=None):
    """One-token attention for every slot in the select KV write: write
    this token's K/V at each slot's own position (in place, only where
    `write_mask` [S] holds: a mid-prefill slot's stale length points into
    the prompt its extends are writing), then attend over positions <=
    lengths with the `attention_impl` inner loop.  x [S, 1, dim], caches
    [S, Hkv, T, D].  Returns the attention output projection."""
    num_heads, num_kv = config.num_heads, config.num_kv_heads
    q, k, v = _project_qkv(layer, config, x)
    q = L.apply_rope(q, cos, sin, lengths)
    k = L.apply_rope(k, cos, sin, lengths)
    t_total = k_cache.shape[2]
    rows = torch.arange(k_cache.shape[0], device=x.device)
    keep = (write_mask & (lengths < t_total))[:, None, None]
    at = lengths.clamp(0, t_total - 1).long()
    for cache, new in ((k_cache, k), (v_cache, v)):
        current = cache[rows, :, at]                       # [S, H, D]
        cache[rows, :, at] = torch.where(keep, new[:, :, 0].to(cache.dtype),
                                         current)
    slots_n, _, num_q, head_dim = q.shape
    group = num_heads // num_kv
    q_grouped = q.reshape(slots_n, num_kv, group, num_q, head_dim)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))
    positions = torch.arange(t_total, device=x.device)
    if attention_impl == "online":
        out = _online_decode_attention(q_grouped, k_cache, v_cache,
                                       lengths, scale)
    elif attention_impl == "vpu":
        valid = (positions[None] <= lengths[:, None])[:, None, None]
        q_sq = q_grouped[:, :, :, 0].float()               # [S,kv,G,D]
        scores = (q_sq[:, :, :, None, :] *
                  k_cache[:, :, None].float()).sum(dim=-1) * scale
        scores = torch.where(valid, scores, -1e30)
        weights = torch.softmax(scores, dim=-1)            # [S,kv,G,T]
        out = (weights[..., None] *
               v_cache[:, :, None].float()).sum(dim=3)[:, :, :, None, :]
    else:
        valid = (positions[None] <= lengths[:, None])[:, None, None, None]
        scores = torch.einsum("skgqd,sktd->skgqt", q_grouped.float(),
                              k_cache.float()) * scale
        scores = torch.where(valid, scores, -1e30)
        weights = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        out = torch.einsum("skgqt,sktd->skgqd", weights.float(),
                           v_cache.float())
    out = out.reshape(slots_n, num_heads, num_q, head_dim).to(x.dtype)
    return L.row_parallel_linear(layer["attn"]["o"], L._merge_heads(out),
                                 mesh)


def _build_select_step(config: LlamaConfig, attention_impl: str, device,
                       mesh=None):
    """The dense decode round in the select KV write: `num_steps`
    greedy steps, each writing its K/V into the slot caches in place
    and attending over them (no side buffers, no merge).  The signature
    and returns of _build_step's step."""
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)

    def step(params, tokens, lengths, active, budgets, k_caches, v_caches,
             *, num_steps: int, eos: int):
        def attention(i, layer, normed, lengths, _step_index, active):
            return _slot_attention(layer, config, normed, cos, sin,
                                   k_caches[i], v_caches[i], lengths,
                                   active, attention_impl, mesh)

        return _decode_steps(params, config, tokens, lengths, active,
                             budgets, eos, num_steps, attention, mesh)

    return step


def _build_step(config: LlamaConfig, device, mesh=None):
    """The dense decode round in the block KV write: `num_steps` greedy
    steps over the read-only slot caches plus per-layer side buffers,
    then one merge of each slot's side rows at its round-entry length
    (clamped into the cache, as JAX's dynamic_update_slice clamps; rows
    past a slot's take are dead cells beyond its length).  Slots
    inactive at round entry merge nothing: a mid-prefill slot's stale
    length points into the prompt its extends are writing.  Returns
    step(params, tokens, lengths, active, budgets, k_caches, v_caches,
    *, num_steps, eos) → (emitted [K, S], emitted_active [K, S], tokens,
    lengths); the caches update in place."""
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)

    def step(params, tokens, lengths, active, budgets, k_caches, v_caches,
             *, num_steps: int, eos: int):
        entry_lengths, entry_active = lengths, active
        k_sides, v_sides = _side_buffers(config, tokens.shape[0], num_steps,
                                         device)

        def attention(i, layer, normed, lengths, step_index, _active):
            return _slot_attention_block(
                layer, config, normed, cos, sin, k_caches[i], v_caches[i],
                k_sides[i], v_sides[i], entry_lengths, lengths, step_index,
                mesh)

        emitted, emitted_active, tokens, lengths = _decode_steps(
            params, config, tokens, lengths, active, budgets, eos,
            num_steps, attention, mesh)
        merge_at = entry_lengths.clamp(
            0, max(0, _cache_time(k_caches[0]) - num_steps))
        positions = (merge_at[:, None] + torch.arange(
            num_steps, device=device)[None]).long()
        keep = entry_active[:, None].expand(-1, num_steps)
        for caches, sides in ((k_caches, k_sides), (v_caches, v_sides)):
            for cache, side in zip(caches, sides):
                _merge_rows(cache, positions, keep, side)
        return emitted, emitted_active, tokens, lengths

    return step


# invalid side-buffer / context position: past any cache index, so the
# position masks fail and the merges drop it
_POS_INVALID = 1 << 30


def _spec_rope(config: LlamaConfig, k_spec: int, device) -> tuple:
    """RoPE tables for the verify: k_spec rows past max_seq_len, for the
    drafts of a block near the sequence cap (never emitted: JAX's take
    fills them with NaN, which an index past the table on the card would
    fault on instead)."""
    return L.rope_frequencies(config.head_dim, config.max_seq_len + k_spec,
                              config.rope_theta, device=device)


def _spec_scan_body(config: LlamaConfig, cos, sin, k_spec: int,
                    ngram: int, params, eos: int, k_caches, v_caches,
                    entry_lengths, k_sides, v_sides, pos_side,
                    attention=None, mesh=None):
    """The speculative draft / verify / accept step, the ONE copy the
    dense (_build_spec_step) and paged (serving_paged.
    _build_paged_spec_step) builders share; they differ only in the
    main cache they hand it (dense slot caches, or the pool leaves with
    the kernel's attention seam) and in how the round's consumed side
    entries merge at its end.  Returns body(tokens, lengths, active,
    budgets, context, step_index) → (tokens, lengths, active, budgets,
    block_argmax [S, W], emit [S, W]); the context buffer, the side
    buffers and pos_side update in place.

    `attention` is the verify attention (default _slot_attention_spec);
    it writes its block's K/V into the side buffers at the block's base
    index and returns the output projection (summed over the model axis
    of `mesh`)."""
    width = k_spec + 1
    if attention is None:
        attention = _slot_attention_spec
    device = entry_lengths.device
    slots_n = entry_lengths.shape[0]
    col = torch.arange(width, device=device)[None]              # [1, W]
    draft_steps = torch.arange(k_spec, device=device)[None]

    def draft(context, tokens, lengths):
        """Prompt-lookup drafts [S, k_spec]: match the last `ngram` tokens
        (the pending token and ngram - 1 history tokens) at every history
        position, take the LATEST hit and propose the tokens that
        followed it.  A miss proposes zeros (a certain rejection: the
        block runs at width 1 + k_spec either way, and acceptance decides
        how many tokens a step yields, never which)."""
        ctx_len = context.shape[1]
        pos = torch.arange(ctx_len, device=device)[None]        # [1, C]
        lens = lengths[:, None]
        hit = (pos >= ngram - 1) & (pos < lens) & \
            (context == tokens[:, None])
        for i in range(1, ngram):
            prev = torch.gather(context, 1,
                                (lens - i).clamp(0, ctx_len - 1).long())
            # the roll never wraps into the valid region: a hit needs
            # pos >= ngram - 1 >= i
            hit = hit & (torch.roll(context, i, dims=1) == prev)
        # prefer the latest hit whose continuation is all written
        # history (k_spec real tokens follow it); else the latest with
        # at least one
        full = hit & (pos <= lens - 1 - k_spec)
        some = hit & (pos < lens - 1)
        best_full = torch.where(full, pos, -1).amax(dim=1)
        best_some = torch.where(some, pos, -1).amax(dim=1)
        best = torch.where(best_full >= 0, best_full, best_some)  # [S]
        take = (best[:, None] + 1 + draft_steps).clamp(0, ctx_len - 1)
        drafts = torch.gather(context, 1, take)
        return torch.where(best[:, None] >= 0, drafts, 0)

    def body(tokens, lengths, active, budgets, context, step_index: int):
        drafts = draft(context, tokens, lengths)
        seq = torch.cat([tokens[:, None], drafts], dim=1)       # [S, W]
        base = step_index * width
        q_pos = lengths[:, None] + col                          # [S, W]
        # provisional: the whole block is live while it attends to
        # itself; rejected entries are invalidated after acceptance
        pos_side[:, base:base + width] = q_pos

        def attend(i, layer, normed):
            return attention(layer, config, normed, cos, sin, k_caches[i],
                             v_caches[i], k_sides[i], v_sides[i], pos_side,
                             entry_lengths, lengths, base, mesh=mesh)

        block_argmax = _token_block_argmax(params, config, seq, attend,
                                           mesh)
        # greedy acceptance: draft j survives iff the argmax after
        # consuming seq[:j + 1] reproduces it; the first miss takes the
        # model's own token (always emitted: the non-speculative step)
        match = (drafts == block_argmax[:, :-1]).to(torch.int32)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)       # [S]
        can = (col <= accepted[:, None]) & (col < budgets[:, None]) & \
            active[:, None]
        stop = (block_argmax == eos) & can
        keep = torch.cumprod(1 - stop.to(torch.int32), dim=1)
        keep_excl = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]],
                              dim=1)
        emit = can & (keep_excl > 0)
        emitted_n = emit.sum(dim=1, dtype=torch.int32)
        last = torch.gather(block_argmax, 1,
                            (emitted_n - 1).clamp(min=0).long()[:, None])
        tokens = torch.where(emitted_n > 0, last[:, 0], tokens)
        # the context takes the whole block of an active slot: entries
        # past the consumed run lie beyond the new length, rewritten by
        # the next step before the drafter (pos < length) reads them
        ctx_pos, ctx_keep = _drop_positions(
            q_pos, active[:, None].expand(-1, width), context.shape[1],
            (lengths - 1).clamp(min=0))
        rows = torch.arange(slots_n, device=device)[:, None]
        context[rows, ctx_pos] = torch.where(ctx_keep, seq,
                                             context[rows, ctx_pos])
        lengths = lengths + emitted_n
        budgets = budgets - emitted_n
        active = active & (budgets > 0) & ~(stop & emit).any(dim=1)
        pos_side[:, base:base + width] = torch.where(
            col < emitted_n[:, None], q_pos, _POS_INVALID)
        return tokens, lengths, active, budgets, block_argmax, emit

    return body


def _spec_round(config: LlamaConfig, cos, sin, k_spec: int, ngram: int,
                params, tokens, lengths, active, budgets, context, k_caches,
                v_caches, *, num_steps: int, eos: int,
                attention=None, mesh=None) -> tuple:
    """`num_steps` speculative steps for every slot (_spec_scan_body over
    fresh side buffers of num_steps x (1 + k_spec) entries, all
    _POS_INVALID).  Returns (emitted [K, S, W], emit_mask [K, S, W],
    tokens, lengths, k_sides, v_sides, pos_side): the builders merge the
    consumed side entries into their store."""
    side_len = num_steps * (k_spec + 1)
    device = tokens.device
    k_sides, v_sides = _side_buffers(config, tokens.shape[0], side_len,
                                     device)
    pos_side = torch.full((tokens.shape[0], side_len), _POS_INVALID,
                          dtype=torch.int32, device=device)
    body = _spec_scan_body(config, cos, sin, k_spec, ngram, params, eos,
                           k_caches, v_caches, lengths, k_sides, v_sides,
                           pos_side, attention=attention, mesh=mesh)
    emitted, masks = [], []
    for step_index in range(num_steps):
        tokens, lengths, active, budgets, block, emit = body(
            tokens, lengths, active, budgets, context, step_index)
        emitted.append(block)
        masks.append(emit)
    return (torch.stack(emitted), torch.stack(masks), tokens, lengths,
            k_sides, v_sides, pos_side)


def _build_spec_step(config: LlamaConfig, k_spec: int, ngram: int, device,
                     mesh=None):
    """The dense speculative round: each step drafts `k_spec` tokens a
    slot by prompt lookup in the slot's own context buffer (no second
    model), scores the 1 + k_spec block in one widened forward and
    advances each slot by its accepted run.  Greedy acceptance makes
    the emitted stream the non-speculative greedy stream; speculation
    changes only how many tokens one pass over the weights yields.  The
    main caches stay read-only; the round's side entries, tagged with
    their absolute positions, merge once at its end and the rejected
    ones (_POS_INVALID) drop.  Returns spec_step(params, tokens,
    lengths, active, budgets, context, k_caches, v_caches, *, num_steps,
    eos) → (emitted [K, S, W], emit_mask [K, S, W], tokens, lengths);
    the context buffer and the caches update in place."""
    cos, sin = _spec_rope(config, k_spec, device)

    def spec_step(params, tokens, lengths, active, budgets, context,
                  k_caches, v_caches, *, num_steps: int, eos: int):
        entry_lengths = lengths
        emitted, emit_mask, tokens, lengths, k_sides, v_sides, pos_side = \
            _spec_round(config, cos, sin, k_spec, ngram, params, tokens,
                        lengths, active, budgets, context, k_caches,
                        v_caches, num_steps=num_steps, eos=eos, mesh=mesh)
        # each consumed side entry lands at its absolute position; the
        # _POS_INVALID ones (rejected drafts, inactive slots) drop
        positions, keep = _drop_positions(
            pos_side, pos_side < _POS_INVALID, _cache_time(k_caches[0]),
            (entry_lengths - 1).clamp(min=0))
        for caches, sides in ((k_caches, k_sides), (v_caches, v_sides)):
            for cache, side in zip(caches, sides):
                _merge_rows(cache, positions, keep, side)
        return emitted, emit_mask, tokens, lengths

    return spec_step


@functools.lru_cache(maxsize=16)
def _round_step_for(config: LlamaConfig, paged: bool, k_spec: int,
                    ngram: int, device, kv_write: str = "block",
                    attention_impl: str = "two_pass", mesh=None):
    """Process-wide builder cache: decoders of one (config, cache kind,
    speculation, KV write, inner loop, device, mesh) share one round
    step and its RoPE tables."""
    if paged:
        return _build_paged_spec_step(config, k_spec, ngram, device, mesh) \
            if k_spec else _build_paged_step(config, device, mesh)
    if k_spec:
        return _build_spec_step(config, k_spec, ngram, device, mesh)
    if kv_write == "select":
        return _build_select_step(config, attention_impl, device, mesh)
    return _build_step(config, device, mesh)


# -- the dense programs: admit, prefix copy, chunk extend ----------------------

def _dense_admit(params, config: LlamaConfig, k_caches, v_caches, tokens,
                 lengths, context, prompts, true_lens, slots, valid,
                 mesh=None):
    """Bucketed single-shot prefill of `width` prompts [width, bucket]
    into the dense slot caches: each valid row's K/V prefix lands in its
    slot's rows [0, bucket) (quantized for an int8 cache), its first
    token and length in `tokens` / `lengths`, its prompt in the
    drafter's context row with speculation (all in place).  Pad rows
    (valid False) sit on distinct spare slots and rewrite their own
    content.  Returns the first tokens [width] int32."""
    from .models.llama import init_llama_caches, llama_hidden
    width, bucket = prompts.shape
    caches = init_llama_caches(config, width, bucket, device=prompts.device)
    hidden, caches = llama_hidden(params, config, prompts, caches,
                                  mesh=mesh)
    idx = (true_lens - 1).clamp(min=0).long()
    last_hidden = hidden[torch.arange(width, device=prompts.device), idx]
    firsts = L.greedy_tokens(params["lm_head"], last_hidden, mesh)
    slots = slots.long()
    for i, cache in enumerate(caches):
        for leaves, rows in ((k_caches, cache["k"]), (v_caches, cache["v"])):
            stored = L.quantize_kv_cache(rows) \
                if isinstance(leaves[i], dict) else rows
            for plane, values in L._plane_pairs(leaves[i], stored):
                mask = valid.view(-1, *([1] * (values.ndim - 1)))
                plane[slots, :, :bucket] = torch.where(
                    mask, values.to(plane.dtype), plane[slots, :, :bucket])
    tokens[slots] = torch.where(valid, firsts, tokens[slots])
    lengths[slots] = torch.where(valid, true_lens, lengths[slots])
    if context is not None:
        _admit_context(context, slots, prompts, valid)
    return firsts


def _dense_extend(params, config: LlamaConfig, k_caches, v_caches, tokens,
                  lengths, context, chunk_tokens, offsets, slots, valid,
                  finish, final_idx, mesh=None):
    """One prompt chunk [width, chunk] for mid-prefill slots of the dense
    cache: row a's tokens sit at positions offsets[a] + [0, chunk), each
    query attends its slot's cache positions <= its own over the whole
    extent, with the chunk's own K/V (exact, in the compute dtype) in
    place of the cache's at the chunk's positions; an int8 cache
    dequantizes the rest first.  Then the chunk's K/V (quantized for an
    int8 cache) land at those positions, clamped into the cache as
    dynamic_update_slice clamps.  Rows with `finish` take their first
    token from position final_idx and set their slot's token and length;
    pad rows (valid False, distinct spare slots) change nothing.
    Returns the first tokens [width] int32."""
    num_heads, num_kv = config.num_heads, config.num_kv_heads
    group = num_heads // num_kv
    width, chunk = chunk_tokens.shape
    device = chunk_tokens.device
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)
    x = L.embedding(params["embed"], chunk_tokens, mesh).to(config.dtype)
    t_cap = _cache_time(k_caches[0])
    steps = torch.arange(chunk, device=device)
    q_pos = offsets[:, None] + steps[None]                      # [A, C]
    mask = (torch.arange(t_cap, device=device)[None, None, :] <=
            q_pos[:, :, None])[:, None, None]                 # [A,1,1,C,T]
    write_pos = (offsets.clamp(0, t_cap - chunk)[:, None] +
                 steps[None]).long()
    rows_index = torch.arange(width, device=device)[:, None]
    slots = slots.long()
    keep = valid[:, None].expand(-1, chunk)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(config.head_dim)))
    for i, layer in enumerate(params["layers"]):
        q, k, v = _project_qkv(layer, config,
                               L.rms_norm(layer["ln_attn"], x))
        q = L.apply_rope(q, cos, sin, offsets)
        k = L.apply_rope(k, cos, sin, offsets)
        # the slots' rows, gathered (a copy) and dequantized
        k_rows = L.dequantize_kv_cache(_rows_of(k_caches[i], slots),
                                       x.dtype)
        v_rows = L.dequantize_kv_cache(_rows_of(v_caches[i], slots),
                                       x.dtype)
        k_rows[rows_index, :, write_pos] = k.transpose(1, 2)
        v_rows[rows_index, :, write_pos] = v.transpose(1, 2)
        q_rows = q.reshape(width, num_kv, group * chunk,
                           config.head_dim).float()
        scores = (torch.matmul(q_rows, k_rows.float().transpose(-1, -2)) *
                  scale).view(width, num_kv, group, chunk, t_cap)
        weights = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
        out = torch.matmul(
            weights.view(width, num_kv, group * chunk, t_cap)
            .to(v_rows.dtype).float(), v_rows.float())
        out = out.reshape(width, num_heads, chunk,
                          config.head_dim).to(x.dtype)
        x = x + L.row_parallel_linear(layer["attn"]["o"],
                                      L._merge_heads(out), mesh)
        x = x + llama_ffn(layer, config, L.rms_norm(layer["ln_mlp"], x),
                          mesh)
        for cache, new in ((k_caches[i], k), (v_caches[i], v)):
            stored = L.quantize_kv_cache(new) if isinstance(cache, dict) \
                else new
            for plane, values in L._plane_pairs(cache, stored):
                values = values.transpose(1, 2).to(plane.dtype)
                where = keep.view(*keep.shape,
                                  *([1] * (values.ndim - 2)))
                plane[slots[:, None], :, write_pos] = torch.where(
                    where, values, plane[slots[:, None], :, write_pos])
    x = L.rms_norm(params["ln_out"], x)
    last_hidden = x[torch.arange(width, device=device), final_idx.long()]
    firsts = L.greedy_tokens(params["lm_head"], last_hidden, mesh)
    apply = valid & finish
    tokens[slots] = torch.where(apply, firsts, tokens[slots])
    lengths[slots] = torch.where(apply, offsets + final_idx + 1,
                                 lengths[slots])
    if context is not None:
        _extend_context(context, slots, chunk_tokens, offsets, valid)
    return firsts


def _rows_of(cache, slots):
    """The given slots' rows of a dense cache leaf (a gather: a copy)."""
    if isinstance(cache, dict):
        return {key: plane[slots] for key, plane in cache.items()}
    return cache[slots]


class ContinuousDecoder:
    """Iteration-level scheduler over a fixed slot pool.

    submit() enqueues a request; drive it from an event engine (attach)
    or call pump() until idle.  Each round, decode-first: run up to
    steps_per_sync decode steps (speculate_k: verify steps of 1 +
    speculate_k tokens) for every live slot, dispatch prefix-hit admits,
    bucketed admits and prompt chunks behind them, fetch the round's
    emissions and earlier rounds' admit and extend outputs in one host
    transfer, deliver tokens and retire finished slots through their
    callbacks (harvesting their rows into the prefix cache when one is
    bound).

    The KV store is the dense slot cache (paged_kv False, the default:
    one [S, Hkv, T, D] tensor per layer whose extent T follows the
    workload) or the paged block pool (paged_kv True: blocks through
    per-slot tables, read by the paged kernel; prefix hits alias
    blocks).  kv_cache_dtype "int8" stores either as int8 with
    per-position scales.

    params: the port's Llama (models/llama.py) on `device`; device None
    means the CUDA card, "cpu" runs the kernels' plain versions.  mesh:
    sharded serving (the module header): params are this rank's shards
    (parallel.local_shards) and config the model's; the decoder serves
    on the mesh's device with the rank-local config
    (parallel.sharding.local_config) as `config`."""

    def __init__(self, params, config: LlamaConfig, max_slots: int = 8,
                 max_seq: int | None = None, eos_token: int | None = None,
                 prefill_buckets=(32, 128), steps_per_sync: int = 4,
                 t_block: int = 256, prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 weight_quant: bool = False,
                 fuse_projections: bool = False,
                 kv_cache_dtype: str | None = None,
                 speculate_k: int = 0, speculate_ngram: int = 2,
                 name: str = "decoder", registry=None,
                 prefix_cache: PrefixKVCache | None = None,
                 paged_kv: bool = False, kv_block: int = 32,
                 device=None, mesh=None):
        # the JAX decoder's A/B variants, read from its environment
        # variables at construction: the KV write ("block", the default:
        # a round's K/V go to side buffers merged at its end; "select":
        # each step writes into the slot cache and attends all of it) and
        # the select write's inner loop ("two_pass", "online", "vpu"; any
        # other value, JAX's "paged_kernel" included, is two_pass there)
        self.kv_write = os.environ.get("AIKO_DECODE_KV", "block")
        self.attention_impl = os.environ.get("AIKO_DECODE_ATTENTION",
                                             "two_pass")
        if self.kv_write not in ("block", "select"):
            raise ValueError(
                f"AIKO_DECODE_KV must be 'block' or 'select', got "
                f"{self.kv_write!r}")
        dtype_norm = (kv_cache_dtype or "native").lower()
        if dtype_norm not in ("native", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be None/'native'/'int8', got "
                f"{kv_cache_dtype!r}")
        # int8 KV: the pool stores int8 values with per-(block, head,
        # position) f32 scales; greedy outputs are not those of the
        # native pool (the stored K/V are rounded), so it is opt-in
        self.kv_int8 = dtype_norm == "int8"
        if self.kv_int8 and self.kv_write != "block":
            raise ValueError(
                "kv_cache_dtype='int8' requires the block KV write mode "
                "(AIKO_DECODE_KV=block): the select mode rewrites the "
                "whole cache per step, which would re-encode int8 every "
                "iteration")
        # self-speculative decoding: each verify step drafts speculate_k
        # tokens a slot by prompt lookup in a device-side context buffer
        # and verifies the widened block in one forward; greedy
        # acceptance keeps the emitted stream the non-speculative one.
        # The side buffers hold steps_per_sync * (1 + speculate_k)
        # entries
        self.speculate_k = int(speculate_k or 0)
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got "
                             f"{speculate_k}")
        self.speculate_ngram = int(speculate_ngram)
        if self.speculate_k and self.speculate_ngram < 1:
            raise ValueError("speculate_ngram must be >= 1")
        if self.speculate_k and self.kv_write != "block":
            raise ValueError("speculate_k requires the block KV write mode "
                             "(AIKO_DECODE_KV=block)")
        # weight-only int8 (W8A16): every linear but the MoE routers
        # becomes {w8, s} once here, which linear() and linear_logits
        # consume across prefill, extends and decode; greedy outputs are
        # those of the rounded weights, so it is opt-in.  fuse_projections
        # adds one q/k/v product and fuses gate/up for the decode step
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.size() > 1
        # on any mesh, one rank included, every decision that reads a
        # clock or a thread's timing rides the round note (_round_note)
        self.agreed = mesh is not None
        # on a mesh: this rank's KV heads of the model's, and how many
        # the model has (a shipped block carries them all)
        self.kv_heads = None
        if mesh is not None:
            from .parallel.sharding import (kv_head_range, local_config,
                                            mesh_device)
            if config.head_shards == 1:
                self.kv_heads = kv_head_range(config, mesh) + \
                    (config.num_kv_heads,)
                config = local_config(config, mesh)
            device = mesh_device(mesh)
            table = params["embed"]["table"]
            if table.shape[0] != config.vocab:
                raise ValueError(
                    f"a decoder on a mesh takes this rank's shards "
                    f"(ComputeRuntime.place_params with llama_axes, or "
                    f"parallel.local_shards): the embedding holds "
                    f"{table.shape[0]} rows, the rank's vocabulary "
                    f"{config.vocab}")
        if fuse_projections:
            params = _fuse_decode_projections(params)
        if weight_quant:
            # on a mesh a linear whose input axis is sharded (the
            # row-parallel o and down) takes each output channel's scale
            # over the whole input: the max of |w| over the ranks that
            # share it, once, here; so each rank's w8 is its slice of the
            # unsharded quantization
            input_max = None
            if mesh is not None:
                from .models.llama import llama_axes
                from .parallel.sharding import input_axis_max
                input_max = input_axis_max(mesh, llama_axes(config))
            params = L.quantize_linear_tree(params, input_max=input_max)
        self.weight_quant = bool(weight_quant)
        self.fuse_projections = bool(fuse_projections)
        # a bound prefix cache fixes the block size: its blocks ARE pool
        # blocks
        self.paged = bool(paged_kv)
        if self.paged and self.kv_write != "block":
            raise ValueError(
                "paged_kv requires the block KV write mode "
                "(AIKO_DECODE_KV=block): the select mode rewrites the "
                "whole cache inside the loop, which a block pool cannot "
                "express")
        self.kv_block = int(prefix_cache.block_tokens) \
            if prefix_cache is not None else int(kv_block)
        if self.paged and self.kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        self.config = config
        self.params = params
        self.device = resolve_device(device)
        if self.paged and self.device.type == "cuda":
            # the kernel library every round of this decoder launches
            # (decode, extend and verify), built and loaded here, once
            # (an element builds its decoder at its first stream, with
            # its weights): the rounds only look it up, so no round runs
            # nvcc
            from .ops.paged_attention import prepare_paged_kernel
            prepare_paged_kernel(config.dtype, config.head_dim)  # graft: disable=lint-blocking-call
        self.max_slots = max_slots
        self.max_seq = max_seq or config.max_seq_len
        self.eos_token = eos_token
        self.steps_per_sync = steps_per_sync
        # chunked prefill: prompts longer than the largest bucket take a
        # slot at once and prefill `prefill_chunk` tokens per round, so a
        # long prompt stalls the decoding slots by about one chunk, not
        # its whole length; also lifts the prompt cap from the largest
        # bucket to max_seq - 1.  None: bucketed single-shot prefill only
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and not \
                (1 <= self.prefill_chunk <= self.max_seq - 1):
            raise ValueError(
                f"prefill_chunk must be in [1, {self.max_seq - 1}], "
                f"got {self.prefill_chunk}")
        # per-round prefill token budget: bucketed admits stop (FIFO, no
        # reordering) and chunk advances are rationed once a round has
        # dispatched this much prefill work.  None: unbounded
        self.prefill_budget = int(prefill_budget) if prefill_budget \
            else None
        # granularity of the attention time-axis cap: each round reads
        # the blocks covering t_cap, the smallest multiple of t_block
        # covering the longest active context
        self.t_block = max(1, int(t_block))
        # buckets beyond the cache's time axis are clamped, deduped,
        # kept sorted
        self.prefill_buckets = tuple(sorted(
            {min(int(b), self.max_seq - 1) for b in prefill_buckets}))
        self.logger = logging.getLogger(f"serving.{name}")
        # hook: fires when the last slot retires and nothing is pending
        self.on_idle = None
        self._cache_t = min(self.t_block, self.max_seq)
        # the prefix cache: hash-addressed block sharing across requests
        # and sessions; bind() enforces one layout across the decoders
        # sharing it
        self.prefix_cache = prefix_cache
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        self._kv_layout = (config.num_layers, config.num_kv_heads,
                           config.head_dim, str(config.dtype),
                           self.kv_int8, self.kv_block, itemsize)
        if prefix_cache is not None:
            prefix_cache.bind(self._kv_layout, paged=self.paged,
                              device=self.device, agreed=self.agreed,
                              sharded=self.sharded,
                              mesh=mesh if self.sharded else None)
            if not self.paged and prefix_cache.paged:
                raise ValueError(
                    "prefix cache holds paged (pool-resident) blocks; a "
                    "dense decoder cannot bind it")
        # bytes one position of every slot's K and V takes, all layers
        # (int8: D values and one f32 scale): the prefix copy and harvest
        # byte counters' unit
        per_position = (config.head_dim + 4) if self.kv_int8 \
            else config.head_dim * itemsize
        self._kv_bytes_per_t = (2 * config.num_layers * max_slots *
                                config.num_kv_heads * per_position)
        self.pool = None
        if self.paged:
            self._init_pool(prefix_cache, name, registry)
        else:
            self._k = self._zero_caches()
            self._v = self._zero_caches()
        self._prefix_pad = None          # lazy zero block (dense copy-in)
        self._tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=self.device)
        self._lengths = torch.zeros_like(self._tokens)
        # the drafter's token history per slot, written by admits,
        # extends, prefix admits and the verify steps (speculation only)
        self._context = torch.zeros((max_slots, self.max_seq),
                                    dtype=torch.int32, device=self.device) \
            if self.speculate_k else None
        self._step = _round_step_for(config, self.paged, self.speculate_k,
                                     self.speculate_ngram, self.device,
                                     self.kv_write, self.attention_impl,
                                     self.mesh)
        # in-flight prefix dedup window: leading block key -> the request
        # prefilling that chain now.  Bounded by the slot pool: entries
        # unregister at early harvest or retire
        self._inflight_chains: dict[str, DecodeRequest] = {}
        self._slots: list[DecodeRequest | None] = [None] * max_slots
        self._pending: list[DecodeRequest] = []
        # on a mesh: submissions, and drain / resume calls, not yet held
        # by every rank (_round_note moves the agreed ones on), the
        # host-side group the note gathers over, the hooks whose rank-0
        # proposals ride it, and the last note's rank-0 clock and
        # admit-wait estimate
        self._arrivals: list[DecodeRequest] = []
        self._calls: list[dict] = []
        self._calls_handed = 0           # drain / resume calls, all time
        self._calls_applied = 0
        self._agree_group = _agreement_group(mesh) if self.sharded \
            else None
        self._note_hooks: list = []
        self.note_clock: float | None = None
        self._agreed_wait: float | None = None
        # round notes an agreed host-tier kick may take to land before
        # its admit stages the chain inline (rank 0's value rides the
        # note)
        self.promote_wait_notes = 8
        # admit output stash: (firsts device tensor, [(row, request)])
        # per dispatch, resolved at the NEXT round's sync
        self._admit_waves: list = []
        self._timer = None
        self._active_np = np.zeros((max_slots,), bool)
        self._budgets_np = np.zeros((max_slots,), np.int32)
        # bytes one decode step streams: every weight but the embedding
        # (a gather of S rows), the fused qkv duplicate counted once
        self._param_bytes = sum(
            leaf.numel() * leaf.element_size()
            for path, leaf in L.tree_leaves(self.params)
            if path[0] != "embed" and
            not any("qkv" in str(part) for part in path))
        # the decode-round phase profiler: every working pump round's
        # wall time split into named phases, with the modeled device
        # bytes charged to the phase that explains them; a mark is one
        # perf_counter read, so it is always on
        self.profiler = PhaseProfiler(name)
        self._registry = registry or default_registry()
        # request journeys and mergeable SLO sketches: every request gets
        # a RequestJourney tied to the ambient TraceContext, and TTFT /
        # ITL observations land in per-tenant sketch families
        # serving_{ttft,itl}_seconds{decoder, tenant[, prefill]}
        self.journeys = JourneyLog(name=name, proc=name,
                                   registry=self._registry)
        self._slo_sketches: dict = {}
        self._ledger = None              # KV memory ledger (attach_ledger)
        # a list: every working round appends a digest of its plan
        # (_plan_digest), for comparing the ranks of a mesh after a drive
        self.plan_digests: list | None = None
        self.stats = MirroredStats(
            {"steps": 0, "rounds": 0, "completed": 0, "prefills": 0,
             "occupancy_sum": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
             "useful_steps": 0, "wasted_steps": 0, "tokens_decode": 0,
             "tokens_prefill": 0, "prefill_chunks": 0, "chunk_admits": 0,
             "prefix_admits": 0, "round_prefill_tokens_max": 0,
             "admission_shed": 0, "dedup_deferred": 0, "dedup_shared": 0,
             # drafts scored and accepted by the verify, and the mean
             # tokens an emitting verify step yielded
             "spec_proposed": 0, "spec_accepted": 0,
             "accepted_per_step": 0.0,
             # bytes a hit copied into the slot and harvest copied out
             # (dense; 0 when paged: aliasing and refcounts), and
             # copy-on-extend events (paged: a write into a shared block
             # copies it first)
             "prefix_copy_bytes": 0, "harvest_copy_bytes": 0,
             "cow_copies": 0, "cow_copy_bytes": 0,
             # kv_blocks installs dropped because the prompt was cut
             "install_misaligned": 0,
             # modelled bytes the decode steps streamed (weights + the
             # KV extent), and the graceful drain: submissions refused
             # while draining, requests handed back, live slots
             # checkpointed at the deadline
             "bytes_moved": 0, "drain_refused": 0, "drain_evacuated": 0,
             "drain_checkpoints": 0},
            metric="serving_decoder_total",
            help="continuous-decoder events by kind",
            registry=self._registry,
            skip=("occupancy_sum", "prefill_s", "decode_s",
                  "accepted_per_step", "round_prefill_tokens_max",
                  "prefix_copy_bytes", "harvest_copy_bytes",
                  "cow_copy_bytes"))
        # SLO samples (seconds): TTFT per request, mean inter-token
        # latency per retired request, and each request's worst stall
        # between syncs (what chunked prefill bounds)
        self.ttft_samples: deque = deque(maxlen=8192)
        self.itl_samples: deque = deque(maxlen=8192)
        self.gap_samples: deque = deque(maxlen=8192)
        # prefill tokens dispatched in the current round (the budget's
        # account)
        self._round_prefill_tokens = 0
        # EWMA of working-round wall seconds (alpha 0.3) and of host
        # dispatch seconds per prefill token: the admit-wait estimate's
        # time base and prompt cost
        self._round_ewma: float | None = None
        self._prefill_token_ewma: float | None = None
        # graceful drain (drain): submit refuses new work, pump
        # checkpoints live slots past the deadline, and the completion
        # callback fires once when the decoder is idle
        self._draining = False
        self._drained = False
        self._drain_deadline: float | None = None
        self._drain_evacuate = None
        self._drain_complete = None
        # live slots + queued requests (the drain/shrink safety signal)
        self._gauge_active = self._registry.gauge(
            "serving_active_slots",
            "live decode slots + queued requests (the drain/shrink "
            "in-flight safety signal)", labels={"decoder": name})

    # -- public API --------------------------------------------------------
    def estimated_admit_wait(self, prompt=None,
                             tenant: str = "") -> float | None:
        """Coarse time-to-first-token wait for the NEXT submitted
        request: one working round when a slot is free, scaled by the
        backlog's share of the slot pool when all are taken; None until
        a round has been measured.  With `prompt`, adds its prefill cost
        at the measured per-token rate, crediting the tokens the prefix
        cache would hit; with a host tier it also kicks the prompt's
        promotion (otherwise a pure probe; on a mesh the promoter takes
        only the round note's kicks).  On a mesh this is this rank's own
        estimate: agreed_admit_wait gives the one the ranks decide by."""
        if self._round_ewma is None:
            return None
        free = sum(1 for request in self._slots if request is None)
        waiting = len(self._pending)
        if waiting < free:
            wait = self._round_ewma
        else:
            wait = self._round_ewma * \
                (1.0 + (waiting - free + 1) / max(1, self.max_slots))
        if prompt is not None and self._prefill_token_ewma:
            uncached = len(prompt)
            if self.prefix_cache is not None and len(prompt) > 1:
                _, hit = self.prefix_cache.match(
                    tenant, prompt, limit=len(prompt) - 1)
                uncached -= hit
                if hit < len(prompt) - 1 and self.prefix_cache.tiered:
                    # the probe knows this prompt is coming before its
                    # admit round: start re-landing its host-tier chain
                    # tail now (non-blocking)
                    self.prefix_cache.prefetch(tenant, prompt)
            wait += uncached * self._prefill_token_ewma
        return wait

    def agreed_admit_wait(self) -> float | None:
        """On a mesh, the admit-wait estimate of the last round note:
        rank 0's (estimated_admit_wait), the same on every rank; None
        before the first note."""
        return self._agreed_wait

    def add_note_hook(self, propose, apply, pending=None,
                      every: bool = False) -> None:
        """On a mesh: at every round note each rank calls propose()
        (a picklable value, consumed), and every rank then calls
        apply(value) in that round with rank 0's value, when it is
        truthy (`every`: apply(values) with every rank's value, in rank
        order, at every note).  How a timed decision made outside the
        decoder (the agent's session expiries, a disaggregated
        transfer's landing) reaches every rank in the same round.  A
        proposal rides the next note; while `pending()` is true an
        idle decoder makes one, as it does for an arrival (on more than
        one rank it waits in the gather for the other ranks' next note,
        which their own proposals or arrivals make)."""
        self._note_hooks.append((propose, apply, pending, every))

    def _note_prefill_rate(self, tokens: int, elapsed: float) -> None:
        """Fold one prefill dispatch's (tokens, wall) into the per-token
        EWMA.  A lower rate is taken outright, a higher one damped and
        clamped: a first dispatch that builds kernels or warms the
        allocator is far above the real cost."""
        if tokens <= 0 or elapsed <= 0.0:
            return
        rate = elapsed / tokens
        current = self._prefill_token_ewma
        if current is None or rate < current:
            self._prefill_token_ewma = rate
        else:
            self._prefill_token_ewma = \
                0.7 * current + 0.3 * min(rate, 10.0 * current)

    def _slo_sketch(self, kind: str, tenant: str,
                    prefill: str | None = None):
        """The (kind, tenant[, prefill]) SLO sketch, registered at first
        use: serving_{kind}_seconds{decoder, tenant[, prefill]}, the JAX
        package's family and labels (prefill splits TTFT into cached and
        cold populations)."""
        key = (kind, tenant, prefill)
        sketch = self._slo_sketches.get(key)
        if sketch is None:
            labels = {"decoder": self.journeys.name,
                      "tenant": tenant or "default"}
            if prefill is not None:
                labels["prefill"] = prefill
            sketch = self._registry.sketch(
                f"serving_{kind}_seconds",
                f"per-request {kind} seconds (mergeable quantile sketch "
                f"with worst-request trace-id exemplars)",
                labels=labels)
            self._slo_sketches[key] = sketch
        return sketch

    def submit(self, request_id: str, prompt, max_new_tokens: int,
               callback, deadline: float | None = None,
               tenant: str | None = None,
               prefill_label: str | None = None,
               kv_blocks: tuple | None = None,
               progress_callback=None, on_refused=None) -> bool:
        """Enqueue one request; its callback(request_id, tokens) fires
        at retire.  Returns False when it was refused instead (the
        callback is not invoked): while draining, or when deadline-aware
        admission sheds it (`deadline`: the request's end-to-end
        completion target in time.monotonic seconds, refused when the
        estimated admit wait already passes it).  On a mesh (one rank
        included) submit refuses nothing by time: the request waits in
        this rank's arrivals for the round note that finds it on every
        rank, and a shed (rank 0's verdict, by its clock and estimate,
        carried in the note) or an arrival while draining is reported
        at that round through on_refused(request_id, "shed" |
        "drained"), never by the return value; rank 0's deadline
        becomes the request's on every rank.  `tenant` bills the
        request's prefix-cache traffic (default: the tenant of the
        pipeline's admission note for the ambient trace, else "").
        Every submission opens a RequestJourney tied to the ambient
        TraceContext, and claims the admission note posted for it.
        Prompts keep their tail up to the largest bucket (up to max_seq
        - 1 with chunked prefill); an empty prompt becomes one pad
        token; request ids must be unique among the queued ones on a
        mesh.

        For disaggregated serving: `prefill_label` names the request's
        TTFT / journey population ("remote"); `kv_blocks` (covered
        tokens, pool ids), on a paged decoder, hands over pool blocks
        installed by install_shipped_blocks for the prompt's head, which
        admit aliases into the slot (ownership passes on acceptance
        only; a whole-prompt cover drops its last block so one suffix
        token remains): on a mesh each rank hands over the ids of its
        own head slices of the blocks, installed in the same round on
        every rank (PrefillClient applies rank 0's landing at a round
        note), and the request's admit, in that round or later, is
        ordered after the install's copies by the stream; `progress_callback(
        request, finished)` runs after each prefill chunk lands."""
        from .observe.journey import RequestJourney, take_admission_note
        from .observe.tracing import current_trace
        now = time.monotonic()
        # the request claims the admission note posted for its trace
        context = current_trace()
        note = take_admission_note(context.trace_id) \
            if context is not None else None
        journey = RequestJourney(
            request_id, now,
            trace_id=context.trace_id if context is not None else "",
            parent_span_id=context.span_id if context is not None else "",
            tenant=tenant if tenant is not None
            else (note or {}).get("tenant", ""),
            tier=(note or {}).get("tier", 1),
            deadline=deadline,
            admission_verdict=(note or {}).get("verdict", ""),
            admission_wait_s=(note or {}).get("queue_wait_s"),
            prompt_tokens=len(prompt))
        if self._draining and not self.agreed:
            # no new admissions: the caller re-routes
            self.stats["drain_refused"] += 1
            self.journeys.finish(journey, time.monotonic(),
                                 outcome="drained")
            return False
        if self.prefill_chunk:
            limit = self.max_seq - 1
        else:
            limit = min(self.max_seq - 1, self.prefill_buckets[-1])
        prompt = [int(t) for t in prompt] or [0]
        truncated = len(prompt) > limit
        prompt = prompt[-limit:]
        if self.prefix_cache is not None and len(prompt) > 1 and \
                self.prefix_cache.tiered:
            # the admit round is at least one pump away: a prefetch
            # kicked here overlaps the queue wait
            self.prefix_cache.prefetch(journey.tenant, prompt)
        if deadline is not None and not self.agreed:
            wait = self.estimated_admit_wait(prompt=prompt,
                                             tenant=journey.tenant)
            if wait is not None and now + wait >= float(deadline):
                self.stats["admission_shed"] += 1
                self.journeys.finish(journey, time.monotonic(),
                                     outcome="shed")
                return False
        if prefill_label:
            journey.prefill_label = str(prefill_label)
        request = DecodeRequest(
            request_id, prompt, int(max_new_tokens), callback,
            submit_time=now, journey=journey, deadline=deadline,
            tenant=journey.tenant, prefill_label=str(prefill_label or ""),
            progress_callback=progress_callback, on_refused=on_refused)
        if kv_blocks:
            if not self.paged:
                raise ValueError("kv_blocks install needs a paged decoder")
            covered, ids = int(kv_blocks[0]), list(kv_blocks[1])
            if truncated:
                # the ids cover the original prompt's head, which the
                # truncation cut: aliasing them would attend to another
                # prompt's KV, so the request prefills cold instead
                self.logger.warning(
                    "kv_blocks install for %s dropped: prompt exceeds "
                    "the admit cap %d (%d-token cover); cold prefill",
                    request_id, limit, covered)
                self.stats["install_misaligned"] += 1
                self.pool.release_blocks(ids, tenant=journey.tenant)
            else:
                block = self.kv_block
                usable = min(covered, len(ids) * block,
                             ((len(prompt) - 1) // block) * block)
                keep = max(0, usable // block)
                if len(ids) > keep:
                    self.pool.release_blocks(ids[keep:],
                                             tenant=journey.tenant)
                request.kv_block_ids = ids[:keep]
                request.prefix_hit = keep * block
                request.prefix_probed = True
        if self.agreed:
            if any(queued.request_id == request_id for queued in
                   self._arrivals + self._pending):
                raise ValueError(
                    f"request id {request_id!r} is queued already: a "
                    f"decoder on a mesh agrees its queue by request id")
            request.agree_key = hashlib.sha256(repr(
                (prompt, int(max_new_tokens), request.tenant)).encode()
            ).hexdigest()[:16]
            request.calls_before = self._calls_handed
            self._arrivals.append(request)
        else:
            self._pending.append(request)
        self._note_active()
        return True

    def attach_ledger(self, ledger) -> None:
        """Wire the KV memory ledger (observe/ledger.py) through this
        decoder's storage: the prefix cache fans it out to its pool and
        host tier; a cacheless paged decoder attaches the pool.  A dense
        decoder without a cache holds nothing per tenant."""
        self._ledger = ledger
        if self.prefix_cache is not None:
            self.prefix_cache.attach_ledger(ledger)
        elif self.paged and ledger is not None:
            self.pool.attach_ledger(ledger)

    @property
    def ledger(self):
        return self._ledger

    def attach(self, engine, period: float = 0.002) -> int:
        """Pump from `engine`'s timer every `period` seconds.
        Idempotent: re-attaching while pumping keeps the one timer."""
        if self._timer is None:
            self._timer = engine.add_timer_handler(self.pump, period)
        return self._timer

    @property
    def attached(self) -> bool:
        return self._timer is not None

    def detach(self, engine) -> None:
        if self._timer is not None:
            engine.remove_timer_handler(self._timer)
            self._timer = None

    def kv_wire_layout(self) -> tuple:
        """The storage layout as wire-safe string fields: what a
        cacheless paged decoder matches a transfer's donor layout
        against (PrefixKVCache.wire_layout's twin).  On a mesh the
        model's: a shipped block carries every KV head, of which this
        rank keeps its own (shard_kv_blocks)."""
        layout = list(self._kv_layout)
        if self.kv_heads is not None:
            layout[1] = self.kv_heads[2]
        return tuple(str(f) for f in layout)

    def shard_kv_blocks(self, blocks) -> list:
        """Shipped blocks ([{"k": per-layer leaves, "v": ...}], leaves
        [H, B, D] host arrays, int8 {"q", "s"} dicts) cut to this rank's
        KV heads on a mesh (parallel.sharding.kv_head_range); unchanged
        off one.  A block whose head count is not the model's raises
        ValueError, before any row lands."""
        if self.kv_heads is None:
            return list(blocks)
        first, stop, total = self.kv_heads

        def cut(leaf):
            if isinstance(leaf, dict):
                return {name: cut(plane) for name, plane in leaf.items()}
            if leaf.shape[0] != total:
                raise ValueError(
                    f"a shipped block holds {leaf.shape[0]} KV heads, the "
                    f"model {total}")
            return leaf[first:stop]

        return [{side: [cut(leaf) for leaf in block[side]]
                 for side in ("k", "v")} for block in blocks]

    def install_shipped_blocks(self, tokens, start_block: int,
                               blocks, tenant: str = "") -> tuple:
        """Write shipped chain blocks straight into fresh pool blocks
        (the cacheless paged decoder's landing) and hand the ids to the
        caller for submit(kv_blocks=...).  Returns (covered tokens, ids)
        for these blocks; the caller owns the ids (and releases them on
        a refused submit).  `start_block` > 0 continues a chunk-streamed
        install whose earlier ids the caller holds: contiguity is the
        caller's.  On a mesh the blocks carry the model's KV heads and
        each rank installs its own (shard_kv_blocks).  Raises ValueError
        on a geometry mismatch, before any row lands."""
        if not self.paged:
            raise ValueError("install_shipped_blocks needs a paged decoder")
        start = int(start_block)
        if start < 0:
            raise ValueError(f"negative start_block {start}")
        block = self.kv_block
        count = min(len(blocks), max(0, len(tokens) // block - start))
        entries = self.shard_kv_blocks(blocks[:count])
        for entry in entries:
            check_block_geometry(self._kv_layout, block, entry)
        if not entries:
            return 0, []
        return count * block, _install_blocks(self.pool, entries, tenant)

    def harvest_progress(self, request: DecodeRequest) -> int:
        """Register the complete prompt blocks written so far ([0,
        prefill_pos)) with the prefix cache now, without waiting for
        retire.  Idempotent (cached keys skip); returns the complete
        prompt blocks at the current position."""
        if self.prefix_cache is None or request.slot < 0 or \
                self._slots[request.slot] is not request:
            return 0
        pos = int(request.prefill_pos)
        self._harvest_rows(request.slot, request.tenant,
                           list(request.prompt[:pos]))
        return pos // self.prefix_cache.block_tokens

    @property
    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def idle(self) -> bool:
        return self.active_count == 0 and not self._pending and \
            not self._arrivals

    def _note_active(self) -> None:
        self._gauge_active.set(self.active_count + len(self._pending) +
                               len(self._arrivals))

    def _round_note(self) -> None:
        """On a mesh: agree this round's timed decisions (the module
        header).  Every rank sends its note: its arrivals (request id,
        content digest), its drain / resume calls, the host tier's
        promotions that landed on it, and its note hooks' proposals;
        rank 0 adds its clock, its admit-wait estimate and its deadline
        verdict on each of its arrivals.  One host-side all_gather on a
        mesh of more than one rank (none on one rank), at the top of
        every round of a busy decoder, which every rank runs alike, and
        of an idle one with arrivals or calls, which waits for the other
        ranks' next such round.  Every rank then applies rank 0's
        decisions (_apply_note).  Raises when one request id carries
        other content on another rank."""
        cache = self.prefix_cache
        busy = self.active_count or self._pending or self._admit_waves or \
            (cache is not None and cache.tiered and
             cache.promotions_inflight)
        if not busy and not self._arrivals and not self._calls and \
                not any(pending is not None and pending()
                        for _, _, pending, _ in self._note_hooks):
            return
        mine = {"arrivals": [(r.request_id, r.agree_key)
                             for r in self._arrivals],
                "calls": [call["note"] for call in self._calls],
                "landed": cache.landed_promotions()
                if cache is not None and cache.tiered else [],
                "hooks": [hook[0]() for hook in self._note_hooks]}
        if self.sharded:
            import torch.distributed as dist
            lead = dist.get_rank(self._agree_group) == 0
        else:
            lead = True
        if lead:
            now = time.monotonic()
            mine["clock"] = now
            mine["wait"] = self.estimated_admit_wait()
            mine["promote_bound"] = self.promote_wait_notes
            mine["verdicts"] = {r.request_id: (self._sheds(r, now),
                                               r.deadline, r.calls_before)
                                for r in self._arrivals}
        if self.sharded:
            every = [None] * dist.get_world_size(self._agree_group)
            dist.all_gather_object(every, mine, group=self._agree_group)
        else:
            every = [mine]
        self._apply_note(every)

    def admit_agreed(self, request_id: str, shed: bool,
                     deadline: float | None) -> None:
        """Inside a note hook's apply, on a mesh: the arrival this rank
        has just submitted, which every rank submits in that same apply,
        joins the queue at once (or is refused), with rank 0's shed
        verdict and deadline, as an arrival the note agreed."""
        request = next(r for r in self._arrivals
                       if r.request_id == request_id)
        self._arrivals.remove(request)
        self._agreed_arrival(request, {"verdicts": {
            request_id: (bool(shed), deadline, self._calls_applied)}})

    def _sheds(self, request: DecodeRequest, now: float) -> bool:
        """Rank 0's deadline verdict on one arrival, at the note: the
        unsharded submit's rule (shed when now + the estimated admit
        wait passes the deadline)."""
        if request.deadline is None:
            return False
        wait = self.estimated_admit_wait(prompt=request.prompt,
                                         tenant=request.tenant)
        return wait is not None and now + wait >= float(request.deadline)

    def _apply_note(self, every: list) -> None:
        """Apply one round note on this rank, as every rank does: rank
        0's clock and estimate become the round's; rank 0's hook
        proposals apply; the host-tier promotions that landed on every
        rank install, in rank 0's order; the arrivals that every rank
        holds join the queue in rank 0's order, except those rank 0 shed
        and, while draining, every one (each refused through
        on_refused); then the drain / resume calls that every rank holds
        apply, in order."""
        lead = every[0]
        self.note_clock = lead["clock"]
        self._agreed_wait = lead["wait"]
        for index, (_, apply, _, every_rank) in \
                enumerate(self._note_hooks):
            if every_rank:
                apply([note["hooks"][index] for note in every])
            elif lead["hooks"][index]:
                apply(lead["hooks"][index])
        cache = self.prefix_cache
        if lead["landed"]:
            held = [set(note["landed"]) for note in every]
            cache.land_promotions(
                [job for job in lead["landed"]
                 if all(job in theirs for theirs in held)])
        if cache is not None and cache.tiered:
            # an agreed kick not landed within rank 0's bound of notes
            # is given up on every rank: its admit stages inline
            cache.age_promotions(lead["promote_bound"])
        keys = [dict(note["arrivals"]) for note in every]
        for request in self._arrivals:
            for rank, theirs in enumerate(keys):
                if theirs.get(request.request_id, request.agree_key) != \
                        request.agree_key:
                    raise RuntimeError(
                        f"request {request.request_id!r} differs between "
                        f"this rank and rank {rank}: the ranks of a mesh "
                        f"must be handed the same requests")
        agreed = [entry for entry in lead["arrivals"]
                  if all(entry in theirs.items() for theirs in keys)]
        by_id = {r.request_id: r for r in self._arrivals}
        taken = {request_id for request_id, _ in agreed}
        self._arrivals = [r for r in self._arrivals
                          if r.request_id not in taken]
        count = min(len(note["calls"]) for note in every)
        calls, self._calls = self._calls[:count], self._calls[count:]
        # rank 0's order of requests and calls: an arrival joins before
        # the first call rank 0 was handed after it
        arrivals = [by_id[request_id] for request_id, _ in agreed]
        for call, note in zip(calls, lead["calls"]):
            index = self._calls_applied
            while arrivals and \
                    lead["verdicts"][arrivals[0].request_id][2] <= index:
                self._agreed_arrival(arrivals.pop(0), lead)
            self._calls_applied += 1
            if note[0] == "drain":
                call["evacuated"].extend(self._begin_drain(
                    self.note_clock, note[1], call["on_evacuate"],
                    call["on_complete"]))
            else:
                self._resume()
        for request in arrivals:
            self._agreed_arrival(request, lead)
        self._note_active()

    def _agreed_arrival(self, request: DecodeRequest, lead: dict) -> None:
        """One arrival every rank holds: refused if draining or shed by
        rank 0's verdict, else queued, with rank 0's deadline."""
        shed, request.deadline, _ = lead["verdicts"][request.request_id]
        if request.journey is not None:
            request.journey.deadline = request.deadline
        if self._draining:
            self._refuse(request, "drained")
        elif shed:
            self._refuse(request, "shed")
        else:
            self._pending.append(request)
            cache = self.prefix_cache
            if cache is not None and cache.tiered and \
                    len(request.prompt) > 1:
                # the kick submit makes off a mesh, made here alike on
                # every rank
                cache.prefetch(request.tenant, request.prompt,
                               agreed_kick=True)

    def _refuse(self, request: DecodeRequest, reason: str) -> None:
        """Refuse an agreed arrival at its round (on a mesh): counted as
        the unsharded submit counts it, its shipped pool blocks
        released, its journey closed, and its on_refused(request_id,
        reason) called."""
        self.stats["admission_shed" if reason == "shed"
                   else "drain_refused"] += 1
        if request.kv_block_ids:
            # ownership of shipped blocks passes on acceptance only
            ids, request.kv_block_ids = request.kv_block_ids, []
            self.pool.release_blocks(ids, tenant=request.tenant)
        if request.journey is not None:
            self.journeys.finish(request.journey, time.monotonic(),
                                 outcome=reason)
            request.journey = None
        if request.on_refused is not None:
            try:
                request.on_refused(request.request_id, reason)
            except Exception:
                self.logger.exception("refusal callback failed for %s",
                                      request.request_id)

    # -- graceful drain ----------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        return self._drained

    @property
    def calls_pending(self) -> bool:
        """A drain or resume call that no round note has applied yet (on
        a mesh; never off one)."""
        return bool(self._calls)

    def drain(self, deadline: float | None = None,
              on_evacuate=None, on_complete=None) -> list:
        """Arm a graceful wind-down: stop admitting, let live slots finish
        (or checkpoint them at the first round boundary past `deadline`,
        seconds from now), harvest every live chain into the prefix
        cache, and fire `on_complete(self)` once when the decoder is
        idle.  Queued requests are evacuated now and returned as
        descriptors (request_id, prompt, generated so far,
        max_new_tokens, callback, deadline, tenant) for the caller to
        resubmit; checkpointed slots evacuate the same way through
        `on_evacuate`, or, without one, their callback gets what they
        generated so far.  Re-arming tightens the deadline but never
        un-drains (resume does).  On a mesh (one rank included) the call
        is handed to every rank, as every request is, and the drain
        begins at the first round note that holds it from every rank:
        the list returned is filled then, the deadline counts from rank
        0's clock at that note, and the checkpoint comes at the round in
        which rank 0's clock passes it; queued requests agreed in that
        note are evacuated with the queue, and later arrivals are
        refused ("drained")."""
        if self.agreed:
            call = {"note": ("drain", None if deadline is None
                             else float(deadline)),
                    "on_evacuate": on_evacuate,
                    "on_complete": on_complete, "evacuated": []}
            self._calls.append(call)
            self._calls_handed += 1
            return call["evacuated"]
        return self._begin_drain(time.monotonic(), deadline, on_evacuate,
                                 on_complete)

    def _begin_drain(self, now: float, deadline, on_evacuate,
                     on_complete) -> list:
        """Arm the drain at `now` (drain's body): evacuate the queue and
        return its descriptors."""
        self._draining = True
        self._drained = False
        self._drain_deadline = None if deadline is None \
            else now + float(deadline)
        if on_evacuate is not None:
            self._drain_evacuate = on_evacuate
        if on_complete is not None:
            self._drain_complete = on_complete
        pending, self._pending = self._pending, []
        evacuated = [self._evacuate(request, now) for request in pending]
        if self._quiet():
            self._drain_finish()
        self._note_active()
        return evacuated

    def resume(self) -> None:
        """Re-open admission after a drain.  On a mesh, at the first
        round note that holds the call from every rank (as drain)."""
        if self.agreed:
            self._calls.append({"note": ("resume",)})
            self._calls_handed += 1
            return
        self._resume()

    def _quiet(self) -> bool:
        """No live slot and nothing queued: a drain is done.  On a mesh
        this reads the agreed state only (this rank's unagreed arrivals
        are refused when they are agreed)."""
        if self.agreed:
            return self.active_count == 0 and not self._pending
        return self.idle

    def _resume(self) -> None:
        self._draining = False
        self._drained = False
        self._drain_deadline = None
        self._drain_evacuate = None
        self._drain_complete = None

    def _evacuate(self, request: DecodeRequest, now: float) -> dict:
        """Close one request's journey as evacuated and hand back its
        resubmittable descriptor (prompt + generated so far is the
        continuation's prompt)."""
        if request.inflight_key and \
                self._inflight_chains.get(request.inflight_key) \
                is request:
            # a queued dedup leader leaves with its registration, or a
            # duplicate submitted after resume would wait forever
            self._inflight_chains.pop(request.inflight_key, None)
            request.inflight_key = ""
        self.stats["drain_evacuated"] += 1
        if request.journey is not None:
            self.journeys.finish(request.journey, now, outcome="evacuated")
            request.journey = None
        return {"request_id": request.request_id,
                "prompt": list(request.prompt),
                "generated": list(request.generated or []),
                "max_new_tokens": int(request.max_new_tokens),
                "callback": request.callback,
                "deadline": request.deadline,
                "tenant": request.tenant}

    def _drain_checkpoint(self) -> None:
        """The deadline checkpoint, at a round boundary: every live slot
        harvests the complete blocks of its written context into the
        prefix cache (a mid-prefill slot [0, prefill_pos); a decoding slot
        all but its last generated token, whose K/V row is written only
        when it is fed back), then evacuates with its partial generation.
        The resubmitted continuation hits the harvested chain."""
        now = time.monotonic()
        for slot in range(self.max_slots):
            request = self._slots[slot]
            if request is None:
                continue
            if self.prefix_cache is not None:
                try:
                    if request.prefilling:
                        self.harvest_progress(request)
                    else:
                        context = list(request.prompt) + \
                            list(request.generated or [])
                        self._harvest_rows(slot, request.tenant,
                                           context[:-1])
                except Exception:
                    self.logger.exception(
                        "drain checkpoint harvest failed for %s",
                        request.request_id)
                if request.prefix_nodes:
                    self.prefix_cache.release(request.prefix_nodes)
                    request.prefix_nodes = []
            if self.paged:
                self._release_slot_blocks(slot)
            self._slots[slot] = None
            self.stats["drain_checkpoints"] += 1
            descriptor = self._evacuate(request, now)
            if self._drain_evacuate is not None:
                try:
                    self._drain_evacuate(descriptor)
                except Exception:
                    self.logger.exception("drain evacuation failed for %s",
                                          request.request_id)
            else:
                try:
                    request.callback(request.request_id,
                                     descriptor["generated"])
                except Exception:
                    self.logger.exception("callback failed for %s",
                                          request.request_id)
        self._note_active()

    def _drain_finish(self) -> None:
        self._drained = True
        self._drain_deadline = None
        callback, self._drain_complete = self._drain_complete, None
        if callback is not None:
            try:
                callback(self)
            except Exception:
                self.logger.exception("drain completion callback failed")

    def phase_stats(self) -> dict:
        """The profiler's phase split of the committed rounds so far
        (PhaseProfiler.phase_stats)."""
        return self.profiler.phase_stats()

    def kv_cache_bytes(self) -> int:
        """Bytes allocated to the KV store: the dense slot caches (values
        and scales), or the pool's device arrays plus the int32 block
        tables (shared prefixes count once)."""
        if self.paged:
            return self.pool.nbytes() + int(self._tables_np.nbytes)
        return sum(L.kv_rows_nbytes(cache) for cache in self._k + self._v)

    def accept_rate(self) -> float:
        """Share of the proposed drafts the verify accepted (0.0 when
        speculation is off or nothing was scored)."""
        proposed = self.stats["spec_proposed"]
        return self.stats["spec_accepted"] / proposed if proposed \
            else 0.0

    def wasted_fraction(self) -> float:
        total = self.stats["useful_steps"] + self.stats["wasted_steps"]
        return self.stats["wasted_steps"] / total if total else 0.0

    def mean_occupancy(self) -> float:
        rounds = max(self.stats["rounds"], 1)
        return self.stats["occupancy_sum"] / rounds

    # -- scheduling --------------------------------------------------------
    def _bucket_for(self, length: int) -> int:
        for bucket in self.prefill_buckets:
            if length <= bucket:
                return bucket
        return self.prefill_buckets[-1]

    @staticmethod
    def _next_pow2(n: int) -> int:
        return 1 << max(0, (n - 1).bit_length())

    # -- paged block tables --------------------------------------------------
    def _init_pool(self, prefix_cache, name: str, registry) -> None:
        """The paged store: the block pool (a bound cache's, when it is
        already attached to one), the host and device block tables and
        the per-slot block lists."""
        block, max_slots = self.kv_block, self.max_slots
        # table width covers the worst-case extent _fit_caches can reach
        # (max_seq, plus the round merge's headroom without speculation)
        headroom = 0 if self.speculate_k else self.steps_per_sync
        self._table_blocks = -(-(self.max_seq + headroom) // block)
        initial = max_slots * (-(-self._cache_t // block))
        if prefix_cache is not None and prefix_cache.paged:
            # a decoder sharing an already-attached cache adopts its pool
            # and reserves its own slot coverage on top of what is
            # resident
            self.pool = prefix_cache.pool
            self.pool.reserve(self.pool.num_blocks - 1 + initial)
        else:
            self.pool = BlockPool(
                self.config, block, self.kv_int8, initial_blocks=initial,
                grow_blocks=max(1, max_slots * self.t_block // block),
                name=name, registry=registry, device=self.device)
            if prefix_cache is not None:
                prefix_cache.attach_pool(self.pool)
                if prefix_cache.max_bytes:
                    # the cache's pool residency up front, bounded by one
                    # full-max_seq slot population: steady state needs no
                    # growth inside the serving window
                    anticipated = min(
                        prefix_cache.max_bytes // self.pool.block_nbytes,
                        max_slots * (-(-self.max_seq // block)))
                    self.pool.reserve(initial + anticipated)
        self._tables_np = np.zeros((max_slots, self._table_blocks),
                                   np.int32)
        # reused host buffer for admit table rows
        self._tables_scratch = np.zeros_like(self._tables_np)
        self._tables_dirty = True
        self._tables_dev = None
        self._tables_dev_nb = -1
        # per-slot owned or aliased pool block ids, in table order
        self._slot_blocks: list[list] = [[] for _ in range(max_slots)]

    def _ensure_coverage(self, slot: int, upto: int,
                         tenant: str | None = None) -> None:
        """Extend `slot`'s block table to cover positions [0, upto) with
        fresh pool blocks; a no-op when already covered.  `tenant`
        defaults from the slot's request."""
        need = min(-(-max(0, upto) // self.kv_block), self._table_blocks)
        owned = self._slot_blocks[slot]
        if len(owned) >= need:
            return
        if tenant is None:
            request = self._slots[slot]
            tenant = request.tenant if request is not None else ""
        fresh = self.pool.alloc_blocks(need - len(owned), tenant=tenant)
        row = self._tables_np[slot]
        for j, block_id in enumerate(fresh, start=len(owned)):
            row[j] = block_id
        owned.extend(fresh)
        self._tables_dirty = True

    def _copy_on_write(self, slot: int, start: int, stop: int) -> list:
        """Make every block covering positions [start, stop) of `slot`
        exclusively owned before a write lands there: a shared block
        (refs > 1: aliased by the prefix cache or another slot) moves to
        a fresh block and the table is repointed, so aliased readers
        never see the write.  Returns (src, dst) pairs for the batched
        device copy.  The near-seq-cap final-chunk slide-back into a
        cached region is the one live writer of shared blocks; the
        common extend writes only owned tail blocks."""
        block = self.kv_block
        owned = self._slot_blocks[slot]
        row = self._tables_np[slot]
        request = self._slots[slot]
        tenant = request.tenant if request is not None else ""
        pairs = []
        for j in range(start // block,
                       min(-(-stop // block), len(owned))):
            old = owned[j]
            if self.pool.refs(old) <= 1:
                continue
            new = self.pool.alloc_blocks(1, tenant=tenant)[0]
            pairs.append((old, new))
            owned[j] = new
            row[j] = new
            self.pool.release_blocks([old], tenant=tenant)
            self._tables_dirty = True
        return pairs

    def _prepare_round_tables(self, occupied, num_steps: int):
        """Round prologue: extend every scanned slot's table to cover the
        positions this round's merge can write (entry length + num_steps
        tokens, per verify block of 1 + speculate_k with speculation),
        then hand back the device table at the current width."""
        per_step = 1 + self.speculate_k
        cap = self._extent_cap()
        for slot in occupied:
            request = self._slots[slot]
            owed = 0 if request.generated else 1
            current = len(request.prompt) + len(request.generated) + owed
            self._ensure_coverage(slot,
                                  min(current + num_steps * per_step, cap))
        return self._tables_device(-(-self._cache_t // self.kv_block))

    def _tables_device(self, nb: int):
        """The device block table [S, nb], copied again only when the
        host tables changed or the width moved."""
        if self._tables_dirty or nb != self._tables_dev_nb:
            self._tables_dev, = _to_device(self.device,
                                           self._tables_np[:, :nb])
            self._tables_dev_nb = nb
            self._tables_dirty = False
        return self._tables_dev

    def _release_slot_blocks(self, slot: int,
                             tenant: str | None = None) -> None:
        """Drop the slot's refs on every table block (at retire): blocks
        the cache holds live on through its refs, purely owned ones
        return to the free list."""
        owned = self._slot_blocks[slot]
        if owned:
            if tenant is None:
                request = self._slots[slot]
                tenant = request.tenant if request is not None else ""
            self.pool.release_blocks(owned, tenant=tenant)
            self._slot_blocks[slot] = []
            self._tables_np[slot, :len(owned)] = 0
            self._tables_dirty = True

    def _extent_cap(self) -> int:
        """The largest attention extent: max_seq, plus steps_per_sync of
        headroom for the block merge, which writes a round's whole side
        buffer at a slot's entry length (never attended past the slot's
        take).  The speculative merge scatters at absolute positions and
        drops those out of range, and the select write writes nothing
        past the extent, so neither needs it."""
        return self.max_seq if self.speculate_k or \
            self.kv_write != "block" \
            else self.max_seq + self.steps_per_sync

    def _zero_caches(self, t: int | None = None) -> list:
        """Fresh per-layer dense slot caches at time extent `t` (default:
        the current extent): [S, Hkv, T, D] tensors, or {"q" int8, "s"
        f32 [S, Hkv, T]} dicts for int8."""
        config = self.config
        shape = (self.max_slots, config.num_kv_heads, t or self._cache_t,
                 config.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.kv_int8:
            return [{"q": zeros(shape, torch.int8),
                     "s": zeros(shape[:3], torch.float32)}
                    for _ in range(config.num_layers)]
        return [zeros(shape, config.dtype) for _ in range(config.num_layers)]

    def _fit_caches(self, required_t: int) -> None:
        """Set the attention extent to the t_block multiple covering
        `required_t`, clamped to _extent_cap.  Paged, the pool allocates
        per block on demand, so only the table width read each round
        (and with it the bytes a step streams) follows the workload.
        Dense, the slot caches' time axis itself grows (zeros appended)
        or shrinks (a sliced copy): one whole-cache copy, amortized over
        the rounds run at the new extent.  Called with host-known
        lengths only."""
        new_t = min(self._extent_cap(),
                    -(-required_t // self.t_block) * self.t_block)
        if new_t == self._cache_t:
            return
        if not self.paged:
            def resize(plane):
                # the time axis is axis 2 of values and of scales
                if new_t > plane.shape[2]:
                    pad = list(plane.shape)
                    pad[2] = new_t - plane.shape[2]
                    return torch.cat([plane, plane.new_zeros(pad)], dim=2)
                return plane[:, :, :new_t].contiguous()

            self._k, self._v = (BlockPool._map_leaves(caches, resize)
                                for caches in (self._k, self._v))
        self._cache_t = new_t

    def _admit_pending(self) -> None:
        """Admit as many pending requests as there are free slots, in
        FIFO order.  With a prefix cache bound, each request is
        longest-prefix-matched first: a hit claims a slot, aliases the
        cached chain into its table and streams only the uncached suffix
        through _advance_prefills; a duplicate of a prompt prefilling
        now waits for the leader's blocks (the dedup window) instead of
        prefilling it twice.  Cold prompts longer than the largest
        bucket (only with prefill_chunk set) take a slot and stream in
        chunks; the others go through bucketed single-shot prefill
        groups.  With prefill_budget set, bucketed admission stops for
        the round once the budget is spent: later arrivals wait rather
        than stall the decoding slots.  With a host tier, staged
        promotions land first (a prefetch kicked rounds ago is then a
        plain hit), and a request's host-resident chain tail is promoted
        before its probe."""
        cache = self.prefix_cache
        if cache is not None and cache.promotions_ready:
            cache.poll_promotions()
        free = [s for s in range(self.max_slots) if self._slots[s] is None]
        if not free or not self._pending:
            return
        groups: dict[int, list[DecodeRequest]] = {}
        chunked: list[DecodeRequest] = []
        cached: list[DecodeRequest] = []
        deferred: list[DecodeRequest] = []      # in-flight dedup waits
        taken = 0
        index = 0
        pending = self._pending
        while index < len(pending):
            request = pending[index]
            if taken >= len(free):
                break
            if request.kv_block_ids:
                # installed by install_shipped_blocks: the blocks are in
                # the pool already, admit is a table edit and the suffix
                cached.append(request)
                taken += 1
                index += 1
                continue
            if cache is not None and request.dedup_wait:
                # deferred behind a duplicate whose prompt is prefilling:
                # the leader's prompt blocks land at its first token; a
                # leader that left without inserting releases the
                # follower to prefill cold
                if cache.has(request.dedup_wait) or \
                        request.dedup_wait not in self._inflight_chains:
                    if cache.has(request.dedup_wait):
                        self.stats["dedup_shared"] += 1
                    request.dedup_wait = ""     # the probe sees the truth
                else:
                    deferred.append(request)    # keeps its FIFO rank,
                    index += 1                  # takes no slot
                    continue
            if cache is not None and not request.prefix_probed:
                if cache.tiered:
                    if cache.promotion_pending(request.tenant,
                                               request.prompt):
                        # on a mesh: the agreed kick of this chain lands
                        # at a later note; admit then, on its hits
                        deferred.append(request)    # keeps its FIFO
                        index += 1                  # rank, no slot
                        continue
                    # whatever of the chain still lives on the host
                    # must be device-resident before the probe: a
                    # staged prefetch installs at once, else it stages
                    # inline
                    cache.promote_for(request.tenant, request.prompt)
                block = cache.block_tokens
                if len(request.prompt) > block:
                    lead = cache.keys_for(request.tenant,
                                          request.prompt[:block])[0]
                    leader = self._inflight_chains.get(lead)
                    if leader is not None and leader is not request \
                            and not cache.has(lead):
                        if leader.generated and leader.slot >= 0 and \
                                self._slots[leader.slot] is leader:
                            # the leader is past its first token: its
                            # prompt rows are written, harvest them now
                            try:
                                self._prefix_harvest_prompt(leader.slot,
                                                            leader)
                            except Exception:
                                self.logger.exception(
                                    "late prompt harvest failed for %s",
                                    leader.request_id)
                        if not cache.has(lead):
                            leader.dedup_hot = True
                            request.dedup_wait = lead
                            self.stats["dedup_deferred"] += 1
                            deferred.append(request)
                            index += 1
                            continue
                        self.stats["dedup_shared"] += 1
                request.prefix_probed = True
                keys, hit = cache.acquire(request.tenant, request.prompt,
                                          limit=len(request.prompt) - 1)
                if hit:
                    request.prefix_nodes = list(keys)
                    request.prefix_hit = hit
            if request.prefix_hit:
                cached.append(request)
            elif self.prefill_chunk and \
                    len(request.prompt) > self.prefill_buckets[-1]:
                chunked.append(request)
            else:
                bucket = self._bucket_for(len(request.prompt))
                if self.prefill_budget is not None and \
                        self._round_prefill_tokens > 0 and \
                        self._round_prefill_tokens + bucket > \
                        self.prefill_budget:
                    break        # FIFO: defer, don't reorder past it
                self._round_prefill_tokens += bucket
                groups.setdefault(bucket, []).append(request)
            if cache is not None and not request.prefix_hit and \
                    len(request.prompt) >= cache.block_tokens:
                # a cold prompt with a complete block: a potential dedup
                # leader until its blocks are cached or it retires
                request.inflight_key = cache.keys_for(
                    request.tenant,
                    request.prompt[:cache.block_tokens])[0]
                self._inflight_chains[request.inflight_key] = request
            taken += 1
            index += 1
        self._pending = deferred + pending[index:]
        admit_t = time.monotonic() if (chunked or groups or cached) \
            else 0.0
        if cached:
            self._fit_caches(max(max(self._prefix_write_len(r)
                                     for r in cached), self._cache_t))
            start = time.perf_counter()
            for request in cached:
                self._prefix_admit(free.pop(0), request, admit_t)
            self.stats["prefill_s"] += time.perf_counter() - start
        for request in chunked:
            slot = free.pop(0)
            request.slot = slot
            request.prefilling = True
            request.prefill_pos = 0
            self._slots[slot] = request
            self.stats["chunk_admits"] += 1
            if request.journey is not None:
                request.journey.admitted(admit_t, slot, "chunk-admit")
        if not groups:
            return
        # grow-only here (admits write [:bucket]); the round planner owns
        # shrinking, with every active context in view
        self._fit_caches(max(max(groups), self._cache_t))
        start = time.perf_counter()
        before = self.stats["tokens_prefill"]
        for bucket, requests in groups.items():
            while requests:
                width = min(self.max_slots,
                            self._next_pow2(len(requests)))
                chunk, requests = requests[:width], requests[width:]
                self._admit_group(bucket, width, chunk, free)
        elapsed = time.perf_counter() - start
        self.stats["prefill_s"] += elapsed
        self._note_prefill_rate(self.stats["tokens_prefill"] - before,
                                elapsed)

    # -- prefix reuse ------------------------------------------------------
    def _prefix_write_len(self, request: DecodeRequest) -> int:
        """A hit's copy-in extent: the chain's tokens padded up to a pow2
        block count (zero blocks past the hit: dead cells), capped at
        max_seq, where the exact length is taken.  Paged admits move no
        rows; there it sizes the admit round's extent and the
        speculative context seed."""
        blocks = request.prefix_hit // self.kv_block
        padded = self._next_pow2(blocks) * self.kv_block
        return padded if padded <= self.max_seq else request.prefix_hit

    def _prefix_admit(self, slot: int, request: DecodeRequest,
                      admit_t: float) -> None:
        """Admit a prefix-hit request and leave the slot mid-prefill at
        the hit boundary: _advance_prefills runs the uncached suffix, and
        its finishing extend gives the first token.  Paged, the pinned
        chain's pool blocks alias into the slot's table (one pool ref per
        block for the slot; a host-side edit, no K/V rows move).  Dense,
        the chain's rows are copied into the slot's cache rows [0,
        _prefix_write_len), queued behind the round's decode steps like
        every prefill dispatch.  With speculation the drafter's context
        row takes the cached prompt tokens either way."""
        t_write = self._prefix_write_len(request)
        if self.paged:
            count = request.prefix_hit // self.kv_block
            if request.kv_block_ids:
                # a direct install: the caller's refs pass to the slot
                ids = request.kv_block_ids[:count]
                request.kv_block_ids = []
            else:
                chain = self.prefix_cache.nodes(request.prefix_nodes)
                ids = [node.pool_id for node in chain[:count]]
                self.pool.retain(ids)
            row = self._tables_np[slot]
            for j, block_id in enumerate(ids):
                row[j] = block_id
            self._slot_blocks[slot] = list(ids)
            self._tables_dirty = True
        else:
            self._prefix_copy(slot, request, t_write)
        if self.speculate_k:
            # one context-row stage per prefix admit, straight to device
            ctx = np.zeros((t_write,), np.int32)  # graft: disable=lint-hot-alloc
            ctx[:request.prefix_hit] = request.prompt[:request.prefix_hit]
            self._context[slot, :t_write] = _to_device(self.device, ctx)[0]
            if self.paged:
                # the dense copy's bytes above carry the context row
                self.profiler.add_bytes("admit_dispatch", t_write * 4)
        request.slot = slot
        request.prefilling = True
        request.prefill_pos = request.prefix_hit
        self._slots[slot] = request
        self.stats["prefix_admits"] += 1
        if request.journey is not None:
            request.journey.prefix_hit_tokens = request.prefix_hit
            request.journey.admitted(admit_t, slot, "prefix-admit")

    def _prefix_copy(self, slot: int, request: DecodeRequest,
                     t_write: int) -> None:
        """The dense hit's copy-in: the chain's rows (then zero blocks up
        to t_write) into slot rows [0, t_write) of every layer, an int8
        chain plane by plane (no second rounding)."""
        cache = self.prefix_cache
        pad = (t_write - request.prefix_hit) // cache.block_tokens
        if pad and self._prefix_pad is None:
            config = self.config
            shape = (config.num_kv_heads, cache.block_tokens,
                     config.head_dim)
            zeros = functools.partial(torch.zeros, device=self.device)
            self._prefix_pad = {"q": zeros(shape, dtype=torch.int8),
                                "s": zeros(shape[:2], dtype=torch.float32)} \
                if self.kv_int8 else zeros(shape, dtype=self.config.dtype)
        chain = cache.nodes(request.prefix_nodes)
        for attr, caches in (("k_rows", self._k), ("v_rows", self._v)):
            for i, leaf in enumerate(caches):
                rows = L.concat_kv_rows([getattr(node, attr)[i]
                                         for node in chain] +
                                        [self._prefix_pad] * pad)
                for plane, values in L._plane_pairs(leaf, rows):
                    plane[slot, :, :t_write] = values
        copied = t_write * self._kv_bytes_per_t // self.max_slots
        self.profiler.add_bytes("admit_dispatch", copied)
        self.stats["prefix_copy_bytes"] += copied

    def _prefix_harvest(self, slot: int, request: DecodeRequest) -> None:
        """Register a retiring request's blocks with the cache: the
        prompt plus every generated token but the last (an emitted
        token's K/V lands only when it is consumed as the next input).
        Cached keys are skipped; the chain extends the request's own
        hit, so a conversation's next turn matches its whole history."""
        self._harvest_rows(slot, request.tenant,
                           list(request.prompt) +
                           [int(t) for t in request.generated[:-1]])

    def _prefix_harvest_prompt(self, slot: int,
                               request: DecodeRequest) -> None:
        """Early prompt harvest: once a dedup-hot leader's first token
        resolved, its prompt rows are written; insert the prompt blocks
        now so waiting duplicates share them.  Generated tokens still
        harvest at retire."""
        self._harvest_rows(slot, request.tenant, list(request.prompt))
        request.dedup_hot = False
        if request.inflight_key and \
                self._inflight_chains.get(request.inflight_key) \
                is request:
            self._inflight_chains.pop(request.inflight_key, None)
            request.inflight_key = ""

    def _harvest_rows(self, slot: int, tenant: str, tokens) -> None:
        """Register the complete blocks of `tokens` (the slot's written
        positions) with the prefix cache, keys already cached skipped.
        Paged, a zero-copy harvest: the slot's own pool blocks become the
        cache entries (retain + key), no rows move.  Dense, the rows are
        sliced out of the slot's cache into per-block copies."""
        cache = self.prefix_cache
        block = cache.block_tokens
        count = len(tokens) // block
        if count == 0:
            return
        keys = cache.keys_for(tenant, tokens[:count * block])
        start = 0
        while start < count and cache.has(keys[start]):
            start += 1
        if start >= count:
            return
        parent = keys[start - 1] if start else ""
        if self.paged:
            owned = self._slot_blocks[slot]
            for j in range(start, min(count, len(owned))):
                if not cache.insert_block(tenant, parent, keys[j],
                                          owned[j]):
                    break    # budget refused: stop, or children dangle
                parent = keys[j]
            return
        base, end = start * block, count * block
        k_splits, v_splits = ([L.slot_kv_blocks(leaf, slot, base, end, block)
                               for leaf in caches]
                              for caches in (self._k, self._v))
        self.stats["harvest_copy_bytes"] += \
            (end - base) * self._kv_bytes_per_t // self.max_slots
        for j in range(start, count):
            if not cache.insert(tenant, parent, keys[j],
                                [rows[j - start] for rows in k_splits],
                                [rows[j - start] for rows in v_splits]):
                break        # budget refused: stop, or children dangle
            parent = keys[j]

    def _admit_group(self, bucket: int, width: int, chunk: list,
                     free: list) -> None:
        n = len(chunk)
        slots = [free.pop(0) for _ in range(n)]
        # pad rows need DISTINCT slot ids (the order of colliding writes
        # is unspecified): remaining free slots first, then occupied ones
        # — either way the pad row rewrites that slot's own content
        used = set(slots)
        spare = [s for s in range(self.max_slots) if s not in used]
        pad_slots = spare[:width - n]
        # per-admit staging vectors: same discipline as _extend_group —
        # rewritten in full, fed straight to _to_device, alloc cost is
        # noise next to the transfer (table gather reuses scratch)
        prompts = np.zeros((width, bucket), np.int32)  # graft: disable=lint-hot-alloc
        true_lens = np.zeros((width,), np.int32)  # graft: disable=lint-hot-alloc
        valid = np.zeros((width,), bool)  # graft: disable=lint-hot-alloc
        for j, request in enumerate(chunk):
            prompts[j, :len(request.prompt)] = request.prompt
            true_lens[j] = len(request.prompt)
            valid[j] = True
        if self.paged:
            firsts = self._admit_paged(bucket, width, chunk, free, slots,
                                       pad_slots, prompts, true_lens,
                                       valid)
        else:
            # the eager device program: its temporaries are its own, as
            # a jitted program's are in the JAX package
            # graft: disable=lint-hot-alloc
            firsts = _dense_admit(
                self.params, self.config, self._k, self._v, self._tokens,
                self._lengths, self._context,
                *_to_device(self.device, prompts, true_lens,
                            slots + pad_slots, valid), mesh=self.mesh)
        # the admit's modeled bytes: one weight stream plus the K/V rows
        # written for `width` slots over `bucket` positions
        self.profiler.add_bytes(
            "admit_dispatch",
            self._param_bytes +
            width * bucket * self._kv_bytes_per_t // self.max_slots)
        # no host sync here: the request is live with its first token
        # owed; the stashed wave resolves it at the NEXT round's sync
        wave = []
        admit_t = time.monotonic()
        for j, request in enumerate(chunk):
            request.slot = slots[j]
            request.generated = []
            self._slots[slots[j]] = request
            self.stats["prefills"] += 1
            self.stats["tokens_prefill"] += len(request.prompt)
            if request.journey is not None:
                request.journey.admitted(admit_t, slots[j], "admit")
            wave.append((j, request))
        self._admit_waves.append((firsts, wave))

    def _admit_paged(self, bucket: int, width: int, chunk: list,
                     free: list, slots: list, pad_slots: list, prompts,
                     true_lens, valid):
        """The paged admit dispatch: each admitted slot gets fresh pool
        blocks padded to the block boundary; pad rows stay all-null and
        their writes drop.  Returns the first tokens (on the device)."""
        nbb = -(-bucket // self.kv_block)
        tables_rows = self._tables_scratch[:width, :nbb]
        try:
            for j, slot in enumerate(slots):
                self._ensure_coverage(slot, nbb * self.kv_block,
                                      tenant=chunk[j].tenant)
                tables_rows[j] = self._tables_np[slot, :nbb]
        except Exception:
            # pool growth refused (device memory exhausted) before any
            # slot was assigned: release what this wave claimed and put
            # the chunk back at the head of the queue
            for slot, request in zip(slots, chunk):
                self._release_slot_blocks(slot, tenant=request.tenant)
            free[:0] = slots
            self._pending[:0] = chunk
            raise
        tables_rows[len(slots):] = 0
        # the eager device program: its temporaries are its own, as
        # a jitted program's are in the JAX package
        # graft: disable=lint-hot-alloc
        return _paged_admit(
            self.params, self.config, self.pool.k_pools, self.pool.v_pools,
            self._tokens, self._lengths, self._context,
            *_to_device(self.device, prompts, true_lens, slots + pad_slots,
                        valid, tables_rows), mesh=self.mesh)

    def _advance_prefills(self) -> None:
        """Run one prompt chunk for the mid-prefill slots, batched in
        pow2 widths.  The slots closest to completion go first, so
        prompts in flight finish (and start emitting) sooner;
        prefill_budget rations how many rows advance per round (the
        first always does).  Prefix-hit suffixes stream through the same
        extends: at prefill_chunk when set, else each suffix as one
        pow2-sized chunk."""
        rows = [s for s in range(self.max_slots)
                if self._slots[s] is not None and self._slots[s].prefilling]
        if not rows:
            return
        rows.sort(key=lambda s: len(self._slots[s].prompt) -
                  self._slots[s].prefill_pos)      # fewest remaining first
        need = 0
        spent = self._round_prefill_tokens
        planned = 0
        plans_by_chunk: dict[int, list] = {}
        for slot in rows:
            request = self._slots[slot]
            total = len(request.prompt)
            remaining = total - request.prefill_pos
            chunk = self.prefill_chunk or min(
                self._next_pow2(max(1, remaining)), self.max_seq - 1)
            if self.prefill_budget is not None and planned and \
                    spent + chunk > self.prefill_budget:
                break
            spent += chunk
            planned += 1
            if remaining > chunk:
                offset, finish = request.prefill_pos, False
            else:
                # the final chunk slides BACK to end exactly at the
                # prompt's tail: the overlap recomputes K/V of the same
                # positions, and offset + chunk stays within the prompt.
                # Below a prefix hit it anchors at the written boundary
                # and pads forward instead (the cached rows are not
                # recomputed), unless the forward pad would leave the
                # sequence cap: then it slides back into the cached
                # region, and copy-on-extend keeps the shared blocks
                offset = max(0, total - chunk)
                if offset < request.prefix_hit:
                    offset = min(request.prefill_pos,
                                 self.max_seq - chunk)
                finish = True
            plans_by_chunk.setdefault(chunk, []).append(
                (slot, request, offset, finish))
            # the write extent is offset + chunk (a prompt shorter than
            # one chunk pads: decode overwrites that tail before it is
            # ever attended)
            need = max(need, offset + chunk)
        if not plans_by_chunk:
            return
        # grow-only: never let a decode-side shrink cut below the writes
        self._fit_caches(max(need, self._cache_t))
        start = time.perf_counter()
        before = self.stats["tokens_prefill"]
        for chunk, plans in plans_by_chunk.items():
            while plans:
                width = min(self.max_slots, self._next_pow2(len(plans)))
                batch, plans = plans[:width], plans[width:]
                self._extend_group(chunk, width, batch)
        elapsed = time.perf_counter() - start
        self.stats["prefill_s"] += elapsed
        self._note_prefill_rate(self.stats["tokens_prefill"] - before,
                                elapsed)

    def _extend_group(self, chunk: int, width: int, batch: list) -> None:
        """Dispatch one chunk extend for `batch` [(slot, request, offset,
        finish)] at `width` rows (pad rows on distinct spare slots,
        offset 0).  Rows that finish their prompt owe their first token,
        resolved from the stashed wave at the next round's sync."""
        n = len(batch)
        slots = [slot for slot, *_ in batch]
        used = set(slots)
        pad_slots = [s for s in range(self.max_slots)
                     if s not in used][:width - n]
        # per-extend staging vectors: rewritten in full every call and
        # handed straight to _to_device — alloc cost is noise next to
        # the device transfer they feed (unlike the table gather, which
        # reuses self._tables_scratch)
        chunk_tokens = np.zeros((width, chunk), np.int32)  # graft: disable=lint-hot-alloc
        offsets = np.zeros((width,), np.int32)  # graft: disable=lint-hot-alloc
        final_idx = np.zeros((width,), np.int32)  # graft: disable=lint-hot-alloc
        valid = np.zeros((width,), bool)  # graft: disable=lint-hot-alloc
        finish_rows = np.zeros((width,), bool)  # graft: disable=lint-hot-alloc
        for j, (slot, request, offset, finish) in enumerate(batch):
            piece = request.prompt[offset:offset + chunk]
            chunk_tokens[j, :len(piece)] = piece
            offsets[j] = offset
            final_idx[j] = len(request.prompt) - 1 - offset if finish \
                else 0
            valid[j] = True
            finish_rows[j] = finish
        host = (chunk_tokens, offsets, slots + pad_slots, valid,
                finish_rows, final_idx)
        if self.paged:
            firsts = self._extend_paged(chunk, width, batch, host)
        else:
            # the eager device program: its temporaries are its own, as
            # a jitted program's are in the JAX package
            # graft: disable=lint-hot-alloc
            firsts = _dense_extend(
                self.params, self.config, self._k, self._v, self._tokens,
                self._lengths, self._context,
                *_to_device(self.device, *host), mesh=self.mesh)
        # the extend's modeled bytes: one weight stream plus each row's
        # prefix read and chunk write
        row_bytes = self._kv_bytes_per_t // self.max_slots
        self.profiler.add_bytes(
            "extend_dispatch",
            self._param_bytes + sum((offset + chunk) * row_bytes
                                    for _, _, offset, _ in batch))
        wave = []
        for j, (slot, request, offset, finish) in enumerate(batch):
            new_pos = len(request.prompt) if finish else offset + chunk
            self.stats["tokens_prefill"] += max(0,
                                                new_pos - request.prefill_pos)
            request.prefill_pos = new_pos
            if request.progress_callback is not None:
                # a prefill runtime harvests and ships the chunk's
                # finished blocks from here (a host-side table walk)
                try:
                    request.progress_callback(request, bool(finish))
                except Exception:
                    self.logger.exception(
                        "progress callback failed for %s",
                        request.request_id)
            if request.journey is not None:
                request.journey.wave("extend")
            if finish:
                request.prefilling = False
                request.generated = []            # first token owed
                wave.append((j, request))
            self.stats["prefill_chunks"] += 1
            self._round_prefill_tokens += chunk
        if wave:
            # resolved at the NEXT round's sync: the extend runs behind
            # this round's decode steps
            self._admit_waves.append((firsts, wave))

    def _extend_paged(self, chunk: int, width: int, batch: list, host):
        """The paged extend dispatch: a shared block under the chunk's
        writes [offset, offset + chunk) is copied to a fresh one first
        (copy-on-extend), queued on the stream before the extend; pad
        rows get null tables.  Returns the first tokens (on the
        device)."""
        pairs = []
        for slot, request, offset, finish in batch:
            self._ensure_coverage(slot, offset + chunk)
            pairs.extend(self._copy_on_write(slot, offset, offset + chunk))
        if pairs:
            copied = self.pool.copy_blocks([src for src, _ in pairs],
                                           [dst for _, dst in pairs])
            self.stats["cow_copies"] += len(pairs)
            self.stats["cow_copy_bytes"] += copied
        nbt = -(-self._cache_t // self.kv_block)
        tables_rows = self._tables_scratch[:width, :nbt]
        for j, (slot, *_) in enumerate(batch):
            tables_rows[j] = self._tables_np[slot, :nbt]
        tables_rows[len(batch):] = 0              # pad rows stay null
        # the eager device program: its temporaries are its own, as
        # a jitted program's are in the JAX package
        # graft: disable=lint-hot-alloc
        return _paged_extend(
            self.params, self.config, self.pool.k_pools, self.pool.v_pools,
            self._tokens, self._lengths, self._context,
            *_to_device(self.device, *host, tables_rows),
            t_cap=self._cache_t, mesh=self.mesh)

    def _finished(self, request: DecodeRequest, token: int) -> bool:
        return (self.eos_token is not None and token == self.eos_token) \
            or len(request.generated) >= request.max_new_tokens \
            or len(request.prompt) + len(request.generated) >= \
            self.max_seq - 1

    def _retire(self, slot: int) -> None:
        request = self._slots[slot]
        if request.inflight_key and \
                self._inflight_chains.get(request.inflight_key) \
                is request:
            # the dedup registration ends with the request; a follower
            # still waiting re-probes (cold if the harvest is refused)
            self._inflight_chains.pop(request.inflight_key, None)
        if self.prefix_cache is not None:
            # harvest BEFORE releasing the request's own pins: the hit
            # chain must stay resident while the new blocks link to it
            try:
                self._prefix_harvest(slot, request)
            except Exception:
                self.logger.exception("prefix harvest failed for %s",
                                      request.request_id)
            if request.prefix_nodes:
                self.prefix_cache.release(request.prefix_nodes)
                request.prefix_nodes = []
        if self.paged:
            # after the harvest retained what it keeps: cache-held blocks
            # live on, purely owned ones return to the free list
            self._release_slot_blocks(slot)
        self._slots[slot] = None
        self._note_active()
        self.stats["completed"] += 1
        journey = request.journey
        count = len(request.generated)
        if count >= 2 and request.last_time > request.first_time:
            itl = (request.last_time - request.first_time) / (count - 1)
            self.itl_samples.append(itl)
            self._slo_sketch(
                "itl", journey.tenant if journey else "").observe(
                itl, exemplar=(journey.trace_id or request.request_id)
                if journey else None)
        if request.max_gap > 0:
            self.gap_samples.append(request.max_gap)
        if journey is not None:
            # completion closes the journey: deadline margin, outcome per
            # tenant, spans under the frame's trace id
            self.journeys.finish(journey, request.last_time or
                                 time.monotonic())
        generated = request.generated
        if self.eos_token is not None and generated and \
                generated[-1] == self.eos_token:
            generated = generated[:-1]
        try:
            request.callback(request.request_id, generated)
        except Exception:
            self.logger.exception("callback failed for %s",
                                  request.request_id)

    def _round_plan(self, occupied) -> tuple:   # graft: hot-path
        """(num_steps, required_t, budgets): how long to run before the
        next host sync, the attention extent this round needs, and how
        many tokens each slot may still emit.  num_steps is
        retire-aligned (with requests waiting, the round ends near the
        earliest retirement so the freed slot refills) and pow2-ceiled;
        the in-loop budget mask absorbs the overshoot.  With speculation
        a step can yield its whole block of 1 + speculate_k tokens, so
        the steps a budget needs, and the extent a round can write, are
        counted per block."""
        budgets = self._budgets_np
        budgets.fill(0)
        max_len = 0
        per_step = 1 + self.speculate_k
        for slot in occupied:
            request = self._slots[slot]
            # a just-admitted slot still OWES its first token (resolved
            # from its admit wave at this round's sync)
            owed = 0 if request.generated else 1
            generated = len(request.generated) + owed
            current = len(request.prompt) + generated
            budgets[slot] = max(0, min(
                request.max_new_tokens - generated,
                self.max_seq - 1 - current))
            max_len = max(max_len, current)
        remaining = budgets[occupied]
        cap = int(remaining.min()) if self._pending \
            else int(remaining.max())
        num_steps = min(self.steps_per_sync,
                        self._next_pow2(max(1, -(-cap // per_step))))
        return num_steps, max_len + num_steps * per_step + 1, budgets

    def _start_fetch(self, tensors):
        """Start ONE device→host copy of the round's int tensors; on the
        card it is queued right behind the decode steps, so the admits
        dispatched after it never delay it."""
        pieces = [t.reshape(-1).to(torch.int32) for t in tensors]
        flat = torch.cat(pieces)
        if not flat.is_cuda:
            return flat, None, [p.numel() for p in pieces]
        host = flat.to("cpu", non_blocking=True)     # pinned, async
        done = torch.cuda.Event()
        done.record()
        return host, done, [p.numel() for p in pieces]

    @staticmethod
    def _finish_fetch(fetch) -> list:
        """Wait for _start_fetch's copy (the round's one host sync) and
        split it back into numpy arrays."""
        host, done, sizes = fetch
        if done is not None:
            # the round's one allowed host sync (ROADMAP Port rule 6: one
            # per serving round); any other sync pump reaches is a finding
            # graft: disable=lint-host-transfer,lint-blocking-call
            done.synchronize()
        flat = host.numpy()
        return np.split(flat, np.cumsum(sizes)[:-1])

    @torch.no_grad()
    def pump(self) -> None:   # graft: hot-path
        """One scheduling round, decode-first: run the decode steps,
        start the host copy of their emissions (and of earlier rounds'
        admit and extend outputs), THEN dispatch admits and chunk
        extends so they run on the device while the host waits; resolve
        earlier admits' first tokens, deliver this round's emissions,
        retire finished slots.  While draining, a round past the drain
        deadline first checkpoints every live slot, and the drain
        completes once the decoder is idle.  On a mesh the round first
        agrees its timed decisions (_round_note), and the drain deadline
        is judged by rank 0's clock there."""
        if self.agreed:
            self._round_note()
        if self._draining and not self._drained:
            now = self.note_clock if self.agreed else time.monotonic()
            if self._drain_deadline is not None and now is not None and \
                    now >= self._drain_deadline and self.active_count:
                self._drain_checkpoint()
            if self._quiet():
                self._drain_finish()
        self._round_prefill_tokens = 0
        profiler = self.profiler
        profiler.begin_round()
        round_start = time.perf_counter()
        # mid-prefill slots hold a slot but do not decode yet
        active = self._active_np
        for slot in range(self.max_slots):
            request = self._slots[slot]
            active[slot] = request is not None and not request.prefilling
        waves_due, self._admit_waves = self._admit_waves, []
        scanned = False
        if active.any():
            occupied = [s for s in range(self.max_slots) if active[s]]
            num_steps, required_t, budgets = self._round_plan(occupied)
            # never shrink the extent below a mid-prefill slot's written
            # positions: the decoding slots alone may need less
            for request in self._slots:
                if request is not None and request.prefilling:
                    required_t = max(required_t, request.prefill_pos)
            self._fit_caches(required_t)
            # a slot with budget 0 (satisfied by its owed first token)
            # needs no decode
            scan_active = active & (budgets > 0)
            scanned = bool(scan_active.any())
        profiler.mark("plan")
        fetch = [firsts for firsts, _ in waves_due]
        if scanned:
            self.stats["rounds"] += 1
            self.stats["occupancy_sum"] += float(active.mean())
            decode_start = time.perf_counter()
            eos = -1 if self.eos_token is None else int(self.eos_token)
            if self.paged:
                # every scanned slot's table must own the blocks this
                # round's merge writes; then the device tables refresh if
                # dirty
                tables = self._prepare_round_tables(occupied, num_steps)
                store = (self.pool.k_pools, self.pool.v_pools, tables)
                extent = {"t_cap": self._cache_t}
            else:
                store, extent = (self._k, self._v), {}
            context = (self._context,) if self.speculate_k else ()
            emitted, emitted_active, self._tokens, self._lengths = \
                self._step(self.params, self._tokens, self._lengths,
                           *_to_device(self.device, scan_active, budgets),
                           *context, *store, num_steps=num_steps, eos=eos,
                           **extent)
            self.stats["steps"] += num_steps
            fetch = [emitted, emitted_active] + fetch
        transfer = self._start_fetch(fetch) if fetch else None
        if scanned:
            profiler.mark("spec_verify" if self.speculate_k
                          else "scan_dispatch")
        self._admit_pending()
        profiler.mark("admit_dispatch")
        self._advance_prefills()
        profiler.mark("extend_dispatch")
        self.stats["round_prefill_tokens_max"] = max(
            self.stats["round_prefill_tokens_max"],
            self._round_prefill_tokens)
        host = self._finish_fetch(transfer) if transfer else []
        if scanned:
            # [K, S], or [K, S, 1 + speculate_k] verify blocks
            shape = (num_steps, self.max_slots) + \
                ((1 + self.speculate_k,) if self.speculate_k else ())
            emitted = host[0].reshape(shape)
            emitted_active = host[1].reshape(shape).astype(bool)
            host = host[2:]
            self.stats["decode_s"] += time.perf_counter() - decode_start
            round_bytes = num_steps * (
                self._param_bytes + self._kv_bytes_per_t * self._cache_t)
            self.stats["bytes_moved"] += round_bytes
            # charged to host_sync as the JAX package charges them (its
            # sync wall); on the card the steps run while the host is
            # still launching them, so this implied rate is no device rate
            profiler.add_bytes("host_sync", round_bytes)
        profiler.mark("host_sync")
        # first tokens of admits from EARLIER rounds
        now = time.monotonic()
        for firsts, (_, wave) in zip(host, waves_due):
            for j, request in wave:
                if self._slots[request.slot] is request and \
                        not request.generated:
                    self._deliver(request.slot, int(firsts[j]), now)
        profiler.mark("wave_resolve")
        if scanned and self.speculate_k:
            self._deliver_spec(emitted, emitted_active, occupied, num_steps)
        elif scanned:
            useful = int(emitted_active[:, occupied].sum())
            self.stats["useful_steps"] += useful
            self.stats["wasted_steps"] += \
                num_steps * len(occupied) - useful
            delivered = 0
            for k in range(num_steps):
                for slot in occupied:
                    if self._slots[slot] is None or \
                            not emitted_active[k, slot]:
                        continue
                    self._deliver(slot, int(emitted[k, slot]), now)
                    delivered += 1
            self.stats["tokens_decode"] += delivered
        if scanned:
            profiler.mark("deliver")
        if scanned or waves_due or self._round_prefill_tokens:
            # working rounds only: idle ticks would drag the estimate
            # toward the timer period, and dilute the phase split
            elapsed = time.perf_counter() - round_start
            self._round_ewma = elapsed if self._round_ewma is None \
                else 0.7 * self._round_ewma + 0.3 * elapsed
            profiler.commit_round()
            if self.sharded and self.pool is not None and \
                    self.active_count == 0 and not self._pending:
                # the ranks give the pool's free tail back at the round
                # that emptied the decoder, which they run alike: idle
                # ticks fall on each rank's own timer
                self.pool.maybe_shrink()
            if self.plan_digests is not None:
                # a test hook, None in service: the caller that sets a
                # list reads and owns it  graft: disable=lint-unbounded-queue
                self.plan_digests.append(
                    self._plan_digest(num_steps if scanned else 0))
        else:
            profiler.abandon_round()
            if self.idle and self.pool is not None and not self.sharded:
                # idle tick: give the pool's free tail back
                self.pool.maybe_shrink()
        if self.idle and self.on_idle is not None:
            self.on_idle()

    def _plan_digest(self, num_steps: int) -> str:
        """A digest of the round's plan as it stands after the round: its
        steps and extent, each slot's request and prefill progress, the
        queue, and (paged) the block tables and the pool's free count."""
        plan = [self.stats["rounds"], num_steps, self._cache_t,
                [None if r is None else (r.request_id, r.prefill_pos,
                                         len(r.generated))
                 for r in self._slots],
                [r.request_id for r in self._pending]]
        digest = hashlib.sha256(repr(plan).encode())
        if self.paged:
            digest.update(self._tables_np.tobytes())
            digest.update(str(self.pool.num_blocks - 1 -
                              self.pool.used_blocks()).encode())
        return digest.hexdigest()[:16]

    def _deliver_spec(self, emitted, emit_mask, occupied,
                      num_steps: int) -> None:
        """Walk a speculative round's [K, S, 1 + k] emissions: a slot's
        masked tokens in (step, position) order are exactly its greedy
        stream.  Settles the speculation counters: a verify step that
        emitted is useful, spec_proposed counts its k drafts and
        spec_accepted the tokens past its first; accepted_per_step is
        the mean tokens an emitting step yielded (1.0: speculation never
        helped)."""
        counts = emit_mask.sum(axis=2)[:, occupied]     # [K, |occupied|]
        verify_steps = int((counts > 0).sum())
        self.stats["useful_steps"] += verify_steps
        self.stats["wasted_steps"] += \
            num_steps * len(occupied) - verify_steps
        self.stats["spec_proposed"] += self.speculate_k * verify_steps
        self.stats["spec_accepted"] += int(np.maximum(counts - 1, 0).sum())
        # tokens_decode counts DELIVERED tokens: a wave-resolved EOS first
        # token can retire a slot before its verify emissions land
        now = time.monotonic()
        delivered = 0
        for slot in occupied:
            mask = emit_mask[:, slot, :]
            if not mask.any():
                continue
            for token in emitted[:, slot, :][mask]:
                if self._slots[slot] is None:
                    break                 # retired mid-burst (EOS)
                self._deliver(slot, int(token), now)
                delivered += 1
        self.stats["tokens_decode"] += delivered
        if self.stats["useful_steps"]:
            self.stats["accepted_per_step"] = (
                self.stats["tokens_decode"] / self.stats["useful_steps"])

    def _deliver(self, slot: int, token: int, now: float) -> None:
        """Append one resolved token and stamp the SLO clocks: tokens land
        in per-sync bursts, so TTFT is submit to the first burst and the
        stall is the worst gap BETWEEN bursts."""
        request = self._slots[slot]
        journey = request.journey
        if not request.generated:
            request.first_time = now
            ttft = now - request.submit_time
            self.ttft_samples.append(ttft)
            self._slo_sketch(
                "ttft", journey.tenant if journey else "",
                request.prefill_label or
                ("cached" if request.prefix_hit else "cold")).observe(
                ttft, exemplar=(journey.trace_id or request.request_id)
                if journey else None)
            if request.dedup_hot and self.prefix_cache is not None:
                # a duplicate waits on this prompt: its rows are written
                # now (the first token resolved), so harvest them early
                try:
                    self._prefix_harvest_prompt(slot, request)
                except Exception:
                    self.logger.exception(
                        "early prompt harvest failed for %s",
                        request.request_id)
        elif now > request.last_time:
            request.max_gap = max(request.max_gap, now - request.last_time)
        if journey is not None:
            journey.token(now)
        request.generated.append(token)
        request.last_time = now
        if self._finished(request, token):
            self._retire(slot)

    def slo_stats(self) -> dict:
        """Measured per-request latency SLOs in milliseconds: TTFT
        (submit to first token burst), per-request mean inter-token
        latency, and the p95 of each request's worst stall between
        bursts."""
        def pct(samples, q):
            return float(np.percentile(np.fromiter(samples, float),
                                       q)) * 1000.0 if samples else None
        return {
            "ttft_p50_ms": pct(self.ttft_samples, 50),
            "ttft_p95_ms": pct(self.ttft_samples, 95),
            "itl_p50_ms": pct(self.itl_samples, 50),
            "itl_p95_ms": pct(self.itl_samples, 95),
            "stall_p95_ms": pct(self.gap_samples, 95),
            "ttft_count": len(self.ttft_samples),
            "itl_count": len(self.itl_samples),
        }

    def slo_sketch_stats(self, prefill: str | None = None,
                         tenant: str | None = None) -> dict:
        """slo_stats' latencies read from the mergeable sketches: p50 /
        p95 / p99 per kind merged across this decoder's tenants, and the
        worst exemplar ids.  `prefill` ("cached" / "cold") restricts the
        TTFT merge to one population; `tenant` restricts both kinds to
        one tenant's sketches."""
        from .observe.sketch import merge_sketches
        out: dict = {}
        for kind in ("ttft", "itl"):
            merged = merge_sketches(
                sketch for (sketch_kind, sketch_tenant, sketch_prefill),
                sketch in self._slo_sketches.items()
                if sketch_kind == kind and
                (tenant is None or sketch_tenant == tenant) and
                (prefill is None or kind != "ttft" or
                 sketch_prefill == prefill))
            for q, suffix in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                value = merged.quantile(q) if merged is not None else None
                out[f"{kind}_{suffix}_ms"] = \
                    None if value is None else value * 1000.0
            out[f"{kind}_exemplars"] = [] if merged is None else \
                [e[1] for e in merged.worst_exemplars(4)]
        return out

    def clear_slo_sketches(self) -> None:
        """Drop sketch observations and exemplars (a warm-up boundary)."""
        for sketch in self._slo_sketches.values():
            sketch.clear()
