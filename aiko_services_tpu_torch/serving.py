# Continuous-batching greedy Llama decoding over a paged KV block pool,
# with the hash-addressed prefix cache.
#
# Counterpart of aiko_services_tpu/serving.py's ContinuousDecoder and
# PrefixKVCache in the mode this port has: paged_kv=True with the paged
# decode-attention kernel (the JAX package's ATTENTION_IMPL=
# "paged_kernel"), a native or int8 pool (kv_cache_dtype), bucketed
# single-shot prefill and chunked prefill (prefill_chunk,
# prefill_budget), greedy decoding and a dense SwiGLU FFN.  A bound
# PrefixKVCache keeps its blocks in the decoder's BlockPool: a hit
# aliases the cached blocks into the slot's table (no K/V rows move),
# only the uncached suffix is prefilled by chunk extends, a write into a
# shared block copies it first (copy-on-extend), and a retiring request's
# blocks become cache entries by refcount.  The scheduling is the JAX
# decoder's: decode-first rounds of up to steps_per_sync steps, admits
# and chunk extends dispatched behind the round's decode steps and
# resolved at the next round's sync, one host sync per round; the
# decoder can pump itself from an event engine (attach), sheds requests
# whose deadline its admit-wait estimate cannot meet, and bills cache
# traffic to tenants.  Every other mode of the JAX decoder raises
# NotImplementedError naming the ROADMAP.md item that brings it.

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .models import layers as L
from .models.llama import LlamaConfig, llama_ffn
from .observe.metrics import MirroredStats, default_registry
from .serving_paged import (BlockPool, _build_paged_step, _paged_admit,
                            _paged_extend)

__all__ = ["ContinuousDecoder", "DecodeRequest", "PrefixKVCache",
           "prefix_chain_keys", "check_block_geometry",
           "measure_device_step"]


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


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
    flat = np.zeros((int(starts[-1]),), np.int32)
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
    _not_ported("measure_device_step", "4")


@dataclasses.dataclass
class DecodeRequest:
    request_id: str
    prompt: list                      # token ids
    max_new_tokens: int
    callback: Callable                # callback(request_id, token_list)
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
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


class _PrefixBlock:
    """One cached block: `pool_id` names its pool block (the cache holds
    one pool ref on it), plus the tree bookkeeping eviction needs
    (parent/children for leaf-first order, refs for pinning)."""

    __slots__ = ("key", "parent", "tenant", "refs", "children", "nbytes",
                 "pool_id")

    def __init__(self, key, parent, tenant, nbytes, pool_id):
        self.key = key
        self.parent = parent
        self.tenant = tenant
        self.refs = 0
        self.children: set = set()
        self.nbytes = int(nbytes)
        self.pool_id = pool_id


class PrefixKVCache:
    """Hash-addressed prefix/KV reuse cache for a paged ContinuousDecoder.

    Prompts are chunked into fixed `block_tokens` blocks, each keyed by
    hash(parent_key, block tokens) (prefix_chain_keys).  Admit does a
    longest-prefix match: a hit aliases the cached pool blocks into the
    slot's table and prefill runs only on the uncached suffix.  Blocks
    are harvested when a request retires (prompt + every generated token
    but the last, whose K/V is never written), so a conversation's next
    turn longest-matches everything it has said.

    Budgets: a global byte cap plus an optional per-tenant cap; over
    budget, eviction walks LRU order and takes leaf blocks only (refs ==
    0 and no children), so a block pinned by a live slot or a session
    handle is never dropped.  Session handles (session_store /
    session_release) pin a (tenant, sid) chain between turns; a
    SessionTable's lease expiry and demotion hooks release them.

    Mirrors prefix_cache_events_total, serving_prefix_{hit,miss}_tokens_
    total{cache, tenant}, prefix_cache_bytes and prefix_cache_blocks into
    the registry, under the JAX package's family names.

    Paged storage only: the dense decoder's row-holding nodes (insert)
    are ROADMAP.md Queue 1 item 4, the host tier and the disaggregated
    install item 5.  Single-threaded like the decoder that owns it;
    decoders of one geometry may share it (and then share its pool)."""

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
        self._pool = None
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
    def bind(self, layout: tuple, paged: bool = False) -> None:
        """Record (and enforce) the storage layout this cache holds:
        decoders sharing a cache must agree on (layers, KV heads, head
        dim, dtype, int8-ness, block size), or a hit would alias blocks
        of the wrong shape into a live slot."""
        if not paged:
            _not_ported("a prefix cache bound by a dense decoder", "4")
        if self._layout is None:
            self._layout = tuple(layout)
        elif self._layout != tuple(layout):
            raise ValueError(
                f"prefix cache {self.name!r} already bound to layout "
                f"{self._layout}, decoder wants {tuple(layout)}")

    @property
    def paged(self) -> bool:
        return self._pool is not None

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
        self._pool = pool

    def attach_ledger(self, ledger) -> None:
        _not_ported("the KV memory ledger", "4")

    def attach_host_store(self, store, promoter=None) -> None:
        _not_ported("the host KV tier (attach_host_store)", "5")

    @property
    def tiered(self) -> bool:
        return False

    def prefetch(self, tenant: str, tokens) -> int:
        _not_ported("the host KV tier (prefetch)", "5")

    def poll_promotions(self) -> int:
        _not_ported("the host KV tier (poll_promotions)", "5")

    def promote_for(self, tenant: str, tokens) -> int:
        _not_ported("the host KV tier (promote_for)", "5")

    def install_chain(self, tenant: str, tokens, start_block: int,
                      blocks) -> int:
        _not_ported("the disaggregated KV install (install_chain)", "5")

    def wire_layout(self) -> tuple:
        _not_ported("the disaggregated KV wire (wire_layout)", "5")

    def insert(self, tenant: str, parent: str, key: str,
               k_rows, v_rows) -> bool:
        _not_ported("dense prefix blocks (insert)", "4")

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
        node = _PrefixBlock(key, parent, tenant, self._pool.block_nbytes,
                            int(pool_id))
        self._nodes[key] = node
        parent_node = self._nodes.get(parent)
        if parent_node is not None:
            parent_node.children.add(key)
        self.bytes_used += node.nbytes
        self._tenant_bytes[tenant] = \
            self._tenant_bytes.get(tenant, 0) + node.nbytes
        self.stats["inserts"] += 1
        self._evict_to_budget(tenant)
        if key not in self._nodes:      # the budget evicted the newcomer
            self.stats["insert_refused"] += 1
            self._publish_gauges()
            return False
        self._publish_gauges()
        return True

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
                return
            self._evict(victim)

    def demote_sessions(self, pairs) -> int:
        """Batch release in SessionTable's on_expired / on_demoted
        callback shape ([(tenant, sid), ...]).  Without a host tier
        (ROADMAP.md Queue 1 item 5) demotion is release_sessions exactly:
        each session's pin drops and its chain stays cached, evictable.
        Returns device blocks demoted (always 0 here)."""
        for tenant, sid in pairs:
            keys = self._sessions.pop(
                (str(tenant or "default"), str(sid)), None)
            if keys is None:
                continue
            self.release(keys)
            self.stats["session_released"] += 1
        return 0

    def _evict(self, node: _PrefixBlock) -> None:
        del self._nodes[node.key]
        # the cache's ref goes; the pool block frees when no slot table
        # still aliases it
        self._pool.release_blocks([node.pool_id], tenant=node.tenant)
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
        cache owned).  `demote` has nothing to demote to without a host
        tier.  Returns nodes evicted."""
        for tenant, sid in list(self._sessions):
            self.session_release(tenant, sid)
        evicted = 0
        progress = True
        while progress:
            progress = False
            for node in list(self._nodes.values()):
                if node.refs or node.children:
                    continue
                self._evict(node)
                evicted += 1
                progress = True
        return evicted


def _project_qkv(layer, config: LlamaConfig, x):
    """q/k/v [B, H, T, D] for the decode step: the three projections."""
    attn = layer["attn"]
    q = L._split_heads(L.linear(attn["q"], x), config.num_heads)
    k = L._split_heads(L.linear(attn["k"], x), config.num_kv_heads)
    v = L._split_heads(L.linear(attn["v"], x), config.num_kv_heads)
    return q, k, v


def _token_block_argmax(params, config: LlamaConfig, token_block,
                        attend):
    """Transformer pass over a [S, W] token block: `attend(i, layer,
    normed)` supplies each layer's attention output (and owns the
    cache-write strategy).  Returns the per-position argmax [S, W]
    int32 of f32 logits from the bf16 head (linear_logits): rounding the
    logits to bf16 first can flip near-ties against an f32 reference.
    torch.argmax, like jnp.argmax, returns the first maximal index."""
    x = L.embedding(params["embed"], token_block).to(config.dtype)
    for i, layer in enumerate(params["layers"]):
        x = x + attend(i, layer, L.rms_norm(layer["ln_attn"], x))
        x = x + llama_ffn(layer, config, L.rms_norm(layer["ln_mlp"], x))
    x = L.rms_norm(params["ln_out"], x)
    logits = L.linear_logits(params["lm_head"], x)
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ContinuousDecoder:
    """Iteration-level scheduler over a fixed slot pool, paged KV.

    submit() enqueues a request; drive it from an event engine (attach)
    or call pump() until idle.  Each round, decode-first: run up to
    steps_per_sync decode steps for every live slot, dispatch prefix-hit
    admits (table edits), bucketed admits and prompt chunks behind them,
    fetch the round's emissions and earlier rounds' admit and extend
    outputs in one host transfer, deliver tokens and retire finished
    slots through their callbacks (harvesting their blocks into the
    prefix cache when one is bound).

    params: the port's Llama (models/llama.py) on `device`; device None
    means the CUDA card, "cpu" runs the kernels' plain versions."""

    def __init__(self, params, config: LlamaConfig, max_slots: int = 8,
                 max_seq: int | None = None, eos_token: int | None = None,
                 prefill_buckets=(32, 128), steps_per_sync: int = 4,
                 t_block: int = 256, prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 weight_quant: bool = False,
                 fuse_projections: bool = False,
                 kv_cache_dtype: str | None = None,
                 speculate_k: int = 0, name: str = "decoder",
                 registry=None, prefix_cache: PrefixKVCache | None = None,
                 paged_kv: bool = False, kv_block: int = 32,
                 device=None):
        if not paged_kv:
            _not_ported("the dense slot cache (paged_kv=False)", "4")
        dtype_norm = (kv_cache_dtype or "native").lower()
        if dtype_norm not in ("native", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be None/'native'/'int8', got "
                f"{kv_cache_dtype!r}")
        # int8 KV: the pool stores int8 values with per-(block, head,
        # position) f32 scales; greedy outputs are not those of the
        # native pool (the stored K/V are rounded), so it is opt-in
        self.kv_int8 = dtype_norm == "int8"
        if speculate_k:
            _not_ported("speculative decoding (speculate_k)", "3")
        if weight_quant or fuse_projections:
            _not_ported("weight_quant and fuse_projections", "4")
        if config.num_experts:
            _not_ported("the mixture-of-experts FFN (num_experts > 0)",
                        "4")
        # a bound prefix cache fixes the block size: its blocks ARE pool
        # blocks
        self.kv_block = int(prefix_cache.block_tokens) \
            if prefix_cache is not None else int(kv_block)
        if self.kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        self.config = config
        self.params = params
        self.device = resolve_device(device)
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
        block = self.kv_block
        # the prefix cache: hash-addressed block sharing across requests
        # and sessions; bind() enforces one layout across the decoders
        # sharing it
        self.prefix_cache = prefix_cache
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        self._kv_layout = (config.num_layers, config.num_kv_heads,
                           config.head_dim, str(config.dtype),
                           self.kv_int8, self.kv_block, itemsize)
        if prefix_cache is not None:
            prefix_cache.bind(self._kv_layout, paged=True)
        # table width covers the worst-case extent _fit_caches can reach
        # (max_seq + the round merge's headroom)
        self._table_blocks = -(-(self.max_seq + steps_per_sync) // block)
        initial = max_slots * (-(-self._cache_t // block))
        if prefix_cache is not None and prefix_cache.paged:
            # a decoder sharing an already-attached cache adopts its pool
            # and reserves its own slot coverage on top of what is
            # resident
            self.pool = prefix_cache.pool
            self.pool.reserve(self.pool.num_blocks - 1 + initial)
        else:
            self.pool = BlockPool(
                config, block, self.kv_int8, initial_blocks=initial,
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
        self._tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=self.device)
        self._lengths = torch.zeros_like(self._tokens)
        self._step = _build_paged_step(config, self.device)
        # in-flight prefix dedup window: leading block key -> the request
        # prefilling that chain now.  Bounded by the slot pool: entries
        # unregister at early harvest or retire
        self._inflight_chains: dict[str, DecodeRequest] = {}
        self._slots: list[DecodeRequest | None] = [None] * max_slots
        self._pending: list[DecodeRequest] = []
        # admit output stash: (firsts device tensor, [(row, request)])
        # per dispatch, resolved at the NEXT round's sync
        self._admit_waves: list = []
        self._timer = None
        self._active_np = np.zeros((max_slots,), bool)
        self._budgets_np = np.zeros((max_slots,), np.int32)
        self._registry = registry or default_registry()
        self.stats = MirroredStats(
            {"steps": 0, "rounds": 0, "completed": 0, "prefills": 0,
             "occupancy_sum": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
             "useful_steps": 0, "wasted_steps": 0, "tokens_decode": 0,
             "tokens_prefill": 0, "prefill_chunks": 0, "chunk_admits": 0,
             "prefix_admits": 0, "round_prefill_tokens_max": 0,
             "admission_shed": 0, "dedup_deferred": 0, "dedup_shared": 0,
             # bytes a hit copied into the slot and harvest copied out
             # (0 here: aliasing and refcounts), and copy-on-extend
             # events (a write into a shared block copies it first)
             "prefix_copy_bytes": 0, "harvest_copy_bytes": 0,
             "cow_copies": 0, "cow_copy_bytes": 0},
            metric="serving_decoder_total",
            help="continuous-decoder events by kind",
            registry=self._registry,
            skip=("occupancy_sum", "prefill_s", "decode_s",
                  "round_prefill_tokens_max", "prefix_copy_bytes",
                  "harvest_copy_bytes", "cow_copy_bytes"))
        # prefill tokens dispatched in the current round (the budget's
        # account)
        self._round_prefill_tokens = 0
        # EWMA of working-round wall seconds (alpha 0.3) and of host
        # dispatch seconds per prefill token: the admit-wait estimate's
        # time base and prompt cost
        self._round_ewma: float | None = None
        self._prefill_token_ewma: float | None = None
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
        cache would hit (a pure probe, no side effects)."""
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
            wait += uncached * self._prefill_token_ewma
        return wait

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

    def submit(self, request_id: str, prompt, max_new_tokens: int,
               callback, deadline: float | None = None,
               tenant: str | None = None,
               prefill_label: str | None = None,
               kv_blocks: tuple | None = None,
               progress_callback=None) -> bool:
        """Enqueue one request; its callback(request_id, tokens) fires
        at retire.  Returns False when deadline-aware admission refused
        it instead (the callback is not invoked): `deadline` is the
        request's end-to-end completion target in time.monotonic
        seconds, and a request whose estimated admit wait already passes
        it is shed.  `tenant` bills the request's prefix-cache traffic
        (default: the tenant of the pipeline's admission note for the
        ambient trace, else "").  Prompts keep their tail up to the
        largest bucket (up to max_seq - 1 with chunked prefill); an
        empty prompt becomes one pad token."""
        if prefill_label is not None or kv_blocks is not None or \
                progress_callback is not None:
            _not_ported("disaggregated prefill (prefill_label, kv_blocks, "
                        "progress_callback)", "5")
        from .observe.journey import take_admission_note
        from .observe.tracing import current_trace
        now = time.monotonic()
        # the request claims the admission note posted for its trace
        context = current_trace()
        note = take_admission_note(context.trace_id) \
            if context is not None else None
        if tenant is None:
            tenant = (note or {}).get("tenant", "")
        if self.prefill_chunk:
            limit = self.max_seq - 1
        else:
            limit = min(self.max_seq - 1, self.prefill_buckets[-1])
        prompt = [int(t) for t in prompt] or [0]
        prompt = prompt[-limit:]
        if deadline is not None:
            wait = self.estimated_admit_wait(prompt=prompt, tenant=tenant)
            if wait is not None and now + wait >= float(deadline):
                self.stats["admission_shed"] += 1
                return False
        self._pending.append(DecodeRequest(
            request_id, prompt, int(max_new_tokens), callback,
            tenant=tenant))
        self._note_active()
        return True

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

    def attach_ledger(self, ledger) -> None:
        _not_ported("the KV memory ledger", "4")

    def drain(self, deadline: float | None = None, on_evacuate=None,
              on_complete=None) -> list:
        _not_ported("graceful drain", "4")

    def resume(self) -> None:
        _not_ported("graceful drain (resume)", "4")

    def slo_stats(self) -> dict:
        _not_ported("request journeys and SLO samples", "4")

    def slo_sketch_stats(self, prefill: str | None = None,
                         tenant: str | None = None) -> dict:
        _not_ported("request journeys and SLO sketches", "4")

    def install_shipped_blocks(self, tokens, start_block: int,
                               blocks, tenant: str = "") -> tuple:
        _not_ported("the direct slot-table install "
                    "(install_shipped_blocks)", "5")

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
        return self.active_count == 0 and not self._pending

    def _note_active(self) -> None:
        self._gauge_active.set(self.active_count + len(self._pending))

    def kv_cache_bytes(self) -> int:
        """Bytes allocated to the KV pool's device arrays plus the int32
        block tables (shared prefixes count once)."""
        return self.pool.nbytes() + int(self._tables_np.nbytes)

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
        tokens), then hand back the device table at the current width."""
        cap = self.max_seq + self.steps_per_sync
        for slot in occupied:
            request = self._slots[slot]
            owed = 0 if request.generated else 1
            current = len(request.prompt) + len(request.generated) + owed
            self._ensure_coverage(slot, min(current + num_steps, cap))
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

    def _fit_caches(self, required_t: int) -> None:
        """Set the attention extent to the t_block multiple covering
        `required_t` (clamped to max_seq plus the merge's steps_per_sync
        headroom).  The pool allocates per block on demand, so only the
        table width read each round (and with it the bytes a step
        streams) tracks the workload: no device copy."""
        cap = self.max_seq + self.steps_per_sync
        self._cache_t = min(cap, -(-required_t // self.t_block) *
                            self.t_block)

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
        than stall the decoding slots."""
        free = [s for s in range(self.max_slots) if self._slots[s] is None]
        if not free or not self._pending:
            return
        cache = self.prefix_cache
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
        if cached:
            self._fit_caches(max(max(self._prefix_write_len(r)
                                     for r in cached), self._cache_t))
            start = time.perf_counter()
            for request in cached:
                self._prefix_admit(free.pop(0), request)
            self.stats["prefill_s"] += time.perf_counter() - start
        for request in chunked:
            slot = free.pop(0)
            request.slot = slot
            request.prefilling = True
            request.prefill_pos = 0
            self._slots[slot] = request
            self.stats["chunk_admits"] += 1
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
        """A hit's chain tokens padded up to a pow2 block count, capped
        at max_seq (the JAX decoder's copy-in extent; here it only sets
        the admit round's attention extent, as it does there)."""
        blocks = request.prefix_hit // self.kv_block
        padded = self._next_pow2(blocks) * self.kv_block
        return padded if padded <= self.max_seq else request.prefix_hit

    def _prefix_admit(self, slot: int, request: DecodeRequest) -> None:
        """Admit a prefix-hit request: alias the pinned chain's pool
        blocks into the slot's table (one pool ref per block for the
        slot; a host-side edit, no K/V rows move) and leave the slot
        mid-prefill at the hit boundary: _advance_prefills runs the
        uncached suffix, and its finishing extend gives the first
        token."""
        count = request.prefix_hit // self.kv_block
        chain = self.prefix_cache.nodes(request.prefix_nodes)
        ids = [node.pool_id for node in chain[:count]]
        self.pool.retain(ids)
        row = self._tables_np[slot]
        for j, block_id in enumerate(ids):
            row[j] = block_id
        self._slot_blocks[slot] = list(ids)
        self._tables_dirty = True
        request.slot = slot
        request.prefilling = True
        request.prefill_pos = request.prefix_hit
        self._slots[slot] = request
        self.stats["prefix_admits"] += 1

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
        """Zero-copy harvest: the slot's own pool blocks become the cache
        entries (retain + key), no rows move."""
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
        owned = self._slot_blocks[slot]
        parent = keys[start - 1] if start else ""
        for j in range(start, min(count, len(owned))):
            if not cache.insert_block(tenant, parent, keys[j], owned[j]):
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
        prompts = np.zeros((width, bucket), np.int32)
        true_lens = np.zeros((width,), np.int32)
        valid = np.zeros((width,), bool)
        for j, request in enumerate(chunk):
            prompts[j, :len(request.prompt)] = request.prompt
            true_lens[j] = len(request.prompt)
            valid[j] = True
        # each admitted slot gets fresh pool blocks padded to the block
        # boundary; pad rows stay all-null and their writes drop
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
        firsts = _paged_admit(
            self.params, self.config, self.pool.k_pools, self.pool.v_pools,
            self._tokens, self._lengths,
            *_to_device(self.device, prompts, true_lens, slots + pad_slots,
                        valid, tables_rows))
        # no host sync here: the request is live with its first token
        # owed; the stashed wave resolves it at the NEXT round's sync
        wave = []
        for j, request in enumerate(chunk):
            request.slot = slots[j]
            request.generated = []
            self._slots[slots[j]] = request
            self.stats["prefills"] += 1
            self.stats["tokens_prefill"] += len(request.prompt)
            wave.append((j, request))
        self._admit_waves.append((firsts, wave))

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
        finish)] at `width` rows (pad rows on distinct spare slots, null
        tables, offset 0).  A shared block under the chunk's writes is
        copied to a fresh one first, queued on the stream before the
        extend.  Rows that finish their prompt owe their first token,
        resolved from the stashed wave at the next round's sync."""
        n = len(batch)
        slots = [slot for slot, *_ in batch]
        used = set(slots)
        pad_slots = [s for s in range(self.max_slots)
                     if s not in used][:width - n]
        chunk_tokens = np.zeros((width, chunk), np.int32)
        offsets = np.zeros((width,), np.int32)
        final_idx = np.zeros((width,), np.int32)
        valid = np.zeros((width,), bool)
        finish_rows = np.zeros((width,), bool)
        for j, (slot, request, offset, finish) in enumerate(batch):
            piece = request.prompt[offset:offset + chunk]
            chunk_tokens[j, :len(piece)] = piece
            offsets[j] = offset
            final_idx[j] = len(request.prompt) - 1 - offset if finish \
                else 0
            valid[j] = True
            finish_rows[j] = finish
        # copy-on-extend: the chunk writes positions [offset, offset +
        # chunk); any shared block there moves to a fresh block first
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
        for j, slot in enumerate(slots):
            tables_rows[j] = self._tables_np[slot, :nbt]
        tables_rows[n:] = 0                       # pad rows stay null
        firsts = _paged_extend(
            self.params, self.config, self.pool.k_pools, self.pool.v_pools,
            self._tokens, self._lengths,
            *_to_device(self.device, chunk_tokens, offsets,
                        slots + pad_slots, valid, finish_rows, final_idx,
                        tables_rows), t_cap=self._cache_t)
        wave = []
        for j, (slot, request, offset, finish) in enumerate(batch):
            new_pos = len(request.prompt) if finish else offset + chunk
            self.stats["tokens_prefill"] += max(0,
                                                new_pos - request.prefill_pos)
            request.prefill_pos = new_pos
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
        # after the harvest retained what it keeps: cache-held blocks
        # live on, purely owned ones return to the free list
        self._release_slot_blocks(slot)
        self._slots[slot] = None
        self._note_active()
        self.stats["completed"] += 1
        generated = request.generated
        if self.eos_token is not None and generated and \
                generated[-1] == self.eos_token:
            generated = generated[:-1]
        try:
            request.callback(request.request_id, generated)
        except Exception:
            self.logger.exception("callback failed for %s",
                                  request.request_id)

    def _round_plan(self, occupied) -> tuple:
        """(num_steps, required_t, budgets): how long to run before the
        next host sync, the attention extent this round needs, and how
        many tokens each slot may still emit.  num_steps is
        retire-aligned (with requests waiting, the round ends near the
        earliest retirement so the freed slot refills) and pow2-ceiled;
        the in-loop budget mask absorbs the overshoot."""
        budgets = self._budgets_np
        budgets.fill(0)
        max_len = 0
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
                        self._next_pow2(max(1, cap)))
        return num_steps, max_len + num_steps + 1, budgets

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
            done.synchronize()
        flat = host.numpy()
        return np.split(flat, np.cumsum(sizes)[:-1])

    @torch.no_grad()
    def pump(self) -> None:
        """One scheduling round, decode-first: run the decode steps,
        start the host copy of their emissions (and of earlier rounds'
        admit and extend outputs), THEN dispatch admits and chunk
        extends so they run on the device while the host waits; resolve
        earlier admits' first tokens, deliver this round's emissions,
        retire finished slots."""
        self._round_prefill_tokens = 0
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
        fetch = [firsts for firsts, _ in waves_due]
        if scanned:
            self.stats["rounds"] += 1
            self.stats["occupancy_sum"] += float(active.mean())
            decode_start = time.perf_counter()
            eos = -1 if self.eos_token is None else int(self.eos_token)
            # every scanned slot's table must own the blocks this round's
            # merge writes; then the device tables refresh if dirty
            tables = self._prepare_round_tables(occupied, num_steps)
            emitted, emitted_active, self._tokens, self._lengths = \
                self._step(self.params, self._tokens, self._lengths,
                           *_to_device(self.device, scan_active, budgets),
                           self.pool.k_pools, self.pool.v_pools, tables,
                           num_steps=num_steps, eos=eos,
                           t_cap=self._cache_t)
            self.stats["steps"] += num_steps
            fetch = [emitted, emitted_active] + fetch
        transfer = self._start_fetch(fetch) if fetch else None
        self._admit_pending()
        self._advance_prefills()
        self.stats["round_prefill_tokens_max"] = max(
            self.stats["round_prefill_tokens_max"],
            self._round_prefill_tokens)
        host = self._finish_fetch(transfer) if transfer else []
        if scanned:
            emitted = host[0].reshape(num_steps, self.max_slots)
            emitted_active = host[1].reshape(num_steps,
                                             self.max_slots).astype(bool)
            host = host[2:]
            self.stats["decode_s"] += time.perf_counter() - decode_start
        # first tokens of admits from EARLIER rounds
        for firsts, (_, wave) in zip(host, waves_due):
            for j, request in wave:
                if self._slots[request.slot] is request and \
                        not request.generated:
                    self._deliver(request.slot, int(firsts[j]))
        if scanned:
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
                    self._deliver(slot, int(emitted[k, slot]))
                    delivered += 1
            self.stats["tokens_decode"] += delivered
        if scanned or waves_due or self._round_prefill_tokens:
            # working rounds only: idle ticks would drag the estimate
            # toward the timer period
            elapsed = time.perf_counter() - round_start
            self._round_ewma = elapsed if self._round_ewma is None \
                else 0.7 * self._round_ewma + 0.3 * elapsed
        elif self.idle:
            # idle tick: give the pool's free tail back
            self.pool.maybe_shrink()
        if self.idle and self.on_idle is not None:
            self.on_idle()

    def _deliver(self, slot: int, token: int) -> None:
        request = self._slots[slot]
        if not request.generated and request.dedup_hot and \
                self.prefix_cache is not None:
            # a duplicate waits on this prompt: its rows are written now
            # (the first token resolved), so harvest them early
            try:
                self._prefix_harvest_prompt(slot, request)
            except Exception:
                self.logger.exception("early prompt harvest failed for %s",
                                      request.request_id)
        request.generated.append(token)
        if self._finished(request, token):
            self._retire(slot)
