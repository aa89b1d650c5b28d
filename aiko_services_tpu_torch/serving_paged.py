# Paged KV block pool and the paged programs of ContinuousDecoder.
#
# Counterpart of aiko_services_tpu/serving_paged.py, the part the paged
# kernel path runs: the BlockPool allocator (native or int8 pools, shared
# by a prefix cache: refcounts, block copies and installs), the kernel
# attention of the decode step and of the speculative verify (the same
# kernel at W = 1 + speculate_k rows a slot), the round-end side-buffer
# merge, the bucketed admit, and the chunked-prefill extend.  The gather oracle
# (_gather_views with the shared slot attention) is not ported: on the
# card the kernel is the only paged path, and on the CPU its plain
# version plays the oracle's part.
#
# From JAX to PyTorch: the JAX programs are functional and jitted; here
# they run eagerly and update the pools, the side buffers and the token
# and length vectors IN PLACE.  The decode loop runs `num_steps` steps
# with no host sync inside (every stop condition stays on the device);
# JAX's dropped scatter indices are written out as explicit masks
# (models/layers.py).

from __future__ import annotations

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device
from .models import layers as L
from .models.llama import LlamaConfig, llama_ffn
from .observe.metrics import MirroredStats, default_registry

__all__ = ["BlockPool"]


class BlockPool:
    """Device-resident paged KV block pool + host-side refcounting
    allocator.

    One pool id addresses one `block_tokens`-token block across the
    whole model: k_pools[i][id] / v_pools[i][id] are layer i's K/V rows
    for that block ([H, B, D]).  With kv_int8 each layer's pool is the
    int8 serving form {"q": int8 [N, H, B, D], "s": f32 [N, H, B]}
    (layers.quantize_kv_cache), indexed plane by plane.  Block 0 is the
    reserved null block (all zeros, never allocated): unfilled table
    entries point at it, so reads stay in bounds and see only masked
    positions.

    Refcounts count logical owners: slot tables, prefix-cache nodes (a
    cached block holds one ref) and, through the cache, session pins.
    alloc_blocks() hands out refs=1 ids, growing the device arrays
    geometrically when the free list runs dry; retain()/release_blocks()
    move ownership; refs hitting zero return the id to the free list with
    its contents left in place (stale rows are only ever read at masked
    positions until the next owner overwrites them).  With a KV memory
    ledger attached (attach_ledger, observe/ledger.py) every physical
    transition reports a tenant-attributed byte delta: alloc, and the
    refs 1->0 release; retains are ownership moves and stay invisible,
    so the ledger's device bytes equal used_blocks() * block_nbytes.
    `tenant` on alloc / release is that attribution only.
    Single-threaded like the decoder that owns it."""

    def __init__(self, config: LlamaConfig, block_tokens: int,
                 kv_int8: bool, initial_blocks: int = 64,
                 grow_blocks: int = 64, name: str = "pool",
                 registry=None, device=None):
        self.config = config
        self.kv_int8 = bool(kv_int8)
        self.block_tokens = int(block_tokens)
        if self.block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}")
        self.device = resolve_device(device)
        self.name = str(name)
        self.grow_blocks = max(1, int(grow_blocks))
        self.logger = logging.getLogger(f"serving.pool.{name}")
        n = max(2, int(initial_blocks) + 1)          # +1: null block
        self.num_blocks = n
        self.k_pools = self._zero_pools(n)
        self.v_pools = self._zero_pools(n)
        self._refs = np.zeros((n,), np.int32)
        self._free = list(range(n - 1, 0, -1))       # 0 reserved
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        per_position = (config.head_dim + 4) if self.kv_int8 \
            else config.head_dim * itemsize
        # K + V, all layers, one block's tokens: the budget currency
        self.block_nbytes = (2 * config.num_layers * config.num_kv_heads *
                             per_position * self.block_tokens)
        self._registry = registry or default_registry()
        self.stats = MirroredStats(
            {"allocs": 0, "frees": 0, "grows": 0, "shrinks": 0,
             "cow_copies": 0, "cow_copy_bytes": 0,
             "install_blocks": 0, "install_bytes": 0},
            metric="kv_pool_events_total",
            help="paged KV block-pool events by kind",
            registry=self._registry,
            skip=("cow_copy_bytes", "install_bytes"),
            labels={"pool": self.name})
        self._gauge_total = self._registry.gauge(
            "kv_pool_blocks", "paged KV pool capacity in blocks",
            labels={"pool": self.name})
        self._gauge_used = self._registry.gauge(
            "kv_pool_blocks_used",
            "paged KV pool blocks with at least one owner",
            labels={"pool": self.name})
        self._gauge_occupancy = self._registry.gauge(
            "kv_pool_occupancy",
            "used / capacity fraction of the paged KV pool",
            labels={"pool": self.name})
        self._used = 0
        self._ledger = None              # KV memory ledger (attach_ledger)
        # shrink floor: construction capacity, raised by reserve() —
        # maybe_shrink never goes below what a caller declared as steady
        # state, so drain/refill cycles do not thrash the pool
        self._floor_blocks = n
        self._publish_gauges()

    def attach_ledger(self, ledger) -> None:
        self._ledger = ledger
        if ledger is not None:
            ledger.attach_pool(self)

    # -- device arrays -----------------------------------------------------
    def _zero_pools(self, n: int) -> list:
        config = self.config
        shape = (n, config.num_kv_heads, self.block_tokens,
                 config.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.kv_int8:
            return [{"q": zeros(shape, torch.int8),
                     "s": zeros(shape[:3], torch.float32)}
                    for _ in range(config.num_layers)]
        return [zeros(shape, config.dtype)
                for _ in range(config.num_layers)]

    @staticmethod
    def _map_leaves(pools, fn) -> list:
        """fn applied to every plane of every layer's leaf, the int8 dict
        form kept."""
        return [{key: fn(plane) for key, plane in pool.items()}
                if isinstance(pool, dict) else fn(pool) for pool in pools]

    def nbytes(self) -> int:
        """Bytes allocated to the pool device arrays."""
        return sum(plane.numel() * plane.element_size()
                   for pools in (self.k_pools, self.v_pools)
                   for pool in pools
                   for plane in (pool.values() if isinstance(pool, dict)
                                 else (pool,)))

    def _grow(self, need: int) -> None:
        # geometric growth (at least doubling): every growth copies the
        # whole pool once, so the copies stay O(log blocks)
        extra = -(-max(need, 1) // self.grow_blocks) * self.grow_blocks
        extra = max(extra, self.num_blocks - 1)
        old_n, new_n = self.num_blocks, self.num_blocks + extra

        def grow(plane):
            return torch.cat([plane, plane.new_zeros((extra,
                                                      *plane.shape[1:]))])

        self.k_pools = self._map_leaves(self.k_pools, grow)
        self.v_pools = self._map_leaves(self.v_pools, grow)
        self._free.extend(range(new_n - 1, old_n - 1, -1))
        # geometric growth is amortized O(log blocks) and reserve()
        # pre-warms steady state out of the serving window entirely
        self._refs = np.concatenate(  # graft: disable=lint-hot-alloc
            [self._refs, np.zeros((extra,), np.int32)])
        self.num_blocks = new_n
        self.stats["grows"] += 1
        self._publish_gauges()

    def reserve(self, capacity: int) -> None:
        """Grow the pool to at least `capacity` allocatable blocks now
        (no allocation), and keep maybe_shrink from going below it."""
        self._floor_blocks = max(self._floor_blocks,
                                 int(capacity) + 1)
        short = int(capacity) - (self.num_blocks - 1)
        if short > 0:
            self._grow(short)

    def maybe_shrink(self, watermark: float = 0.25) -> int:
        """Idle-watermark release: when occupancy has fallen to
        `watermark` or below, give the pool's free tail back to the
        device allocator.  Returns blocks released (0 when the watermark,
        the floor, or the geometric hysteresis says no).  Only the tail
        can go (block ids are array positions); the release is at least
        halving, mirroring _grow, and never cuts below the
        reserve()/construction floor.  The decoder calls it on idle
        ticks only."""
        capacity = self.num_blocks - 1
        if capacity <= 0 or self._used > watermark * capacity:
            return 0
        keep = max(self._floor_blocks,
                   self.num_blocks - self.tail_free_blocks())
        released = self.num_blocks - keep
        if released * 2 < self.num_blocks:
            return 0
        # clone: a slice would keep the whole old storage alive
        self.k_pools = self._map_leaves(self.k_pools,
                                        lambda plane: plane[:keep].clone())
        self.v_pools = self._map_leaves(self.v_pools,
                                        lambda plane: plane[:keep].clone())
        self._free = [i for i in self._free if i < keep]
        self._refs = self._refs[:keep]
        self.num_blocks = keep
        self.stats["shrinks"] += 1
        self._publish_gauges()
        self.logger.info("pool %s shrank by %d blocks to %d",
                         self.name, released, keep - 1)
        return released

    # -- allocator ---------------------------------------------------------
    def alloc_blocks(self, count: int, tenant: str = "") -> list:
        """`count` fresh block ids, each with refs=1 owned by the
        caller.  Grows the device pools when the free list runs dry."""
        count = int(count)
        if count <= 0:
            return []
        if len(self._free) < count:
            self._grow(count - len(self._free))
        ids = [self._free.pop() for _ in range(count)]
        for block_id in ids:
            self._refs[block_id] = 1
        self._used += count
        self.stats["allocs"] += count
        if self._ledger is not None:
            self._ledger.device_delta(tenant, count * self.block_nbytes,
                                      "alloc")
        self._publish_gauges()
        return ids

    def retain(self, ids) -> None:
        for block_id in ids:
            if not 0 < block_id < self.num_blocks or \
                    self._refs[block_id] <= 0:
                raise ValueError(
                    f"pool {self.name!r}: retain of dead block "
                    f"{block_id}")
            self._refs[block_id] += 1

    def release_blocks(self, ids, tenant: str = "") -> None:
        """Drop one ref per id; refs hitting zero return the id to the
        free list (contents stay: dead cells until reallocated)."""
        freed = 0
        for block_id in ids:
            if not 0 < block_id < self.num_blocks:
                continue
            refs = self._refs[block_id]
            if refs <= 0:
                raise ValueError(
                    f"pool {self.name!r}: release of free block "
                    f"{block_id}")
            self._refs[block_id] = refs - 1
            if refs == 1:
                self._free.append(block_id)
                freed += 1
        if freed:
            self._used -= freed
            self.stats["frees"] += freed
            if self._ledger is not None:
                self._ledger.device_delta(
                    tenant, -freed * self.block_nbytes, "release")
            self._publish_gauges()

    def refs(self, block_id: int) -> int:
        return int(self._refs[block_id])

    def used_blocks(self) -> int:
        """Blocks with at least one live owner (null block excluded).
        The refs scan is the audit surface (leak checks); the gauges
        publish the incremental `_used` twin, which alloc (every 0->1)
        and release (every 1->0) keep exact."""
        return int((self._refs[1:] > 0).sum())

    def occupancy(self) -> float:
        capacity = self.num_blocks - 1
        return self.used_blocks() / capacity if capacity else 0.0

    def tail_free_blocks(self) -> int:
        """Length of the pool's free tail: the only span maybe_shrink
        can release (interior frees fragment until their tail neighbours
        drain too)."""
        keep = self.num_blocks
        while keep > 1 and self._refs[keep - 1] == 0:
            keep -= 1
        return self.num_blocks - keep

    def _publish_gauges(self) -> None:
        capacity = self.num_blocks - 1
        self._gauge_total.set(capacity)
        self._gauge_used.set(self._used)
        self._gauge_occupancy.set(
            self._used / capacity if capacity else 0.0)

    # -- block content movement --------------------------------------------
    def _ids(self, ids) -> torch.Tensor:
        """Block ids as an int64 index on the pool's device, sent in one
        non-blocking copy (no stream sync)."""
        from .serving import _to_device
        index, = _to_device(self.device, np.asarray(list(ids), np.int32))
        return index.long()

    def copy_blocks(self, src_ids, dst_ids) -> int:
        """Device-copy block contents src -> dst (copy-on-extend): one
        batched index copy per layer and plane, queued on the stream.
        Returns the bytes copied."""
        if not src_ids:
            return 0
        src, dst = self._ids(src_ids), self._ids(dst_ids)

        def copy(plane):
            plane.index_copy_(0, dst, plane.index_select(0, src))
            return plane

        self._map_leaves(self.k_pools, copy)
        self._map_leaves(self.v_pools, copy)
        copied = len(src_ids) * self.block_nbytes
        self.stats["cow_copies"] += len(src_ids)
        self.stats["cow_copy_bytes"] += copied
        return copied

    def write_blocks(self, ids, k_layers, v_layers) -> None:
        """Install block rows into pool blocks: `k_layers` / `v_layers`
        are per-layer stacks covering len(ids) blocks ([M, H, B, D]
        arrays or {"q" [M, H, B, D], "s" [M, H, B]} dicts, numpy or
        torch), written as one index copy per layer and plane."""
        if not ids:
            return
        dst = self._ids(ids)

        def write(pool, rows):
            if isinstance(pool, dict):
                for key in ("q", "s"):
                    pool[key].index_copy_(0, dst, _as_rows(rows[key],
                                                           pool[key]))
            else:
                pool.index_copy_(0, dst, _as_rows(rows, pool))

        for pools, layers in ((self.k_pools, k_layers),
                              (self.v_pools, v_layers)):
            for pool, rows in zip(pools, layers):
                write(pool, rows)
        self.stats["install_blocks"] += len(ids)
        self.stats["install_bytes"] += len(ids) * self.block_nbytes

    def block_rows(self, block_id: int) -> tuple:
        """(per-layer K leaves, per-layer V leaves) of one block: views
        into the pool in its storage layout (the read behind shipping a
        cached block, serving_disagg.py)."""
        return ([L.slice_paged_block(pool, block_id)
                 for pool in self.k_pools],
                [L.slice_paged_block(pool, block_id)
                 for pool in self.v_pools])


def _as_rows(rows, plane: torch.Tensor) -> torch.Tensor:
    """Host or device rows in `plane`'s dtype on its device."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(device=plane.device, dtype=plane.dtype)


# -- the decode step: paged kernel attention --------------------------------

def _pool_dims(pool) -> tuple:
    """(blocks, tokens per block) of one layer's pool leaf."""
    values, _ = L.paged_pool_planes(pool)
    return values.shape[0], values.shape[2]


def _table_cap(tables, block_tokens: int, t_cap: int):
    """Slice a round table to the blocks covering t_cap (a column view;
    the kernel masks positions against entry_lengths itself)."""
    return tables[:, :-(-t_cap // block_tokens)]


def _grouped_queries(q, num_kv: int):
    """[S, H, W, D] queries → [S, Hkv, G*W, D], the kernel's GQA rows
    (G-major: row g*W + w of KV head h is query head h*G + g)."""
    slots_n, num_heads, num_q, head_dim = q.shape
    return q.reshape(slots_n, num_kv, num_heads // num_kv * num_q,
                     head_dim)


def _kernel_grouped_attention(layer, config: LlamaConfig, x, cos, sin,
                              k_pool, v_pool, tables, k_side, v_side,
                              entry_lengths, lengths, write_index,
                              side_valid, mesh=None):
    """Project QKV for the [S, W] block at per-slot positions `lengths`,
    write this block's K/V into the side buffers at `write_index` (in
    place), and attend through the paged kernel over the pool (positions
    < entry_lengths) plus the side entries `side_valid` [S, W, P]
    selects; int8 pools fold their scales (fold_scales=True).  Returns
    the attention output projection (row-parallel over the model axis of
    `mesh`: the config's heads are this rank's)."""
    from .ops.paged_attention import \
        _paged_decode_attention as paged_decode_attention
    from .serving import _project_qkv
    num_heads, num_kv = config.num_heads, config.num_kv_heads
    q, k, v = _project_qkv(layer, config, x)
    q = L.apply_rope(q, cos, sin, lengths)
    k = L.apply_rope(k, cos, sin, lengths)
    k_side[:, :, write_index:write_index + k.shape[2]] = k
    v_side[:, :, write_index:write_index + v.shape[2]] = v
    slots_n, num_q, head_dim = q.shape[0], q.shape[2], q.shape[3]
    out = paged_decode_attention(_grouped_queries(q, num_kv), k_pool,
                                 v_pool, tables, k_side, v_side, side_valid,
                                 entry_lengths, groups=num_heads // num_kv)
    out = out.reshape(slots_n, num_heads, num_q, head_dim).to(x.dtype)
    return L.row_parallel_linear(layer["attn"]["o"], L._merge_heads(out),
                                 mesh)


def _kernel_attention_block(tables, layer, config: LlamaConfig, x, cos,
                            sin, k_pool, v_pool, k_side, v_side,
                            entry_lengths, lengths, step_index: int,
                            mesh=None):
    """Decode attention at scan step `step_index`: the side entries
    written this round up to this step, and none past the slot's own
    take (a slot that stopped keeps its stale side rows masked)."""
    side_positions = torch.arange(k_side.shape[2], device=x.device)
    side_valid = ((side_positions[None] <= step_index) &
                  (side_positions[None] <
                   (lengths - entry_lengths + 1)[:, None]))[:, None, :]
    return _kernel_grouped_attention(layer, config, x, cos, sin,
                                     k_pool, v_pool, tables, k_side,
                                     v_side, entry_lengths, lengths,
                                     step_index, side_valid, mesh)


def _kernel_attention_spec(tables, layer, config: LlamaConfig, x, cos,
                           sin, k_pool, v_pool, k_side, v_side, pos_side,
                           entry_lengths, lengths, base: int, mesh=None):
    """The speculative verify through the paged kernel: the same kernel
    at W = 1 + speculate_k query rows a slot, under the causal mask
    pos_side <= q_pos ([S, W, P]).  Its signature is
    serving._slot_attention_spec's after the leading `tables`, the
    seam serving._spec_scan_body takes it through."""
    width = x.shape[1]
    q_pos = lengths[:, None] + torch.arange(width, device=x.device)[None]
    side_valid = pos_side[:, None, :] <= q_pos[:, :, None]      # [S, W, P]
    return _kernel_grouped_attention(layer, config, x, cos, sin, k_pool,
                                     v_pool, tables, k_side, v_side,
                                     entry_lengths, lengths, base,
                                     side_valid, mesh)


def _store_rows(pool, rows):
    """Rows [S, H, W, D] in the pool's form: quantized once
    (layers.quantize_kv_cache) for an int8 pool, as they are for a
    native one."""
    return L.quantize_kv_cache(rows) if isinstance(pool, dict) else rows


def _paged_scatter(pools, tables, positions, live, sides,
                   block_tokens: int) -> None:
    """Scatter side-buffer rows into pool blocks at absolute `positions`
    [S, W], in place; rows where `live` is False, or whose block lies
    past the table, drop.  int8 pools quantize the side rows once, here
    at the round merge."""
    nb = tables.shape[1]
    num_total, _ = _pool_dims(pools[0])
    blocks = positions // block_tokens
    offsets = positions % block_tokens
    dest = torch.gather(tables, 1, blocks.clamp(0, nb - 1).long())
    dest = torch.where(live & (blocks >= 0) & (blocks < nb), dest,
                       num_total)
    for pool, side in zip(pools, sides):
        L.scatter_paged_rows(pool, dest, offsets, _store_rows(pool, side))


def _build_paged_step(config: LlamaConfig, device, mesh=None):
    """The paged decode round: `num_steps` greedy steps for every slot
    over the pool (read-only through the round) plus per-layer side
    buffers, then one merge of the side rows into the slots' blocks.
    Returns step(params, tokens, lengths, active, budgets, k_pools,
    v_pools, tables, *, num_steps, eos, t_cap) → (emitted [K, S],
    emitted_active [K, S], tokens, lengths); the pools update in
    place."""
    from .serving import _decode_steps, _side_buffers
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)

    def step(params, tokens, lengths, active, budgets, k_pools, v_pools,
             tables, *, num_steps: int, eos: int, t_cap: int):
        _, block_tokens = _pool_dims(k_pools[0])
        cap_tables = _table_cap(tables, block_tokens, t_cap)
        entry_lengths, entry_active = lengths, active
        k_sides, v_sides = _side_buffers(config, tokens.shape[0], num_steps,
                                         device)

        def attention(i, layer, normed, lengths, step_index, _active):
            return _kernel_attention_block(
                cap_tables, layer, config, normed, cos, sin, k_pools[i],
                v_pools[i], k_sides[i], v_sides[i], entry_lengths, lengths,
                step_index, mesh)

        emitted, emitted_active, tokens, lengths = _decode_steps(
            params, config, tokens, lengths, active, budgets, eos,
            num_steps, attention, mesh)
        # merge: each slot's side rows land at their absolute positions
        # [entry_length, entry_length + num_steps); rows past a slot's
        # actual take are dead cells in blocks it owns.  Slots inactive
        # at round entry drop entirely.
        positions = entry_lengths[:, None] + torch.arange(
            num_steps, device=device, dtype=torch.int32)[None]
        live = entry_active[:, None].expand(-1, num_steps)
        _paged_scatter(k_pools, tables, positions, live, k_sides,
                       block_tokens)
        _paged_scatter(v_pools, tables, positions, live, v_sides,
                       block_tokens)
        return emitted, emitted_active, tokens, lengths

    return step


def _build_paged_spec_step(config: LlamaConfig, k_spec: int, ngram: int,
                           device, mesh=None):
    """The paged speculative round: the drafting / widened verify /
    acceptance loop is serving._spec_round over _spec_scan_body, the one
    copy the dense builder shares, with its attention seam on the paged kernel
    (_kernel_attention_spec over the pool leaves and the round table);
    the round's consumed side entries then scatter to their (block,
    offset) pairs, rejected drafts dropping through their _POS_INVALID
    positions.  Returns spec_step(params, tokens, lengths, active,
    budgets, context, k_pools, v_pools, tables, *, num_steps, eos,
    t_cap) → (emitted [K, S, W], emit_mask [K, S, W], tokens, lengths);
    the context buffer and the pools update in place."""
    from .serving import _POS_INVALID, _spec_round, _spec_rope
    cos, sin = _spec_rope(config, k_spec, device)

    def spec_step(params, tokens, lengths, active, budgets, context,
                  k_pools, v_pools, tables, *, num_steps: int, eos: int,
                  t_cap: int):
        _, block_tokens = _pool_dims(k_pools[0])
        attention = functools.partial(
            _kernel_attention_spec, _table_cap(tables, block_tokens, t_cap))
        emitted, emit_mask, tokens, lengths, k_sides, v_sides, pos_side = \
            _spec_round(config, cos, sin, k_spec, ngram, params, tokens,
                        lengths, active, budgets, context, k_pools,
                        v_pools, num_steps=num_steps, eos=eos,
                        attention=attention, mesh=mesh)
        live = pos_side < _POS_INVALID
        _paged_scatter(k_pools, tables, pos_side, live, k_sides,
                       block_tokens)
        _paged_scatter(v_pools, tables, pos_side, live, v_sides,
                       block_tokens)
        return emitted, emit_mask, tokens, lengths

    return spec_step


def _paged_admit(params, config: LlamaConfig, k_pools, v_pools, tokens,
                 lengths, context, prompts, true_lens, slots, valid,
                 tables_rows, mesh=None):
    """Bucketed single-shot prefill of `width` prompts [width, bucket]:
    each valid row's K/V prefix lands in the pool blocks its table row
    names (padded with dead cells to the block boundary; quantized for
    an int8 pool), its first token and length in `tokens` / `lengths` at
    its slot, and with speculation (`context` not None) its prompt in
    the drafter's context row (all in place).  Pad rows (valid False)
    carry out-of-range ids, so their writes drop, and rewrite their own
    distinct slot's token and length.  Returns the first tokens [width]
    int32."""
    from .models.llama import init_llama_caches, llama_hidden
    from .serving import _admit_context
    num_total, block_tokens = _pool_dims(k_pools[0])
    width, bucket = prompts.shape
    caches = init_llama_caches(config, width, bucket,
                               device=prompts.device)
    hidden, caches = llama_hidden(params, config, prompts, caches,
                                  mesh=mesh)
    idx = (true_lens - 1).clamp(min=0).long()
    last_hidden = hidden[torch.arange(width, device=prompts.device), idx]
    firsts = L.greedy_tokens(params["lm_head"], last_hidden, mesh)
    pad = tables_rows.shape[1] * block_tokens - bucket
    dest = torch.where(valid[:, None], tables_rows, num_total)
    for i, cache in enumerate(caches):
        for pools, rows in ((k_pools, cache["k"]), (v_pools, cache["v"])):
            if pad:
                rows = F.pad(rows, (0, 0, 0, pad))
            L.write_paged_blocks(pools[i], dest, _store_rows(pools[i], rows))
    slots = slots.long()
    tokens[slots] = torch.where(valid, firsts, tokens[slots])
    lengths[slots] = torch.where(valid, true_lens, lengths[slots])
    if context is not None:
        _admit_context(context, slots, prompts, valid)
    return firsts


def _paged_extend(params, config: LlamaConfig, k_pools, v_pools, tokens,
                  lengths, context, chunk_tokens, offsets, slots, valid,
                  finish, final_idx, tables_rows, *, t_cap: int,
                  mesh=None):
    """One prompt chunk [width, chunk] for mid-prefill slots (the kernel
    path of JAX's _paged_extend_fn_for): row a's tokens sit at absolute
    positions offsets[a] + [0, chunk).  Each layer attends the pool's
    positions < offsets[a] through the paged kernel with the chunk's own
    K/V, in the compute dtype and not yet stored, as the side buffer
    under a causal triangle mask; int8 pools dequantize inside the
    kernel (fold_scales=False), as the JAX extend dequantizes before its
    dots.  Then the chunk's K/V (quantized for an int8 pool) land at
    their (block, offset) pairs, in place.  Rows with `finish` set take
    their first token from position final_idx and set their slot's token
    and length; with speculation (`context` not None) the chunk's tokens
    land in the drafter's context rows at their offsets.  Pad rows (valid
    False: null table rows, offset 0) drop every write.  Returns the
    first tokens [width] int32."""
    from .ops.paged_attention import \
        _paged_decode_attention as paged_decode_attention
    from .serving import _extend_context, _project_qkv
    num_total, block_tokens = _pool_dims(k_pools[0])
    num_heads, num_kv = config.num_heads, config.num_kv_heads
    width, chunk = chunk_tokens.shape
    device = chunk_tokens.device
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)
    x = L.embedding(params["embed"], chunk_tokens, mesh).to(config.dtype)
    cap_tables = _table_cap(tables_rows, block_tokens, t_cap)
    # per-query chunk causality: side position p is visible to chunk
    # query c iff p <= c (both offset-relative)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=device).tril().expand(width, chunk, chunk)
    tri = tri.contiguous()
    q_pos = offsets[:, None] + torch.arange(chunk, device=device,
                                            dtype=torch.int32)[None]
    nbt = tables_rows.shape[1]
    blocks = q_pos // block_tokens
    block_offsets = q_pos % block_tokens
    dest = torch.gather(tables_rows, 1, blocks.clamp(0, nbt - 1).long())
    dest = torch.where(valid[:, None] & (blocks < nbt), dest, num_total)
    for i, layer in enumerate(params["layers"]):
        q, k, v = _project_qkv(layer, config,
                               L.rms_norm(layer["ln_attn"], x))
        q = L.apply_rope(q, cos, sin, offsets)
        k = L.apply_rope(k, cos, sin, offsets).contiguous()
        v = v.contiguous()
        out = paged_decode_attention(
            _grouped_queries(q, num_kv), k_pools[i], v_pools[i], cap_tables,
            k, v, tri, offsets, groups=num_heads // num_kv,
            fold_scales=False)
        out = out.reshape(width, num_heads, chunk,
                          config.head_dim).to(x.dtype)
        x = x + L.row_parallel_linear(layer["attn"]["o"],
                                      L._merge_heads(out), mesh)
        x = x + llama_ffn(layer, config, L.rms_norm(layer["ln_mlp"], x),
                          mesh)
        L.scatter_paged_rows(k_pools[i], dest, block_offsets,
                             _store_rows(k_pools[i], k))
        L.scatter_paged_rows(v_pools[i], dest, block_offsets,
                             _store_rows(v_pools[i], v))
    x = L.rms_norm(params["ln_out"], x)
    last_hidden = x[torch.arange(width, device=device), final_idx.long()]
    firsts = L.greedy_tokens(params["lm_head"], last_hidden, mesh)
    apply = valid & finish
    slots = slots.long()
    tokens[slots] = torch.where(apply, firsts, tokens[slots])
    lengths[slots] = torch.where(apply, offsets + final_idx + 1,
                                 lengths[slots])
    if context is not None:
        _extend_context(context, slots, chunk_tokens, offsets, valid)
    return firsts
