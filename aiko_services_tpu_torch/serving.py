# Continuous-batching greedy Llama decoding over a paged KV block pool.
#
# Counterpart of aiko_services_tpu/serving.py's ContinuousDecoder in the
# one mode this port has: paged_kv=True with the paged decode-attention
# kernel (the JAX package's ATTENTION_IMPL="paged_kernel"), a native or
# int8 pool (kv_cache_dtype), bucketed single-shot prefill and chunked
# prefill (prefill_chunk, prefill_budget), greedy decoding and a dense
# SwiGLU FFN.  The scheduling is the JAX decoder's: decode-first rounds of
# up to steps_per_sync steps, admits and chunk extends dispatched behind
# the round's decode steps and resolved at the next round's sync, one
# host sync per round.  Every other mode of the JAX decoder raises
# NotImplementedError naming the ROADMAP.md item that brings it.

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .models import layers as L
from .models.llama import LlamaConfig, llama_ffn
from .observe.metrics import MirroredStats, default_registry
from .serving_paged import (BlockPool, _build_paged_step, _paged_admit,
                            _paged_extend)

__all__ = ["ContinuousDecoder", "DecodeRequest", "measure_device_step"]


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
    _not_ported("measure_device_step", "5")


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

    submit() enqueues a request; call pump() until idle.  Each round,
    decode-first: run up to steps_per_sync decode steps for every live
    slot, dispatch bucketed admits and prompt chunks behind them, fetch
    the round's emissions and earlier rounds' admit and extend outputs
    in one host transfer, deliver tokens and retire finished slots
    through their callbacks.

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
                 registry=None, prefix_cache=None,
                 paged_kv: bool = False, kv_block: int = 32,
                 device=None):
        if not paged_kv:
            _not_ported("the dense slot cache (paged_kv=False)", "5")
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
        if prefix_cache is not None:
            _not_ported("the prefix cache (prefix_cache)", "4")
        if weight_quant or fuse_projections:
            _not_ported("weight_quant and fuse_projections", "5")
        if config.num_experts:
            _not_ported("the mixture-of-experts FFN (num_experts > 0)",
                        "5")
        self.kv_block = int(kv_block)
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
        self._cache_t = min(self.t_block, self.max_seq)
        block = self.kv_block
        # table width covers the worst-case extent _fit_caches can reach
        # (max_seq + the round merge's headroom)
        self._table_blocks = -(-(self.max_seq + steps_per_sync) // block)
        self.pool = BlockPool(
            config, block, self.kv_int8,
            initial_blocks=max_slots * (-(-self._cache_t // block)),
            grow_blocks=max(1, max_slots * self.t_block // block),
            name=name, registry=registry, device=self.device)
        self._tables_np = np.zeros((max_slots, self._table_blocks),
                                   np.int32)
        # reused host buffer for admit table rows
        self._tables_scratch = np.zeros_like(self._tables_np)
        self._tables_dirty = True
        self._tables_dev = None
        self._tables_dev_nb = -1
        # per-slot owned pool block ids, in table order
        self._slot_blocks: list[list] = [[] for _ in range(max_slots)]
        self._tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=self.device)
        self._lengths = torch.zeros_like(self._tokens)
        self._step = _build_paged_step(config, self.device)
        self._slots: list[DecodeRequest | None] = [None] * max_slots
        self._pending: list[DecodeRequest] = []
        # admit output stash: (firsts device tensor, [(row, request)])
        # per dispatch, resolved at the NEXT round's sync
        self._admit_waves: list = []
        self._active_np = np.zeros((max_slots,), bool)
        self._budgets_np = np.zeros((max_slots,), np.int32)
        self._registry = registry or default_registry()
        self.stats = MirroredStats(
            {"steps": 0, "rounds": 0, "completed": 0, "prefills": 0,
             "occupancy_sum": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
             "useful_steps": 0, "wasted_steps": 0, "tokens_decode": 0,
             "tokens_prefill": 0, "prefill_chunks": 0, "chunk_admits": 0,
             "round_prefill_tokens_max": 0},
            metric="serving_decoder_total",
            help="continuous-decoder events by kind",
            registry=self._registry,
            skip=("occupancy_sum", "prefill_s", "decode_s",
                  "round_prefill_tokens_max"))
        # prefill tokens dispatched in the current round (the budget's
        # account)
        self._round_prefill_tokens = 0

    # -- public API --------------------------------------------------------
    def submit(self, request_id: str, prompt, max_new_tokens: int,
               callback, deadline: float | None = None,
               tenant: str | None = None,
               prefill_label: str | None = None,
               kv_blocks: tuple | None = None,
               progress_callback=None) -> bool:
        """Enqueue one request; its callback(request_id, tokens) fires
        at retire.  Prompts keep their tail up to the largest bucket
        (up to max_seq - 1 with chunked prefill); an empty prompt becomes
        one pad token.  Returns True."""
        if deadline is not None:
            _not_ported("deadline-aware admission (deadline)", "5")
        if tenant is not None:
            _not_ported("tenants (tenant)", "5")
        if prefill_label is not None or kv_blocks is not None or \
                progress_callback is not None:
            _not_ported("disaggregated prefill (prefill_label, kv_blocks, "
                        "progress_callback)", "6")
        if self.prefill_chunk:
            limit = self.max_seq - 1
        else:
            limit = min(self.max_seq - 1, self.prefill_buckets[-1])
        prompt = [int(t) for t in prompt] or [0]
        self._pending.append(DecodeRequest(
            request_id, prompt[-limit:], int(max_new_tokens), callback))
        return True

    def attach(self, engine, period: float = 0.002) -> int:
        _not_ported("attach(engine): pumping from an event engine", "5")

    def attach_ledger(self, ledger) -> None:
        _not_ported("the KV memory ledger", "5")

    def drain(self, deadline: float | None = None, on_evacuate=None,
              on_complete=None) -> list:
        _not_ported("graceful drain", "5")

    def resume(self) -> None:
        _not_ported("graceful drain (resume)", "5")

    def slo_stats(self) -> dict:
        _not_ported("request journeys and SLO samples", "5")

    def slo_sketch_stats(self, prefill: str | None = None,
                         tenant: str | None = None) -> dict:
        _not_ported("request journeys and SLO sketches", "5")

    @property
    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def idle(self) -> bool:
        return self.active_count == 0 and not self._pending

    def kv_cache_bytes(self) -> int:
        """Bytes allocated to the KV pool's device arrays plus the int32
        block tables."""
        return self.pool.nbytes() + int(self._tables_np.nbytes)

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
    def _ensure_coverage(self, slot: int, upto: int) -> None:
        """Extend `slot`'s block table to cover positions [0, upto) with
        fresh pool blocks; a no-op when already covered."""
        need = min(-(-max(0, upto) // self.kv_block), self._table_blocks)
        owned = self._slot_blocks[slot]
        if len(owned) >= need:
            return
        fresh = self.pool.alloc_blocks(need - len(owned))
        row = self._tables_np[slot]
        for j, block_id in enumerate(fresh, start=len(owned)):
            row[j] = block_id
        owned.extend(fresh)
        self._tables_dirty = True

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

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop the slot's refs on every table block (at retire)."""
        owned = self._slot_blocks[slot]
        if owned:
            self.pool.release_blocks(owned)
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
        FIFO order.  Prompts longer than the largest bucket (only with
        prefill_chunk set) take a slot here and stream in chunks
        (_advance_prefills); the others go through bucketed single-shot
        prefill groups.  With prefill_budget set, bucketed admission
        stops for the round once the budget is spent: later arrivals
        wait rather than stall the decoding slots."""
        free = [s for s in range(self.max_slots) if self._slots[s] is None]
        if not free or not self._pending:
            return
        groups: dict[int, list[DecodeRequest]] = {}
        chunked: list[DecodeRequest] = []
        taken = 0
        for request in self._pending:
            if taken >= len(free):
                break
            if self.prefill_chunk and \
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
            taken += 1
        self._pending = self._pending[taken:]
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
        for bucket, requests in groups.items():
            while requests:
                width = min(self.max_slots,
                            self._next_pow2(len(requests)))
                chunk, requests = requests[:width], requests[width:]
                self._admit_group(bucket, width, chunk, free)
        self.stats["prefill_s"] += time.perf_counter() - start

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
                self._ensure_coverage(slot, nbb * self.kv_block)
                tables_rows[j] = self._tables_np[slot, :nbb]
        except Exception:
            # pool growth refused (device memory exhausted) before any
            # slot was assigned: release what this wave claimed and put
            # the chunk back at the head of the queue
            for slot in slots:
                self._release_slot_blocks(slot)
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
        first always does)."""
        rows = [s for s in range(self.max_slots)
                if self._slots[s] is not None and self._slots[s].prefilling]
        if not rows:
            return
        rows.sort(key=lambda s: len(self._slots[s].prompt) -
                  self._slots[s].prefill_pos)      # fewest remaining first
        chunk = self.prefill_chunk
        need = 0
        spent = self._round_prefill_tokens
        plans = []
        for slot in rows:
            request = self._slots[slot]
            total = len(request.prompt)
            if self.prefill_budget is not None and plans and \
                    spent + chunk > self.prefill_budget:
                break
            spent += chunk
            if total - request.prefill_pos > chunk:
                offset, finish = request.prefill_pos, False
            else:
                # the final chunk slides BACK to end exactly at the
                # prompt's tail: the overlap recomputes K/V of the same
                # positions, and offset + chunk stays within the prompt
                offset, finish = max(0, total - chunk), True
            plans.append((slot, request, offset, finish))
            # the write extent is offset + chunk (a prompt shorter than
            # one chunk pads: decode overwrites that tail before it is
            # ever attended)
            need = max(need, offset + chunk)
        # grow-only: never let a decode-side shrink cut below the writes
        self._fit_caches(max(need, self._cache_t))
        start = time.perf_counter()
        while plans:
            width = min(self.max_slots, self._next_pow2(len(plans)))
            batch, plans = plans[:width], plans[width:]
            self._extend_group(chunk, width, batch)
        self.stats["prefill_s"] += time.perf_counter() - start

    def _extend_group(self, chunk: int, width: int, batch: list) -> None:
        """Dispatch one chunk extend for `batch` [(slot, request, offset,
        finish)] at `width` rows (pad rows on distinct spare slots, null
        tables, offset 0).  Rows that finish their prompt owe their
        first token, resolved from the stashed wave at the next round's
        sync."""
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
            self._ensure_coverage(slot, offset + chunk)
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
        self._release_slot_blocks(slot)
        self._slots[slot] = None
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
        elif not waves_due and not self._admit_waves and self.idle:
            # idle tick: give the pool's free tail back
            self.pool.maybe_shrink()

    def _deliver(self, slot: int, token: int) -> None:
        request = self._slots[slot]
        request.generated.append(token)
        if self._finished(request, token):
            self._retire(slot)
