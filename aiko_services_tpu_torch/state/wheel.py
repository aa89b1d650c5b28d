# Hierarchical hashed timer wheel (Varghese & Lauck, SOSP '87).
#
# The event engine's original timer store was one heapq: O(log n) per
# schedule, O(n) removal-by-identity, and — the killer at session
# cardinality — every cancelled entry stays in the heap until its due
# time bubbles it to the top.  At 1e5-1e6 outstanding leases (a
# million-session state plane) where almost every timer is
# cancelled/extended before it fires (a touch extends the lease, a
# reply cancels the hop timeout), the heap is mostly tombstones and
# every operation pays for them.
#
# The wheel makes the common case O(1):
#   schedule — hash the due tick into a slot of the coarsest-fitting
#              level (no ordering work at all);
#   cancel   — pop the handle from the entry map (the slot keeps a dead
#              reference that expiry skips: lazy deletion, no scan);
#   advance  — each elapsed tick visits exactly one level-0 slot; when
#              a level wraps, one slot of the next level up cascades
#              back down.  Cost is O(ticks elapsed + entries expired),
#              independent of how many timers are outstanding.
#
# Levels: slot counts are a power of two so slot indexing is a shift +
# mask of the integer tick counter.  With tick=10 ms and 256 slots the
# levels span 2.56 s / ~11 min / ~2 days — lease times land in level 0
# or 1, so a cascade touches an entry at most twice in its life.
#
# Determinism: the wheel has no clock of its own — advance(now) is
# driven by the caller (the event engine's step(), or settle_virtual
# through it), so virtual-clock tests replay bit-identically.
#
# Ordering: entries expire in tick order; within one tick they expire
# in insertion order.  Sub-tick ordering is NOT preserved — the wheel's
# contract is "within tick tolerance", which is what lease semantics
# need (a lease is a coarse timeout, not a sequencer).
#
# The port's own copy of aiko_services_tpu/state/wheel.py.

from __future__ import annotations

import itertools
from typing import Any

__all__ = ["TimerWheel", "WheelEntry"]

_SLOT_BITS = 8
_SLOTS = 1 << _SLOT_BITS            # 256 slots per level
_LEVELS = 3


class WheelEntry:
    """One scheduled timer.  `payload` is whatever the caller wants to
    get back at expiry (a callback for the event engine, a session key
    for the SessionTable)."""
    __slots__ = ("handle", "due", "tick_due", "payload")

    def __init__(self, handle: int, due: float, tick_due: int,
                 payload: Any):
        self.handle = handle
        self.due = due
        self.tick_due = tick_due
        self.payload = payload

    def __repr__(self):
        return f"WheelEntry({self.handle} due={self.due:.3f})"


class TimerWheel:
    """Hierarchical hashed timer wheel: O(1) schedule/cancel, O(ticks +
    expiries) advance.

    Not thread-safe by itself — the event engine calls it under its own
    lock, and the SessionTable drives its private wheel from one timer
    handler.
    """

    def __init__(self, now: float = 0.0, tick: float = 0.01):
        if tick <= 0:
            raise ValueError("TimerWheel tick must be > 0")
        self.tick = float(tick)
        self._now_tick = self._tick_of(now)
        # level l slot s → list of WheelEntry (may hold cancelled
        # tombstone refs; liveness is `_entries.get(handle) is entry`)
        self._slots = [[[] for _ in range(_SLOTS)] for _ in range(_LEVELS)]
        self._entries: dict[int, WheelEntry] = {}
        self._handles = itertools.count(1)
        self._dirty = False         # any slot may hold (dead) refs
        # entries whose slot has been processed but whose exact due is
        # still ahead of the caller's `now` (sub-tick precision: an
        # entry never fires BEFORE its due), plus entries scheduled
        # into the past (0-delay oneshots fire on the very next
        # advance, clock movement or not — heap parity).  Bounded by
        # one tick's worth of schedules.
        self._pending: list[WheelEntry] = []

    # -- geometry ----------------------------------------------------------
    def _tick_of(self, when: float) -> int:
        """First tick boundary at or after `when` (never fires early)."""
        ticks = when / self.tick
        whole = int(ticks)
        return whole if whole == ticks else whole + 1

    def _place(self, entry: WheelEntry) -> None:
        """Hash the entry into the coarsest-fitting level's slot.  Dues
        beyond the top level's span land in the top level and cascade
        around again when their slot comes up — correct, just touched
        once per top-level revolution."""
        if entry.tick_due < self._now_tick:
            # its slot has already been processed: overdue — fires on
            # the next advance
            self._pending.append(entry)
            return
        delta = entry.tick_due - self._now_tick
        for level in range(_LEVELS):
            if delta < (1 << (_SLOT_BITS * (level + 1))) \
                    or level == _LEVELS - 1:
                slot = (entry.tick_due >> (_SLOT_BITS * level)) \
                    & (_SLOTS - 1)
                self._slots[level][slot].append(entry)
                self._dirty = True
                return

    # -- API ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def schedule(self, due: float, payload: Any,
                 handle: int | None = None) -> int:
        """Schedule `payload` for expiry at absolute time `due` (same
        clock domain as the `now` passed to advance()).  Returns the
        cancel handle; pass `handle` to use an external id space (the
        event engine reuses its timer seq numbers)."""
        if handle is None:
            handle = next(self._handles)
        entry = WheelEntry(handle, due, self._tick_of(due), payload)
        self._entries[handle] = entry
        self._place(entry)
        return handle

    def cancel(self, handle: int) -> bool:
        """O(1): drop the handle from the entry map.  The slot's stale
        reference is skipped (and discarded) when its tick comes up —
        no scan, no tombstone accumulation beyond one revolution."""
        return self._entries.pop(handle, None) is not None

    def entries(self):
        """Live entries (unordered) — diagnostic/compat use only."""
        return list(self._entries.values())

    def next_due(self) -> float | None:
        """Conservative lower bound on the next expiry: the next tick
        boundary while anything is outstanding.  The event engine caps
        its idle sleep at one tick anyway, so a tighter bound would buy
        nothing; an empty wheel reports None so loop() can exit."""
        if not self._entries:
            return None
        return self._now_tick * self.tick

    def advance(self, now: float) -> list[WheelEntry]:
        """Advance wheel time to `now`; returns entries with due <= now
        in tick order (insertion order within a tick).  An entry never
        fires before its exact due; an entry scheduled in the past
        fires on the very next advance, whether or not the clock
        moved.  Expired entries are REMOVED from the wheel — the
        caller owns delivering them."""
        expired: list[WheelEntry] = []
        entries = self._entries
        if self._pending:
            still: list[WheelEntry] = []
            for entry in self._pending:
                if entries.get(entry.handle) is not entry:
                    continue                # cancelled: tombstone
                if entry.due <= now:
                    del entries[entry.handle]
                    expired.append(entry)
                else:
                    still.append(entry)
            self._pending = still
        # process every tick boundary at or below `now` — plus the one
        # just above it, so a sub-tick due (e.g. a 0-delay oneshot
        # scheduled mid-tick) is examined now instead of waiting for
        # the clock to cross the boundary
        target = self._tick_of(now)
        if target < self._now_tick:
            return expired
        if not entries:
            # fast-skip an empty wheel: slots hold only tombstones (if
            # anything), which the jump orphans harmlessly — liveness
            # is the entry map, and it is empty.  Drop the tombstone
            # refs once so the idle path stays allocation-free after.
            if self._dirty:
                self._slots = [[[] for _ in range(_SLOTS)]
                               for _ in range(_LEVELS)]
                self._dirty = False
            self._now_tick = target + 1
            return expired
        level0 = self._slots[0]
        while self._now_tick <= target:
            tick = self._now_tick
            bucket = level0[tick & (_SLOTS - 1)]
            if bucket:
                level0[tick & (_SLOTS - 1)] = []
                for entry in bucket:
                    if entries.get(entry.handle) is not entry:
                        continue            # cancelled: tombstone
                    if entry.tick_due > tick:
                        # future revolution of this slot: put it back
                        self._place(entry)
                    elif entry.due <= now:
                        del entries[entry.handle]
                        expired.append(entry)
                    else:
                        # right tick, due still sub-tick ahead of
                        # `now`: hold for the next advance
                        self._pending.append(entry)
            self._now_tick = tick + 1
            # level wrap: cascade one slot of the next level down.
            # Cascading BEFORE re-placement sees the new _now_tick, so
            # redistributed entries land in level 0 slots still ahead.
            shifted = self._now_tick
            for level in range(1, _LEVELS):
                shifted >>= _SLOT_BITS
                if self._now_tick & ((1 << (_SLOT_BITS * level)) - 1):
                    break
                slot = shifted & (_SLOTS - 1)
                bucket = self._slots[level][slot]
                if bucket:
                    self._slots[level][slot] = []
                    for entry in bucket:
                        if entries.get(entry.handle) is entry:
                            self._place(entry)
        return expired
