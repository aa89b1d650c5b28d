# The decode-round phase profiler.
#
# The port's own copy of aiko_services_tpu/observe/profiler.py.
# ContinuousDecoder.pump() marks the boundary of every phase of a serving
# round:
#
#   plan           host-side round planning (active mask, budgets, the
#                  cache extent)
#   scan_dispatch  launching the round's decode steps (asynchronous on
#                  the card: the host queues the kernels and moves on)
#   spec_verify    the same boundary in speculative mode (the launched
#                  program is the widened verify step)
#   admit_dispatch bucketed prefill admits queued behind the decode steps
#   extend_dispatch chunked-prefill extends queued behind them
#   host_sync      the wait on the CUDA event behind the round's one
#                  device-to-host copy: where the host waits for the card
#                  to finish what was launched above (the decode steps'
#                  modeled bytes are charged here, as the JAX package
#                  charges them to its sync wall)
#   wave_resolve   resolving earlier rounds' deferred admit first tokens
#   deliver        walking emissions into callbacks and retirements
#   other          whatever the marks did not cover: 1 - other/wall is
#                  the attributed fraction
#
# and a PhaseProfiler accumulates wall time per phase.  A mark is one
# time.perf_counter read and never touches the device (no .item(), no
# event, no synchronize), so the profiler is always on and the decoder
# keeps its one host wait a round.  The serving_phase_seconds_total and
# serving_phase_bytes_total families read the same accumulators.
#
# The bytes model rides the same phases: the decoder charges each
# round's modeled device bytes (the weights and the KV extent read by the
# decode steps, the prefill writes of admits and extends) to a phase, so
# phase_stats() can report an implied GB/s per phase.  It is a ratio of
# the model's bytes to a host phase's wall: where the card runs the work
# while the host is still launching it, it is no device rate.
#
# Opt-in deep capture: arm_trace() opens a torch.profiler window for
# `duration` seconds, armed by environment (AIKO_PROFILE_TRACE=<logdir>,
# AIKO_PROFILE_TRACE_S=<seconds>) or programmatically (an SLO alert's
# on_alert hook can arm it).  The window records CPU and CUDA activity
# when a card is present, the CPU alone otherwise, and writes a Chrome
# trace into `logdir` when it closes.  Starting and stopping the profiler
# may synchronize the device; both happen at round boundaries, after the
# round's own wait.  torch.profiler is imported only when a window opens.

from __future__ import annotations

import os
import time

from .metrics import MetricsRegistry, default_registry

__all__ = ["PhaseProfiler", "PHASES", "arm_trace", "trace_state"]

PHASES = ("plan", "scan_dispatch", "spec_verify", "admit_dispatch",
          "extend_dispatch", "host_sync", "wave_resolve", "deliver",
          "other")

# -- torch.profiler capture window --------------------------------------------

_trace = {"armed": False, "active": False, "logdir": None,
          "until": 0.0, "duration": 3.0, "captures": 0, "error": None,
          "path": None}
_session = {"profile": None}          # the open torch.profiler.profile


def arm_trace(logdir: str, duration: float = 3.0) -> None:
    """Arm a one-shot torch.profiler capture window: the next profiled
    round starts the trace, and it stops `duration` seconds later."""
    _trace["armed"] = True
    _trace["logdir"] = str(logdir)
    _trace["duration"] = float(duration)


def trace_state() -> dict:
    """The window's state: armed / active, its logdir and duration, the
    captures written so far, the last trace's path and the last error."""
    return dict(_trace)


def _env_arm() -> None:
    logdir = os.environ.get("AIKO_PROFILE_TRACE", "")
    if logdir:
        arm_trace(logdir,
                  float(os.environ.get("AIKO_PROFILE_TRACE_S", "3.0")))


_env_arm()


def _start_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    session = profile(activities=activities)
    session.start()
    return session


def _stop_profile(session) -> str:
    session.stop()
    os.makedirs(_trace["logdir"], exist_ok=True)
    path = os.path.join(_trace["logdir"],
                        f"aiko_trace_{os.getpid()}_{_trace['captures']}"
                        f".json")
    session.export_chrome_trace(path)
    return path


def _trace_tick() -> None:
    """Advance the capture window's state machine (called once per
    committed or abandoned round; nothing to do when nothing is armed)."""
    if not (_trace["armed"] or _trace["active"]):
        return
    now = time.perf_counter()
    if _trace["armed"] and not _trace["active"]:
        _trace["armed"] = False
        try:
            _session["profile"] = _start_profile()
            _trace["active"] = True
            _trace["until"] = now + _trace["duration"]
        except Exception as exc:    # profiler unavailable: disarm, note
            _trace["error"] = repr(exc)
        return
    if _trace["active"] and now >= _trace["until"]:
        session, _session["profile"] = _session["profile"], None
        try:
            _trace["path"] = _stop_profile(session)
            _trace["captures"] += 1
        except Exception as exc:
            _trace["error"] = repr(exc)
        _trace["active"] = False


class PhaseProfiler:
    """Per-round wall-time attribution into named phases.

    Usage (the pump loop's shape):

        profiler.begin_round()
        ...planning...          ; profiler.mark("plan")
        ...launch the steps...  ; profiler.mark("scan_dispatch")
        ...
        profiler.commit_round()    # or abandon_round() for idle ticks

    mark(name) charges the time since the previous boundary to `name`;
    commit folds the staged marks into the accumulators and charges the
    unmarked remainder to "other".  abandon_round() discards the staged
    marks: idle pump ticks must not dilute the attribution."""

    def __init__(self, name: str = "decoder",
                 registry: MetricsRegistry | None = None):
        self.name = name
        self.rounds = 0
        self.wall_s = 0.0
        self.phase_s = {phase: 0.0 for phase in PHASES}
        self.phase_bytes = {phase: 0 for phase in PHASES}
        self._t0 = 0.0
        self._last = 0.0
        self._staged: list = []
        self._staged_bytes: dict = {}
        registry = registry or default_registry()
        labels = {"decoder": name}
        self._seconds_counters = {
            phase: registry.counter(
                "serving_phase_seconds_total",
                "decode-round wall seconds by phase",
                labels={**labels, "phase": phase})
            for phase in PHASES}
        self._bytes_counters = {
            phase: registry.counter(
                "serving_phase_bytes_total",
                "modeled device HBM bytes by phase",
                labels={**labels, "phase": phase})
            for phase in PHASES}

    # -- the hot-path mark API (one perf_counter read each) -------------------
    def begin_round(self) -> None:
        self._t0 = self._last = time.perf_counter()
        self._staged = []
        self._staged_bytes = {}

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self._staged.append((phase, now - self._last))
        self._last = now

    def add_bytes(self, phase: str, nbytes: int) -> None:
        self._staged_bytes[phase] = \
            self._staged_bytes.get(phase, 0) + int(nbytes)

    def abandon_round(self) -> None:
        self._staged = []
        self._staged_bytes = {}
        # idle ticks still advance the capture window: a window armed by
        # an alert must stop on schedule even if decode work ceases
        _trace_tick()

    def commit_round(self) -> None:
        total = time.perf_counter() - self._t0
        marked = 0.0
        for phase, dt in self._staged:
            self.phase_s[phase] = self.phase_s.get(phase, 0.0) + dt
            counter = self._seconds_counters.get(phase)
            if counter is not None:
                counter.inc(dt)
            marked += dt
        other = max(0.0, total - marked)
        self.phase_s["other"] += other
        self._seconds_counters["other"].inc(other)
        for phase, nbytes in self._staged_bytes.items():
            self.phase_bytes[phase] = \
                self.phase_bytes.get(phase, 0) + nbytes
            counter = self._bytes_counters.get(phase)
            if counter is not None:
                counter.inc(nbytes)
        self.rounds += 1
        self.wall_s += total
        self._staged = []
        self._staged_bytes = {}
        _trace_tick()

    # -- reporting --------------------------------------------------------------
    def reset(self) -> None:
        self.rounds = 0
        self.wall_s = 0.0
        for phase in self.phase_s:
            self.phase_s[phase] = 0.0
        for phase in self.phase_bytes:
            self.phase_bytes[phase] = 0

    def attributed_fraction(self) -> float:
        """Fraction of committed round wall time carrying a named phase
        (1 - other/wall)."""
        if self.wall_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.phase_s["other"] / self.wall_s)

    def phase_stats(self) -> dict:
        """{"rounds", "wall_s", "attributed_frac", "phases": {name:
        {"s", "frac", "ms_per_round", "bytes", "gb_per_s"?}}}: phases
        with no time and no bytes are omitted (speculative and plain
        mode each use their own dispatch phase)."""
        phases = {}
        for phase in PHASES:
            seconds = self.phase_s[phase]
            nbytes = self.phase_bytes[phase]
            if seconds <= 0.0 and nbytes <= 0:
                continue
            entry = {
                "s": seconds,
                "frac": seconds / self.wall_s if self.wall_s > 0
                else 0.0,
                "ms_per_round": seconds * 1000.0 / self.rounds
                if self.rounds else 0.0,
                "bytes": nbytes,
            }
            if nbytes and seconds > 0:
                entry["gb_per_s"] = nbytes / seconds / 1e9
            phases[phase] = entry
        return {"rounds": self.rounds, "wall_s": self.wall_s,
                "attributed_frac": self.attributed_fraction(),
                "phases": phases}
