# soak CLI: progress + verdict go to the console by design
# graft: disable-file=lint-print
# Chaos soak: the speech pipeline across two runtimes over a ChaosBroker,
# surviving drops, duplicates, a network partition, and a mid-stream kill
# of the active serving runtime.  The port's copy of scripts/chaos_soak.py,
# with every scenario, flag, report key and exit rule of that script.
#
# Scenario (all times in VIRTUAL seconds from the end of setup):
#
#   caller runtime   PE_AudioReadFile → PE_AudioFraming → PE_LogMel →
#                    [remote hop, retries + failover enabled]
#   serving runtimes serve_asr × 2 (PE_WhisperASR, "test" preset) —
#                    the caller discovers both; the active one is KILLED
#                    mid-stream (transport crash: LWTs fire, then the
#                    plan silences the corpse) and traffic fails over
#   chaos plan       seeded drops + duplicates on the data topics, a
#                    partition window severing caller ↔ serving, all
#                    deterministic under --seed
#
# The run is a pure function of the seed: one random.Random drives every
# fault decision in delivery order on a VirtualClock engine.  The JSON
# report counts frames sent/recovered/lost, every fault injected, the
# recovery machinery's work (retries, failovers, dedups) and the leak
# checks (pending hops, live hop leases).
#
# The speech soak's ComputeRuntimes and PE_LogMel, and the migrate soak's
# decoders, run on the card unless --device names another device.
#
# Usage:
#   python -m aiko_services_tpu_torch.scripts.chaos_soak --seed 11 --frames 8
#   python -m aiko_services_tpu_torch.scripts.chaos_soak --seed 7 \
#       --frames 24 --drop 0.25 --horizon 120 --max-lost 0
#   python -m aiko_services_tpu_torch.scripts.chaos_soak --migrate \
#       --preset 1b
#   python -m aiko_services_tpu_torch.scripts.chaos_soak --device cpu

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

__all__ = ["run_soak", "run_tenant_soak", "run_migrate_soak", "main"]

from ..event import settle_virtual as _settle


def _counter_series(snapshot: dict, names) -> dict:
    """Flatten counter families out of a registry snapshot:
    {"name{k=v,...}": value} for the requested family names."""
    from ..observe.export import series_key
    flat = {}
    for name in names:
        entry = snapshot.get(name)
        if not entry:
            continue
        for series in entry.get("series", []):
            flat[series_key(name, series.get("labels", {}))] = \
                series.get("value", 0)
    return flat


_TELEMETRY_FAMILIES = (
    "chaos_faults_total", "pipeline_recovery_total",
    "broker_messages_total", "transport_client_messages_total",
    "pipeline_wire_envelopes_total", "pipeline_wire_frames_total",
    "peer_events_total", "autoscaler_decisions_total",
    "admission_admitted_total", "admission_shed_total",
    "admission_rejected_total",
)


def _serving_definition(compute_name: str = "compute"):
    return {
        "version": 0, "name": "serve_asr", "runtime": "python",
        "graph": ["(PE_WhisperASR)"],
        "parameters": {
            "PE_WhisperASR.preset": "test",
            "PE_WhisperASR.mode": "sync",
            "PE_WhisperASR.max_tokens": 4,
            "PE_WhisperASR.buckets": [200],
            # the two serving runtimes share one engine in tests: the
            # compute service name must be unique per runtime
            "PE_WhisperASR.compute": compute_name,
        },
        "elements": [
            {"name": "PE_WhisperASR", "input": [{"name": "mel"}],
             "output": [{"name": "tokens"}, {"name": "text"}]},
        ],
    }


def _calling_definition(device):
    """The caller's pipeline; its log-mel runs on `device` (PE_LogMel
    takes the card or the CPU)."""
    return {
        "version": 0, "name": "chaos_call", "runtime": "python",
        "graph": ["(PE_AudioReadFile (PE_AudioFraming (PE_LogMel "
                  "(remote_asr))))"],
        "parameters": {"PE_AudioFraming.window_count": 2,
                       "PE_LogMel.device": "cpu" if device.type == "cpu"
                       else "default"},
        "elements": [
            {"name": "PE_AudioReadFile", "input": [],
             "output": [{"name": "audio"}, {"name": "sample_rate"}]},
            {"name": "PE_AudioFraming", "input": [{"name": "audio"}],
             "output": [{"name": "audio"}]},
            {"name": "PE_LogMel", "input": [{"name": "audio"}],
             "output": [{"name": "mel"}]},
            {"name": "remote_asr", "input": [{"name": "mel"}],
             "output": [{"name": "tokens"}, {"name": "text"}],
             "deploy": {"remote": {"service_filter":
                                   {"name": "serve_asr"}}}},
        ],
    }


def run_soak(seed: int = 11, frames: int = 8, drop: float = 0.15,
             duplicates: int = 3, partition: tuple = (1.0, 2.5),
             kill_at: float = 4.0, frame_interval: float = 0.4,
             remote_timeout: float = 1.5, retries: int = 6,
             failure_budget: int = 4, horizon: float = 60.0,
             wav_path: str | None = None, peer: bool = False,
             peer_kill_at: float | None = None, mqtt: bool = False,
             autoscale: bool = False,
             health_dump_dir: str | None = None, device=None) -> dict:
    """Run the scenario; returns the JSON-able report.

    peer=True runs the data plane over registrar-negotiated direct
    peer channels: every runtime enables the peer host with
    the SAME FaultPlan (so drops/partitions hit peer sends too), the
    caller ships mel as i8mel codes, and at `peer_kill_at` (default:
    1.5 s before kill_at) every open peer channel is killed mid-stream
    — traffic must degrade to the broker without losing a frame, then
    re-negotiate back onto direct channels.

    mqtt=True runs every runtime over MQTTMessage against the loopback
    paho broker (the test_mqtt envelope-soak plumbing, now
    transport/paho_loopback.py): the full MQTT
    client code path carries the binary envelopes, the kill fires the
    victim's LWT through the broker, and chaos applies at the publish
    edge (ChaosMessage).  Client-edge chaos cannot see recipients, so
    the partition window is emulated with symmetric sender-scoped drop
    rules on the data topics.

    autoscale=True brings the serving fleet up through a
    LifeCycleManager (under a RestartPolicy whose backoff is
    deliberately LONGER than the soak) and an Autoscaler holding a
    min_clients=2 floor: the mid-run kill drops the fleet
    below the floor and the AUTOSCALER — not the restart backoff — is
    what respawns capacity, provably (autoscaler_decisions_total
    {action=up, reason=below-floor} in the telemetry block).

    health_dump_dir arms the fleet health plane: metrics
    snapshots publish every 0.5 s, a HealthAggregator on the registrar
    runtime evaluates a hop-p95 SLO rule over windowed series, and
    FlightRecorders ride the caller + serving runtimes.  The partition
    window inflates retried-hop latency past the rule's threshold, the
    burn fires mid-run, and the alert's DumpOnAlert trigger writes
    EXACTLY ONE merged Perfetto timeline into the directory — spans,
    metric samples, and the chaos plan's fault events from every
    runtime, correlated by trace id.  The report gains a "health"
    block (alerts fired, dump path, ring totals).

    device: where the serving runtimes' ComputeRuntimes and the caller's
    log-mel run; None means the card (raises when there is none)."""
    import numpy as np

    from .. import resolve_device
    from ..compute import ComputeRuntime
    from ..elements.speech import save_wav
    from ..event import EventEngine, VirtualClock
    from ..lease import Lease
    from ..pipeline import (
        Pipeline, parse_pipeline_definition)
    from ..process import ProcessRuntime
    from ..registrar import Registrar
    from ..share import ServicesCache
    from ..transport.chaos import (
        ChaosBroker, ChaosMessage, FaultPlan)
    from ..transport.memory import MemoryMessage

    from ..observe import default_registry, tracing

    device = resolve_device(device)
    wall_start = time.monotonic()
    # telemetry: span recording ON for the whole scenario and
    # a registry snapshot taken before/after, so the report embeds the
    # metric DELTAS this run caused (the registry is process-wide and
    # cumulative) — soak regressions diff on these numbers
    trc = tracing.tracer
    tracer_was_enabled = trc.enabled
    trc.enable()
    trc.clear()
    metrics_before = _counter_series(default_registry().snapshot(),
                                     _TELEMETRY_FAMILIES)
    engine = EventEngine(VirtualClock())
    plan = FaultPlan(seed)

    if mqtt:
        from ..transport.mqtt import MQTTMessage
        from ..transport.paho_loopback import (
            LoopbackBroker, LoopbackPaho)
        loop_broker = LoopbackBroker()

        def make_runtime(name):
            def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
                inner = MQTTMessage(
                    on_message=on_message, lwt_topic=lwt_topic,
                    lwt_payload=lwt_payload, lwt_retain=lwt_retain,
                    client_factory=lambda: LoopbackPaho(loop_broker),
                    backoff_min=0.02, backoff_max=0.1)
                return ChaosMessage(inner, plan, engine, client_id=name)
            return ProcessRuntime(name=name, engine=engine,
                                  transport_factory=factory).initialize()
    else:
        broker = ChaosBroker(plan, engine)

        def make_runtime(name):
            def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
                return MemoryMessage(
                    on_message=on_message, broker=broker,
                    lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                    lwt_retain=lwt_retain, client_id=name)
            return ProcessRuntime(name=name, engine=engine,
                                  transport_factory=factory).initialize()

    own_tmpdir = None
    if wav_path is None:
        rng = np.random.default_rng(seed)
        audio = (0.1 * rng.standard_normal(16000)).astype(np.float32)
        own_tmpdir = tempfile.mkdtemp(prefix="chaos_soak_")
        wav_path = os.path.join(own_tmpdir, "utterance.wav")
        save_wav(wav_path, audio)

    # -- clean bring-up (chaos starts after discovery settles) ----------
    registrar_rt = make_runtime("registrar")
    Registrar(registrar_rt)
    _settle(engine, 3.0)

    servings = []
    serving_counter = [0]

    def build_serving():
        serving_counter[0] += 1
        index = serving_counter[0]
        serve_rt = make_runtime(f"serving{index}")
        if peer:
            serve_rt.enable_peer(fault_plan=plan, jitter_seed=seed)
        ComputeRuntime(serve_rt, f"compute{index}", device=device)
        pipeline = Pipeline(
            serve_rt,
            parse_pipeline_definition(_serving_definition(
                f"compute{index}")),
            auto_create_streams=True, stream_lease_time=30.0)
        if autoscale:
            # retained snapshots are what the autoscaler watches
            from ..observe.export import MetricsPublisher
            MetricsPublisher(serve_rt, interval=1.0)
        servings.append((serve_rt, pipeline))
        return serve_rt

    manager = None
    autoscaler = None
    manager_rt = None
    if autoscale:
        from ..autoscaler import Autoscaler, ScalePolicy
        from ..lifecycle import (
            LifeCycleClient, LifeCycleManager)
        from ..process_manager import RestartPolicy
        manager_rt = make_runtime("lcm")

        def spawner(client_id, manager_topic):
            serve_rt = build_serving()
            LifeCycleClient(serve_rt, f"serve_client_{client_id}",
                            manager_topic, client_id)
            return serve_rt

        manager = LifeCycleManager(
            manager_rt, "serve_fleet", spawner,
            # the policy is the crash-loop supervisor of record, but
            # its backoff is parked beyond the soak horizon: the
            # AUTOSCALER's below-floor verdict must be what restores
            # capacity, or the scenario proves nothing about it
            restart_policy=RestartPolicy(max_restarts=8, window=1e6,
                                         backoff=10 * horizon,
                                         jitter=0.0))
        autoscaler = Autoscaler(
            manager_rt, manager=manager,
            # load-driven thresholds parked out of reach: the chaos
            # window itself inflates hop p95 (a partition IS overload),
            # and this scenario must isolate the below-floor
            # restoration path so the report's scale-up provably came
            # from the kill (the hysteresis/no-flap behaviour has its
            # own virtual-clock test)
            policy=ScalePolicy(min_clients=2, max_clients=3,
                               mailbox_depth_up=1e9, hop_p95_up=1e9,
                               batch_wait_up=1e9,
                               hysteresis=3, cooldown=2.0),
            interval=0.5)
        manager.create_clients(2)
        _settle(engine, 3.0)
    else:
        for _ in (1, 2):
            build_serving()
    call_rt = make_runtime("caller")
    if peer:
        call_rt.enable_peer(fault_plan=plan, jitter_seed=seed)
    caller = Pipeline(
        call_rt, parse_pipeline_definition(_calling_definition(device)),
        services_cache=ServicesCache(call_rt), stream_lease_time=0,
        remote_timeout=remote_timeout, remote_retries=retries,
        remote_backoff=0.25, remote_backoff_max=2.0, retry_seed=seed,
        stream_failure_budget=failure_budget,
        # the ASR wire codec: mel crosses as i8
        # codes with per-row scales — 3.8x fewer host→serving bytes
        remote_wire_codecs={"mel": "i8mel"} if peer else None)
    _settle(engine, 2.0)
    if not caller.remote_elements_ready():
        raise RuntimeError("setup: discovery failed")

    # -- fleet health plane ---------------------------------------------
    aggregator = None
    dump_trigger = None
    publisher = None
    recorders = []
    if health_dump_dir is not None:
        from ..observe import (
            DumpOnAlert, FlightRecorder, HealthAggregator,
            MetricsPublisher, SLORule)
        flight_families = ("pipeline_hop_seconds", "chaos_faults_total",
                           "pipeline_recovery_total",
                           "event_mailbox_depth")
        for runtime in [call_rt] + [rt for rt, _ in servings]:
            recorders.append(FlightRecorder(
                runtime, sample_interval=0.5,
                families=flight_families))
        publisher = MetricsPublisher(call_rt, interval=0.5)
        dump_trigger = DumpOnAlert(health_dump_dir)
        # the armed SLO: hop-retry burn.  Retries are charged on the
        # ENGINE clock (timer expiries), so the rule is deterministic
        # under the virtual-clock soak; a wall-clock latency rule
        # (hop p95) would measure how fast the host stepped the
        # scenario, not the scenario.  Burn = retry fraction of hop
        # work against a 5% error budget, in both windows.
        aggregator = HealthAggregator(
            registrar_rt, rules=[SLORule(
                name="hop-retry-burn", kind="ratio",
                bad="pipeline_recovery_total"
                    "{pipeline=chaos_call,kind=retries}",
                good="pipeline_hop_seconds{pipeline=chaos_call}",
                objective=0.95, pairs=((8.0, 2.0, 2.0),),
                description="remote-hop retries burning the 5% "
                            "error budget in both windows")],
            interval=0.5, window=60.0)
        aggregator.on_alert.append(dump_trigger)

    # -- arm the chaos schedule -----------------------------------------
    base = engine.clock.now()
    data_topics = [f"{pipeline.topic_path}/in"
                   for _, pipeline in servings]
    data_topics.append(f"{caller.topic_path}/in")
    for topic in data_topics:
        plan.drop(topic=topic, probability=drop)
        plan.duplicate(topic=topic, probability=1.0, count=duplicates)
        plan.delay(topic=topic, probability=0.2, delay=0.1)
    if mqtt:
        # publish-edge chaos never sees recipients, so a group
        # partition cannot apply: emulate the same window with
        # symmetric sender-scoped total drops on the data topics
        for topic in data_topics:
            plan.drop(topic=topic, sender="caller", probability=1.0,
                      start=base + partition[0],
                      stop=base + partition[1])
            plan.drop(topic=topic, sender="serving*", probability=1.0,
                      start=base + partition[0],
                      stop=base + partition[1])
    else:
        plan.partition([["caller"], ["serving*"]],
                       start=base + partition[0],
                       stop=base + partition[1])
    kill_time = base + kill_at
    # peer scenario: sever every open channel mid-stream — after the
    # partition heals, before the serving-process kill — so the run
    # exercises degrade-to-broker AND the re-negotiation climb-back
    peer_kill_time = base + (peer_kill_at if peer_kill_at is not None
                             else max(kill_at - 1.5, 0.5))

    # -- drive -----------------------------------------------------------
    done = []
    caller.add_frame_handler(done.append)
    posted: list[str] = []
    killed = False
    peer_killed = False
    peer_kills = 0
    next_frame = 0
    deadline = base + horizon
    while engine.clock.now() < deadline:
        now = engine.clock.now()
        while next_frame < frames and \
                now >= base + next_frame * frame_interval:
            stream_id = f"s{next_frame}"
            caller.create_stream(stream_id, lease_time=0, parameters={
                "PE_AudioReadFile.pathname": wav_path})
            caller.post("process_frame", stream_id, {})
            posted.append(stream_id)
            next_frame += 1
        if peer and not peer_killed and now >= peer_kill_time:
            peer_killed = True
            peer_kills = call_rt.peer.kill_channels("mid-stream-kill")
        if not killed and now >= kill_time:
            killed = True
            # transport-level crash: LWTs fire through the chaos broker
            # first (a real broker generates them itself), THEN the
            # corpse is silenced — anything the dead runtime's handlers
            # still try to send vanishes
            servings[0][0].message.crash()
            if peer:
                # a dead process takes its peer channels with it
                servings[0][0].peer.kill_channels("process-kill")
            plan.drop(sender="serving1", start=now)
        while engine.step():
            pass
        completed = {frame.stream_id for frame in done}
        lost = [sid for sid in posted
                if sid not in caller.streams and sid not in completed]
        frames_settled = next_frame >= frames and \
            len(completed) + len(lost) >= frames
        # the autoscale scenario must run THROUGH the kill and the
        # autoscaler's floor restoration, even when every frame settled
        # early — the respawn is the acceptance, not a side effect
        capacity_recovered = manager is None or (
            killed and serving_counter[0] >= 3
            and manager.ready_count() >= 2)
        if frames_settled and capacity_recovered:
            break
        engine.clock.advance(0.05)
    _settle(engine, 1.0)
    if aggregator is not None and not aggregator.alerts:
        # the last retried hops may complete right at loop exit: give
        # the publisher + evaluator a few more ticks to see them
        _settle(engine, 3.0)

    # -- report + leak checks --------------------------------------------
    completed = {frame.stream_id for frame in done}
    lost = [sid for sid in posted
            if sid not in caller.streams and sid not in completed]
    leaked_hop_leases = 0
    for handler in engine.live_timer_handlers():
        owner = getattr(handler, "__self__", None)
        if isinstance(owner, Lease) and \
                str(owner.lease_id).startswith("chaos_call."):
            leaked_hop_leases += 1
    serving_stats = {
        key: sum(p.recovery_stats[key] for _, p in servings)
        for key in servings[0][1].recovery_stats}
    report = {
        "seed": seed,
        "frames_sent": len(posted),
        "frames_recovered": len(completed),
        "frames_lost": len(lost),
        "lost_streams": lost,
        # every recovered reply must carry the ASR text output; on the
        # synthetic noise utterance the decoded text itself may be ""
        "texts_returned": sum(
            1 for frame in done
            if isinstance(frame.swag.get("text"), str)),
        "texts_nonempty": sum(
            1 for frame in done
            if isinstance(frame.swag.get("text"), str)
            and frame.swag.get("text")),
        "faults_injected": dict(plan.stats),
        "caller_recovery": dict(caller.recovery_stats),
        "serving_recovery": serving_stats,
        "pending_hops": len(caller._pending_remote),
        "leaked_hop_leases": leaked_hop_leases,
        "virtual_seconds": round(engine.clock.now() - base, 2),
        "wall_seconds": round(time.monotonic() - wall_start, 2),
    }
    if peer:
        caller_info = call_rt.peer.info()
        report["peer"] = {
            "mid_stream_kills": peer_kills,
            "caller": caller_info["stats"],
            "caller_pins": caller_info["pins"],
            "serving": {f"serving{i + 1}": rt.peer.info()["stats"]
                        for i, (rt, _) in enumerate(servings)},
        }
    report["transport"] = "mqtt" if mqtt else "memory"
    if aggregator is not None:
        report["health"] = {
            "alerts": dict(aggregator.alerts),
            "alerts_fired": sum(aggregator.fired.values()),
            "dumps": dict(dump_trigger.dumped),
            "rings": {
                recorder.name: {
                    "spans": len(recorder.spans),
                    "samples": len(recorder.samples),
                    "faults": len(recorder.faults),
                } for recorder in recorders},
        }
    if autoscale:
        report["autoscaler"] = {
            "deaths": manager.restart_stats["deaths"],
            "policy_respawns": manager.restart_stats["respawns"],
            "clients": len(manager.clients),
            "ready": manager.ready_count(),
            "servings_built": serving_counter[0],
        }

    # -- telemetry snapshot ---------------------------------------------
    metrics_after = _counter_series(default_registry().snapshot(),
                                    _TELEMETRY_FAMILIES)
    metric_deltas = {
        key: value - metrics_before.get(key, 0)
        for key, value in sorted(metrics_after.items())
        if value - metrics_before.get(key, 0)}
    report["telemetry"] = {
        "metrics": metric_deltas,
        "spans": {name: {"count": stats["count"],
                         "total_ms": round(stats["total_s"] * 1000.0, 2),
                         "mean_ms": round(stats["mean_s"] * 1000.0, 3)}
                  for name, stats in trc.stats().items()},
    }
    if not tracer_was_enabled:
        trc.disable()

    # -- teardown (serving1 already crashed; leave its corpse be) --------
    if aggregator is not None:
        aggregator.stop()
    if publisher is not None:
        publisher.stop()
    for recorder in recorders:
        recorder.close()
    caller.stop()
    call_rt.terminate()
    if autoscaler is not None:
        autoscaler.stop()
    if manager is not None:
        manager.stop()
    for index, (serve_rt, pipeline) in enumerate(servings):
        if index == 0:
            continue                    # the crashed corpse
        pipeline.stop()
        serve_rt.terminate()
    if peer and servings[0][0].peer is not None:
        # the corpse's peer host: channels are dead, but unregister its
        # endpoint so repeated in-process runs don't accumulate entries
        servings[0][0].peer.close()
    if manager_rt is not None:
        manager_rt.terminate()
    registrar_rt.terminate()
    if own_tmpdir is not None:
        shutil.rmtree(own_tmpdir, ignore_errors=True)
    return report


def _tenant_counter(registry, family: str, tenant: str) -> int:
    """Sum one admission counter family across all series of a tenant."""
    return sum(metric.value
               for labels, metric in registry.series(family)
               if labels.get("tenant") == tenant)


def run_tenant_soak(seed: int = 11, polite_frames: int = 6,
                    flood_frames: int = 24,
                    polite_interval: float = 0.5,
                    flood_interval: float = 0.02,
                    service_time: float = 0.35,
                    inflight_limit: int = 2,
                    flood_budget: int = 6,
                    frame_deadline: float = 5.0,
                    horizon: float = 30.0) -> dict:
    """Per-tenant fair-queuing acceptance: a flooding tenant
    slams a slow serving pipeline while a polite tenant keeps its
    steady cadence.  The admission gate's weighted DRR queue must shed
    ONLY the flooder's overflow (newest-first, within its own budget)
    while the polite tenant — higher priority tier — keeps a
    deadline-met fraction of 1.0.  The per-tenant admission_* counters
    in the report are the proof; deterministic on a VirtualClock.

    The fleet health plane rides the same scenario: the
    serving runtime publishes metrics snapshots, a HealthAggregator
    burns an admission-shed error budget (ratio rule, multi-window),
    and an Autoscaler reads windowed hop-p95 from the series store.
    With the flood on, the burn-rate alert fires and the autoscaler's
    windowed signals drive a scale-up; with flood_frames=0 (the polite
    baseline), ZERO alerts fire — shed deltas over the window are the
    evidence, so cumulative counters from earlier scenarios in the
    same process cannot false-alarm."""
    from ..autoscaler import Autoscaler, ScalePolicy
    from ..event import EventEngine, VirtualClock
    from ..observe import (
        HealthAggregator, MetricsPublisher, SLORule, default_registry)
    from ..ops.admission import (
        AdmissionGate, TenantFairQueue, TenantPolicy)
    from ..pipeline import (
        DEFERRED, Frame, FrameOutput, Pipeline, PipelineElement,
        parse_pipeline_definition)
    from ..process import ProcessRuntime
    from ..registrar import Registrar
    from ..share import ServicesCache

    wall_start = time.monotonic()
    registry = default_registry()
    before = {
        (family, tenant): _tenant_counter(registry, family, tenant)
        for family in ("admission_admitted_total", "admission_shed_total",
                       "admission_rejected_total")
        for tenant in ("polite", "flood")}
    engine = EventEngine(VirtualClock())

    def make_runtime(name):
        return ProcessRuntime(name=name, engine=engine).initialize()

    class PE_SlowSink(PipelineElement):
        """Defers every frame for `service_time` virtual seconds — the
        stand-in for a batched device program, so admitted frames HOLD
        their inflight credit and the fair queue actually backs up."""

        def process_frame(self, frame: Frame, value=None, **_):
            pipeline = self.pipeline
            name = self.definition.name
            self.runtime.event.add_oneshot_handler(
                lambda: pipeline.post("resume_frame", frame, name,
                                      {"echo": value}),
                service_time)
            return FrameOutput(True, DEFERRED)

    registrar_rt = make_runtime("registrar")
    Registrar(registrar_rt)
    _settle(engine, 3.0)

    serve_rt = make_runtime("tenant_serving")
    gate = AdmissionGate(
        queue=TenantFairQueue(
            policies={
                "polite": TenantPolicy(weight=1.0, tier=0,
                                       queue_budget=polite_frames + 2),
                "flood": TenantPolicy(weight=1.0, tier=1,
                                      queue_budget=flood_budget),
            },
            metrics_labels={"pipeline": "tenant_serve"}),
        inflight_limit=inflight_limit,
        metrics_labels={"pipeline": "tenant_serve"})
    serving = Pipeline(
        serve_rt, parse_pipeline_definition({
            "version": 0, "name": "tenant_serve", "runtime": "python",
            "graph": ["(PE_SlowSink)"],
            "elements": [
                {"name": "PE_SlowSink", "input": [{"name": "value"}],
                 "output": [{"name": "echo"}]},
            ],
        }),
        element_classes={"PE_SlowSink": PE_SlowSink},
        auto_create_streams=True, stream_lease_time=30.0,
        admission=gate)

    # fleet health plane over the scenario: snapshots out of
    # the serving runtime, burn-rate alerting + a windowed autoscaler
    # on the registrar runtime
    tenant_publisher = MetricsPublisher(serve_rt, interval=0.5)
    aggregator = HealthAggregator(
        registrar_rt, rules=[SLORule(
            name="admission-shed-burn", kind="ratio",
            bad="admission_shed_total", good="admission_admitted_total",
            objective=0.99, pairs=((8.0, 2.0, 2.0),),
            description="admission shed rate burning the 1% error "
                        "budget in both windows")],
        interval=0.5, window=60.0)

    class _StubFleet:
        """Counting actuator: the scenario proves the SIGNALS react;
        real spawn mechanics have their own soak (--autoscale)."""

        def __init__(self, count):
            self.clients = {index: object() for index in range(count)}
            self.scale_ups = 0

        def scale_to(self, count):
            delta = count - len(self.clients)
            if delta > 0:
                self.scale_ups += 1
                for index in range(len(self.clients), count):
                    self.clients[index] = object()
            elif delta < 0:
                for _ in range(-delta):
                    self.clients.popitem()
            return delta

        def ready_count(self):
            return len(self.clients)

    fleet = _StubFleet(1)
    # the windowed signal that reacts here is the admission fair
    # queue's own depth: the flood backs it up within the first virtual
    # second, the serving snapshot carries the gauge, and the
    # autoscaler's series store holds it in-window long after the
    # burst drains (hop p95 is wall-clock and useless on a virtual
    # scenario; queue depth is engine-deterministic)
    autoscaler = Autoscaler(
        registrar_rt, name="tenant_scaler", manager=fleet,
        policy=ScalePolicy(min_clients=1, max_clients=3,
                           mailbox_depth_up=1e9, batch_wait_up=1e9,
                           hop_p95_up=1e9, queue_depth_up=3.0,
                           hysteresis=2, cooldown=60.0, window=10.0),
        interval=0.5)

    call_rt = make_runtime("tenant_caller")
    caller = Pipeline(
        call_rt, parse_pipeline_definition({
            "version": 0, "name": "tenant_call", "runtime": "python",
            "graph": ["(remote_sink)"],
            "elements": [
                {"name": "remote_sink", "input": [{"name": "value"}],
                 "output": [{"name": "echo"}],
                 "deploy": {"remote": {"service_filter":
                                       {"name": "tenant_serve"}}}},
            ],
        }),
        services_cache=ServicesCache(call_rt), stream_lease_time=0,
        frame_deadline=frame_deadline)
    _settle(engine, 2.0)
    if not caller.remote_elements_ready():
        raise RuntimeError("tenant soak: discovery failed")

    base = engine.clock.now()
    posted: dict[str, float] = {}        # stream_id -> post time
    completed: dict[str, float] = {}     # stream_id -> completion time
    caller.add_frame_handler(
        lambda frame: completed.setdefault(frame.stream_id,
                                           engine.clock.now()))

    def post(tenant, index, value):
        stream_id = f"{tenant}-{index}"
        caller.create_stream(stream_id, lease_time=0,
                             parameters={"tenant": tenant,
                                         "tier": 0 if tenant == "polite"
                                         else 1})
        caller.post("process_frame", stream_id, {"value": value})
        posted[stream_id] = engine.clock.now()

    next_polite = next_flood = 0
    deadline = base + horizon
    while engine.clock.now() < deadline:
        now = engine.clock.now() - base
        while next_flood < flood_frames and \
                now >= next_flood * flood_interval:
            post("flood", next_flood, float(next_flood))
            next_flood += 1
        while next_polite < polite_frames and \
                now >= next_polite * polite_interval:
            post("polite", next_polite, float(next_polite))
            next_polite += 1
        while engine.step():
            pass
        pending = [sid for sid in posted
                   if sid not in completed and sid in caller.streams]
        if next_polite >= polite_frames and \
                next_flood >= flood_frames and not pending:
            break
        engine.clock.advance(0.05)
    _settle(engine, 1.0)

    def tenant_block(tenant):
        ids = [sid for sid in posted if sid.startswith(tenant)]
        met = sum(1 for sid in ids
                  if sid in completed
                  and completed[sid] - posted[sid] <= frame_deadline)
        deltas = {
            family.split("_")[1]: _tenant_counter(registry, family,
                                                  tenant)
            - before[(family, tenant)]
            for family in ("admission_admitted_total",
                           "admission_shed_total",
                           "admission_rejected_total")}
        return {
            "posted": len(ids),
            "completed": sum(1 for sid in ids if sid in completed),
            "deadline_met_fraction":
                round(met / len(ids), 4) if ids else 1.0,
            "admitted": deltas["admitted"],
            "shed": deltas["shed"],
            "rejected": deltas["rejected"],
        }

    report = {
        "seed": seed,
        "polite": tenant_block("polite"),
        "flood": tenant_block("flood"),
        "serving_recovery": {
            key: serving.recovery_stats[key]
            for key in ("admission_shed", "shed_early",
                        "deadline_rejected")},
        "queue_depth_final": gate.queue.depth(),
        "inflight_final": gate.inflight,
        "health": {
            "alerts": dict(aggregator.alerts),
            "alerts_fired": sum(aggregator.fired.values()),
            "autoscaler": {
                "scale_ups": fleet.scale_ups,
                "clients": len(fleet.clients),
                "signals": autoscaler.signals(),
            },
        },
        "virtual_seconds": round(engine.clock.now() - base, 2),
        "wall_seconds": round(time.monotonic() - wall_start, 2),
    }

    autoscaler.stop()
    aggregator.stop()
    tenant_publisher.stop()
    caller.stop()
    call_rt.terminate()
    serving.stop()
    serve_rt.terminate()
    registrar_rt.terminate()
    return report


def run_migrate_soak(seed: int = 11, sessions: int = 2,
                     victim_new: int = 32, preset: str = "tiny",
                     device=None, params=None) -> dict:
    """Serving-plane fault-tolerance acceptance: two paged
    serving runtimes on one wire.  Conversations pin their KV under
    session handles on A; a SEEDED preemption lands mid-conversation,
    so the chaos seam alerts, drains, and checkpoints the in-flight
    victim at a round boundary.  The evacuated descriptor resumes on
    the standby B and the stitched output must be BIT-IDENTICAL to a
    never-preempted decode (zero lost requests).  A then migrates every
    pinned session to B over chunk-streamed kv_transfer envelopes —
    turn 2 on B is a pure prefix hit (zero re-prefill) — and the leak
    audit walks A to zero: no table entries, no cache nodes, no live
    pool blocks, no pending transfers on either side.

    preset: the Llama preset ("tiny" has head dim 16, which the card's
    paged kernel refuses: run "1b" there, whose preset is f32, so the
    stitched output is held bit for bit).  device: the decoders'; None
    means the card (raises when there is none).  params: the weights
    (default: llama_init seeded 0 on the device)."""
    import dataclasses
    import random
    from types import SimpleNamespace

    import torch

    from .. import resolve_device
    from ..event import EventEngine
    from ..models.llama import (LLAMA_PRESETS, llama_greedy_decode,
                                llama_init)
    from ..process import ProcessRuntime
    from ..serving import ContinuousDecoder, PrefixKVCache
    from ..serving_chaos import ChaosDecoder
    from ..serving_disagg import SessionMigrator
    from ..state.sessions import SessionTable
    from ..transport.memory import MemoryBroker, MemoryMessage

    device = resolve_device(device)
    wall_start = time.monotonic()
    rng = random.Random(seed)
    config = dataclasses.replace(LLAMA_PRESETS[preset], max_seq_len=96)
    if params is None:
        params = llama_init(torch.Generator(device=device).manual_seed(0),
                            config, device=device)
    block = 8

    def oracle(prompt, count):
        out = llama_greedy_decode(
            params, config,
            torch.tensor([prompt], dtype=torch.int32, device=device),
            max_tokens=count)
        return [int(t) for t in out[0].tolist()]

    # REAL clock: drains, chunk transfers, and the chaos watchdog all
    # run on wall time here — this is the scenario the virtual-clock
    # unit tests cannot exercise
    engine = EventEngine()
    broker = MemoryBroker()
    seq = [0]

    def make_side(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return MemoryMessage(
                on_message=on_message, broker=broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain, client_id=name)
        runtime = ProcessRuntime(name=name, engine=engine,
                                 transport_factory=factory).initialize()
        seq[0] += 1
        tag = f"migsoak{seed}_{seq[0]}"
        cache = PrefixKVCache(block_tokens=block, max_bytes=64 << 20,
                              name=tag)
        decoder = ContinuousDecoder(
            params, config, paged_kv=True, kv_block=block,
            prefix_cache=cache, max_slots=4, prefill_buckets=(64,),
            steps_per_sync=4, name=tag, device=device)
        table = SessionTable(
            SimpleNamespace(runtime=runtime,
                            topic_path=runtime.topic_path),
            num_shards=1)
        migrator = SessionMigrator(runtime, cache, table=table,
                                   name=tag, chunk_blocks=2,
                                   transfer_timeout=30.0)
        return SimpleNamespace(rt=runtime, cache=cache,
                               decoder=decoder, table=table,
                               mig=migrator)

    a = make_side("migsoak_a")
    b = make_side("migsoak_b")
    alerts: list = []
    chaos = ChaosDecoder(a.decoder, name=f"migsoak{seed}")
    chaos.on_alert.append(lambda kind, detail: alerts.append(kind))
    # A pumps THROUGH the fault seam; B pumps clean
    engine.add_flatout_handler(chaos.pump)
    engine.add_flatout_handler(b.decoder.pump)

    def turn(side, rid, prompt, count, timeout=120.0):
        done = {}
        if not side.decoder.submit(rid, prompt, count,
                                   lambda rid, t: done.update({rid: t})):
            raise RuntimeError(f"migrate soak: {rid} refused")
        if not engine.run_until(lambda: rid in done, timeout=timeout):
            raise RuntimeError(f"migrate soak: {rid} timed out")
        return done[rid]

    def prompt_tokens(count):
        return [rng.randrange(1, 50) for _ in range(count)]

    # phase 1: conversations land on A; each finished turn pins its
    # chain under a session handle (41 prompt + 8 generated = 49
    # tokens -> exactly six full blocks of session KV)
    histories = {}
    for index in range(max(1, int(sessions))):
        sid = f"conv{index}"
        prompt = prompt_tokens(5 * block + 1)
        history = prompt + turn(a, f"{sid}.t1", prompt, block)
        leaf, kv_tokens = a.cache.session_store("default", sid, history)
        if not a.table.create("default", sid,
                              {"history": history, "kv": leaf or "",
                               "kv_tokens": kv_tokens}):
            raise RuntimeError(f"migrate soak: create {sid} shed")
        histories[sid] = (history, kv_tokens)
    blocks_pinned = sum(kv // block for _, kv in histories.values())

    # phase 2: the seeded kill — preemption fires a few rounds into
    # the victim's generation, the chaos seam escalates (alert +
    # drain), and the checkpointed victim evacuates as a descriptor
    victim_prompt = prompt_tokens(40)
    victim_done: dict = {}
    chaos.arm_preemption(at_round=chaos.round + 4)
    if not a.decoder.submit(
            "victim", victim_prompt, victim_new,
            lambda rid, t: victim_done.update({rid: t})):
        raise RuntimeError("migrate soak: victim refused")
    if not engine.run_until(lambda: a.decoder.drained, timeout=120.0):
        raise RuntimeError("migrate soak: drain never completed")
    chaos.disarm()
    evacuated = list(chaos.evacuated)
    # zero-loss ledger: the victim must come back exactly once, as an
    # evacuated descriptor whose degraded delivery also ran
    lost = 0 if (len(evacuated) == 1 and "victim" in victim_done) else 1
    partial = list(victim_done.get("victim", ()))

    # phase 3: resume on the standby — prompt + partial re-prefills on
    # B (prefix miss is fine; the KV migrates next) and the stitched
    # stream must equal the never-preempted oracle
    resume_parity = False
    if evacuated and len(partial) < victim_new:
        context = victim_prompt + partial
        out2 = turn(b, "victim.resume", context,
                    victim_new - len(partial))
        resume_parity = \
            partial + out2 == oracle(victim_prompt, victim_new)

    # phase 4: drain done, now evacuate the STATE — every pinned
    # session ships to B over the kv_migrate wire
    migrate_done: list = []
    offered = a.mig.migrate(b.mig.topic,
                            on_done=lambda m: migrate_done.append(m))
    if not engine.run_until(lambda: bool(migrate_done), timeout=60.0):
        raise RuntimeError("migrate soak: migration timed out")

    # phase 5: destination proof — the migrated chain is a pure
    # prefix hit, and a turn 2 on B continues bit-identically
    prefix_hits = []
    for sid, (history, kv_tokens) in histories.items():
        _, hit = b.cache.match("default", history[:kv_tokens])
        prefix_hits.append(hit)
    sid0, (history0, _) = next(iter(histories.items()))
    prompt2 = history0 + prompt_tokens(3)
    turn2_parity = turn(b, f"{sid0}.t2", prompt2, block) == \
        oracle(prompt2, block)

    # phase 6: the CONTROL-plane trigger — an autoscaler shrink
    # verdict must route through drain, never kill.  While the victim
    # fleet reports live slots and no drain budget is armed, the
    # shrink is REFUSED; arming drain_s lets the same verdict through,
    # and the manager drains B gracefully — the straggling in-flight
    # request checkpoints and degraded-delivers (zero loss), exactly
    # the silent drop this path exists to prevent
    from ..autoscaler import Autoscaler, ScalePolicy

    class _Fleet:
        def __init__(self):
            self.clients = {"a": object(), "b": object()}
            self.drains = 0

        def scale_to(self, count, drain_s=None):
            delta = count - len(self.clients)
            if delta < 0:
                if drain_s is not None:
                    self.drains += 1
                    b.decoder.drain(deadline=0.0)
                self.clients.popitem()
            return delta

        def ready_count(self):
            return len(self.clients)

    fleet = _Fleet()
    scaler = Autoscaler(a.rt, name=f"migsoak{seed}_as", manager=fleet,
                        policy=ScalePolicy(min_clients=1,
                                           max_clients=4),
                        interval=1000.0)        # timer parked
    straggler_done: dict = {}
    if not b.decoder.submit(
            "straggler", prompt_tokens(24), 64,
            lambda rid, t: straggler_done.update({rid: t})):
        raise RuntimeError("migrate soak: straggler refused")
    gauge_topic = f"{a.rt.namespace}/host/migsoak/0/metrics"
    a.rt.publish(gauge_topic, json.dumps({
        "topic_path": f"{a.rt.namespace}/host/migsoak",
        "snapshot": {"serving_active_slots": {
            "type": "gauge",
            "series": [{"labels": {}, "value": 1.0}]}}}))
    if not engine.run_until(lambda: scaler.live_slots() >= 1.0,
                            timeout=30.0):
        raise RuntimeError("migrate soak: slot gauge never landed")
    scaler._act(-1, "soak-shrink", engine.clock.now(), {})
    shrink_refused = len(fleet.clients) == 2 and fleet.drains == 0
    scaler.drain_s = 1.0
    scaler._act(-1, "soak-shrink", engine.clock.now(), {})
    if not engine.run_until(lambda: b.decoder.drained, timeout=60.0):
        raise RuntimeError("migrate soak: autoscaler drain hung")
    scaler.stop()
    autoscaler_block = {
        "shrink_refused_without_drain": shrink_refused,
        "drains": fleet.drains,
        "clients": len(fleet.clients),
        "straggler_delivered": "straggler" in straggler_done,
        "straggler_partial_tokens":
            len(straggler_done.get("straggler", ())),
    }

    # phase 7: leak audit — the source walks to ZERO
    a.cache.purge(demote=False)
    leaks = {
        "source_sessions": len(a.table),
        "source_cache_nodes": len(a.cache),
        "source_pool_blocks": a.decoder.pool.used_blocks(),
        "pending_source": a.mig.pending_count(),
        "pending_dest": b.mig.pending_count(),
    }

    report = {
        "seed": seed,
        "sessions": len(histories),
        "alerts": alerts,
        "chaos": {key: chaos.stats[key]
                  for key in ("rounds", "preemptions", "alerts",
                              "drains")},
        "victim": {
            "evacuated": len(evacuated),
            "partial_tokens": len(partial),
            "resume_parity": resume_parity,
            "lost_requests": lost,
        },
        "migration": {
            "offered": offered,
            "migrated": a.mig.stats["migrated"],
            "shipped_blocks": a.mig.stats["shipped_blocks"],
            "handle_blocks": a.mig.stats["handle_blocks"],
            "chunks": a.mig.stats["chunks"],
            "installed_blocks": b.mig.stats["installed_blocks"],
            "dropped_chunks": b.mig.stats["dropped_chunks"],
            "refused": b.mig.stats["refused"],
            "blocks_pinned": blocks_pinned,
        },
        "dest": {
            "prefix_hit_tokens": min(prefix_hits) if prefix_hits else 0,
            "turn2_parity": turn2_parity,
        },
        "autoscaler": autoscaler_block,
        "leaks": leaks,
        "wall_seconds": round(time.monotonic() - wall_start, 2),
    }
    report["ok"] = (
        lost == 0 and resume_parity and turn2_parity
        and alerts == ["preemption"]
        and report["migration"]["migrated"] == len(histories)
        and report["migration"]["shipped_blocks"] == blocks_pinned
        and min(prefix_hits or [0]) == 5 * block + block
        and shrink_refused and fleet.drains == 1
        and autoscaler_block["straggler_delivered"]
        and all(value == 0 for value in leaks.values()))

    for side in (a, b):
        side.mig.stop()
        side.table.stop()
        side.rt.terminate()
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="chaos soak: speech pipeline across two runtimes "
                    "under seeded drops, a partition, and a kill")
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--drop", type=float, default=0.15,
                        help="per-delivery drop probability on data "
                             "topics")
    parser.add_argument("--retries", type=int, default=6)
    parser.add_argument("--horizon", type=float, default=60.0,
                        help="virtual-seconds budget")
    parser.add_argument("--max-lost", type=int, default=0,
                        help="frame-loss policy: exit 1 beyond this")
    parser.add_argument("--peer", action="store_true",
                        help="run the data plane over negotiated peer "
                             "channels (chaos-wrapped), including a "
                             "mid-stream channel kill")
    parser.add_argument("--mqtt", action="store_true",
                        help="run every runtime over MQTTMessage "
                             "against the loopback paho broker")
    parser.add_argument("--autoscale", action="store_true",
                        help="bring the serving fleet up through "
                             "LifeCycleManager + Autoscaler: the "
                             "mid-run kill is repaired by the "
                             "autoscaler's below-floor verdict")
    parser.add_argument("--tenants", action="store_true",
                        help="run the flooding-tenant admission "
                             "scenario instead of the chaos soak")
    parser.add_argument("--migrate", action="store_true",
                        help="run the serving fault-tolerance "
                             "scenario: seeded preemption "
                             "mid-conversation, checkpoint-evacuate-"
                             "resume on the standby, then session KV "
                             "migration over the kv_transfer wire "
                             "with a zero-leak source audit")
    parser.add_argument("--health-dump-dir", default=None,
                        metavar="DIR",
                        help="arm the fleet health plane: SLO "
                             "burn-rate alerting over windowed series "
                             "+ a flight-recorder dump into DIR on "
                             "breach")
    parser.add_argument("--device", default=None,
                        help="where the speech soak's ComputeRuntimes "
                             "and the migrate soak's decoders run "
                             "(default: the card)")
    parser.add_argument("--preset", default="tiny",
                        help="the migrate soak's Llama preset (the "
                             "card's paged kernel takes head dim 64 or "
                             "128: 1b there)")
    args = parser.parse_args(argv)
    if args.migrate:
        report = run_migrate_soak(seed=args.seed, preset=args.preset,
                                  device=args.device)
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    if args.tenants:
        report = run_tenant_soak(seed=args.seed)
        print(json.dumps(report, indent=2))
        ok = report["polite"]["shed"] == 0 and \
            report["flood"]["shed"] > 0 and \
            report["polite"]["deadline_met_fraction"] >= 0.99
        return 0 if ok else 1
    report = run_soak(seed=args.seed, frames=args.frames, drop=args.drop,
                      retries=args.retries, horizon=args.horizon,
                      peer=args.peer, mqtt=args.mqtt,
                      autoscale=args.autoscale,
                      health_dump_dir=args.health_dump_dir,
                      device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["frames_lost"] <= args.max_lost else 1


if __name__ == "__main__":
    sys.exit(main())
