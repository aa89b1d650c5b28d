"""The port's autoscaler against the JAX package's: the 13 cases of
tests/test_autoscaler.py run on both packages on a virtual clock, and
each must give the same signals, the same scale actions and the same
sequence of decisions with their reasons (signal extraction, staleness,
hysteresis, the dead band, the floor, counted decisions, the trend and
the windowed veto, the KV memory signals, and floor restoration through
a real LifeCycleManager after a crash).  serving_disagg's
two_pool_autoscalers is held against JAX's the same way, the decode
pool's shrink drained (scale_to with drain_s)."""

import json

import pytest

from aiko_services_tpu import serving_disagg as JD
from aiko_services_tpu_torch import serving_disagg as TD

from torch_ops_host import Host, both


class StubManager:
    """A LifeCycleManager stand-in that just tracks the fleet size."""

    def __init__(self, count=1):
        self.clients = {str(i): object() for i in range(count)}
        self._next = count
        self.actions = []

    def scale_to(self, count, drain_s=None):
        delta = count - len(self.clients)
        self.actions.append(delta if drain_s is None else (delta, drain_s))
        while len(self.clients) < count:
            self.clients[str(self._next)] = object()
            self._next += 1
        while len(self.clients) > count:
            self.clients.popitem()
        return delta

    def ready_count(self):
        return len(self.clients)


def snapshot_payload(topic_path, mailbox=0.0, batch_wait=0.0,
                     hop_counts=None, occupancy=None, host_pressure=None,
                     prefill_queue=None, active_slots=None):
    snapshot = {}
    if mailbox:
        snapshot["event_mailbox_depth"] = {
            "type": "gauge", "series": [{"labels": {}, "value": mailbox}]}
    if occupancy is not None:
        snapshot["kv_pool_occupancy"] = {
            "type": "gauge",
            "series": [{"labels": {"pool": "p"}, "value": occupancy}]}
    if host_pressure is not None:
        snapshot["kv_ledger_host_pressure"] = {
            "type": "gauge",
            "series": [{"labels": {"ledger": "lg"},
                        "value": host_pressure}]}
    if prefill_queue is not None:
        snapshot["prefill_queue_depth"] = {
            "type": "gauge",
            "series": [{"labels": {}, "value": prefill_queue}]}
    if active_slots is not None:
        snapshot["serving_active_slots"] = {
            "type": "gauge",
            "series": [{"labels": {}, "value": active_slots}]}
    if batch_wait:
        snapshot["batch_mean_wait_ms"] = {
            "type": "gauge", "series": [{"labels": {}, "value": batch_wait}]}
    if hop_counts:
        snapshot["pipeline_hop_seconds"] = {
            "type": "histogram",
            "series": [{"labels": {}, "bounds": [0.1, 0.5, 2.0],
                        "counts": hop_counts, "sum": 1.0,
                        "count": sum(hop_counts)}]}
    return json.dumps({"topic_path": topic_path, "snapshot": snapshot})


def publish_snapshot(rt, process, **kwargs):
    topic_path = f"{rt.namespace}/host/{process}"
    rt.publish(f"{topic_path}/0/metrics",
               snapshot_payload(topic_path, **kwargs))


def watch(autoscaler) -> list:
    """Record the autoscaler's decisions (action, reason) in order."""
    decisions = []
    count = autoscaler._count_decision

    def counted(action, reason):
        decisions.append((action, reason))
        count(action, reason)

    autoscaler._count_decision = counted
    return decisions


def scaler(host, rt, name, manager, policy=None, interval=1.0, **kwargs):
    m = host.m.autoscaler
    autoscaler = m.Autoscaler(rt, name=name, manager=manager,
                              policy=policy and m.ScalePolicy(**policy),
                              interval=interval, **kwargs)
    return autoscaler, watch(autoscaler)


def hysteresis_policy(**kwargs):
    return dict(dict(min_clients=1, max_clients=4, mailbox_depth_up=64.0,
                     mailbox_depth_down=4.0, hop_p95_up=1e9,
                     batch_wait_up=1e9, hysteresis=3, cooldown=5.0),
                **kwargs)


def memory_policy(**kwargs):
    return dict(dict(min_clients=1, max_clients=4, mailbox_depth_up=1e9,
                     hop_p95_up=1e9, batch_wait_up=1e9, hysteresis=2,
                     cooldown=30.0), **kwargs)


# -- signals ---------------------------------------------------------------------

def test_worst_case_across_processes_and_families():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("sig_rt")
        autoscaler, _ = scaler(host, rt, "sig", StubManager(),
                               interval=1000.0)
        publish_snapshot(rt, "p1", mailbox=10, batch_wait=5)
        publish_snapshot(rt, "p2", mailbox=3, batch_wait=40,
                         hop_counts=[0, 1, 0, 0])
        host.settle_virtual(0.2)
        signals = autoscaler.signals()
        autoscaler.stop()
        return signals
    signals = both(scenario)
    assert signals["mailbox_depth"] == 10 and signals["batch_wait"] == 40
    assert signals["hop_p95"] == pytest.approx(0.5)


def test_stale_snapshots_stop_voting():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("stale_rt")
        autoscaler, _ = scaler(host, rt, "stale", StubManager(),
                               interval=1000.0)
        publish_snapshot(rt, "p1", mailbox=500)
        host.settle_virtual(0.2)
        seen = [autoscaler.signals()["mailbox_depth"]]
        host.engine.clock.advance(60.0)
        seen.append(autoscaler.signals()["mailbox_depth"])
        autoscaler.stop()
        return seen
    assert both(scenario) == [500, 0]


# -- hysteresis --------------------------------------------------------------------

def test_sustained_overload_scales_up_once():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("hys_rt")
        manager = StubManager(1)
        autoscaler, decisions = scaler(host, rt, "hys_up", manager,
                                       hysteresis_policy())
        publish_snapshot(rt, "p1", mailbox=200)
        host.settle_virtual(10.0)
        autoscaler.stop()
        return manager.actions, decisions
    actions, decisions = both(scenario)
    assert actions.count(1) >= 1 and all(a >= 0 for a in actions)
    assert ("up", "overload") in decisions


def test_threshold_straddling_step_does_not_flap():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("flap_rt")
        manager = StubManager(2)
        autoscaler, decisions = scaler(host, rt, "flap", manager,
                                       hysteresis_policy())
        for _ in range(12):
            publish_snapshot(rt, "p1", mailbox=30)
            host.settle_virtual(1.0)
        for i in range(12):
            publish_snapshot(rt, "p1", mailbox=200 if i % 2 else 30)
            host.settle_virtual(1.0)
        autoscaler.stop()
        return manager.actions, len(manager.clients), decisions
    actions, clients, decisions = both(scenario)
    assert actions == [] and clients == 2
    assert set(decisions) == {("hold", "dead-band")}


def test_sustained_quiet_scales_down_to_floor():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("down_rt")
        manager = StubManager(3)
        autoscaler, decisions = scaler(host, rt, "down", manager,
                                       hysteresis_policy(cooldown=1.5))
        publish_snapshot(rt, "p1", mailbox=1)
        host.settle_virtual(20.0)
        autoscaler.stop()
        return manager.actions, len(manager.clients), decisions
    actions, clients, decisions = both(scenario)
    assert clients == 1 and all(a == -1 for a in actions)
    assert ("hold", "at-min") in decisions


def test_down_step_never_undershoots_the_floor():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("step_rt")
        manager = StubManager(3)
        autoscaler, decisions = scaler(
            host, rt, "step", manager,
            hysteresis_policy(min_clients=2, cooldown=1.5, step=2))
        publish_snapshot(rt, "p1", mailbox=1)
        host.settle_virtual(20.0)
        autoscaler.stop()
        return manager.actions, len(manager.clients), decisions
    actions, clients, _ = both(scenario)
    assert clients == 2 and actions == [-1]


def test_decisions_are_counted():
    def scenario(package):
        host = Host(package)
        registry = host.m.metrics.default_registry()

        def up_count():
            return sum(m.value for labels, m in registry.series(
                "autoscaler_decisions_total")
                if labels.get("autoscaler") == "cnt"
                and labels.get("action") == "up")

        rt = host.runtime("cnt_rt")
        before = up_count()
        autoscaler, decisions = scaler(host, rt, "cnt", StubManager(1),
                                       hysteresis_policy())
        publish_snapshot(rt, "p1", mailbox=200)
        host.settle_virtual(4.0)
        autoscaler.stop()
        return up_count() - before, decisions
    counted, decisions = both(scenario)
    assert counted >= 1 and counted == decisions.count(("up", "overload"))


# -- windowed signals ----------------------------------------------------------------

def test_trend_scales_up_before_level_threshold():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("trend_rt")
        manager = StubManager(1)
        autoscaler, decisions = scaler(
            host, rt, "trend", manager,
            dict(min_clients=1, max_clients=4, mailbox_depth_up=1e9,
                 hop_p95_up=1e9, batch_wait_up=1e9, mailbox_trend_up=5.0,
                 hysteresis=2, cooldown=30.0))
        for depth in (0, 10, 20, 30):
            publish_snapshot(rt, "p1", mailbox=depth or 0.001)
            host.settle_virtual(1.0)
        host.settle_virtual(2.0)
        trend = autoscaler.signals()["mailbox_trend"]
        autoscaler.stop()
        return manager.actions, trend, decisions
    actions, trend, _ = both(scenario)
    assert actions.count(1) >= 1 and trend >= 5.0


def test_spike_inside_window_blocks_shrink():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("veto_rt")
        manager = StubManager(2)
        autoscaler, decisions = scaler(
            host, rt, "veto", manager,
            dict(min_clients=1, max_clients=4, mailbox_depth_up=1e9,
                 hop_p95_up=1e9, batch_wait_up=1e9, window=10.0,
                 hysteresis=2, cooldown=0.5))
        publish_snapshot(rt, "p1", mailbox=200)
        host.settle_virtual(1.0)
        for _ in range(6):
            publish_snapshot(rt, "p1", mailbox=1)
            host.settle_virtual(1.0)
        during = len(manager.clients)
        for _ in range(10):
            publish_snapshot(rt, "p1", mailbox=1)
            host.settle_virtual(1.0)
        autoscaler.stop()
        return during, len(manager.clients), manager.actions, decisions
    during, after, _, _ = both(scenario)
    assert (during, after) == (2, 1)


# -- KV memory pressure ----------------------------------------------------------------

def test_pool_occupancy_scales_up():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("occ_rt")
        manager = StubManager(1)
        autoscaler, decisions = scaler(
            host, rt, "occ", manager, memory_policy(pool_occupancy_up=0.85))
        publish_snapshot(rt, "p1", occupancy=0.95)
        host.settle_virtual(5.0)
        occupancy = autoscaler.signals()["pool_occupancy"]
        snap = host.m.metrics.default_registry().snapshot()
        exported = ("autoscaler_signal_pool_occupancy" in snap,
                    "autoscaler_signal_host_pressure" in snap)
        autoscaler.stop()
        return manager.actions, occupancy, exported, decisions
    actions, occupancy, exported, _ = both(scenario)
    assert occupancy == pytest.approx(0.95) and actions.count(1) >= 1
    assert exported == (True, True)


def test_host_pressure_scales_up_and_vetoes_shrink():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("hp_rt")
        manager = StubManager(1)
        autoscaler, decisions = scaler(
            host, rt, "hp", manager,
            memory_policy(host_pressure_up=0.8, host_pressure_down=0.25,
                          window=5.0, cooldown=0.5))
        publish_snapshot(rt, "p1", host_pressure=0.9)
        host.settle_virtual(5.0)
        grown = len(manager.clients)
        for _ in range(8):
            publish_snapshot(rt, "p1", host_pressure=0.5)
            host.settle_virtual(1.0)
        warm = len(manager.clients)
        for _ in range(12):
            publish_snapshot(rt, "p1", host_pressure=0.05)
            host.settle_virtual(1.0)
        autoscaler.stop()
        return grown, warm, len(manager.clients), decisions
    grown, warm, cold, _ = both(scenario)
    assert grown > 1 and warm == grown and cold == 1


def test_unarmed_memory_signals_never_scale():
    def scenario(package):
        host = Host(package)
        rt = host.runtime("unarm_rt")
        manager = StubManager(1)
        autoscaler, decisions = scaler(host, rt, "unarm", manager,
                                       memory_policy())
        publish_snapshot(rt, "p1", occupancy=1.0, host_pressure=1.0)
        host.settle_virtual(5.0)
        autoscaler.stop()
        return manager.actions, decisions
    actions, _ = both(scenario)
    assert actions.count(1) == 0


# -- floor restoration through a real LifeCycleManager -----------------------------------

def test_crash_respawns_through_lifecycle_manager():
    def scenario(package):
        host = Host(package)
        m = host.m
        manager_rt = host.runtime("floor_mgr")
        spawned = {}

        def spawner(client_id, manager_topic):
            rt = host.runtime(f"floor_w{client_id}")
            m.lifecycle.LifeCycleClient(rt, f"floor_client_{client_id}",
                                        manager_topic, client_id)
            spawned[client_id] = rt
            return rt

        manager = m.lifecycle.LifeCycleManager(manager_rt, "floor_lcm",
                                               spawner)
        autoscaler, decisions = scaler(
            host, manager_rt, "floor", manager,
            dict(min_clients=2, max_clients=3, mailbox_depth_up=1e9,
                 hop_p95_up=1e9, batch_wait_up=1e9, cooldown=1.0),
            interval=0.5)
        manager.create_clients(2)
        host.settle_virtual(3.0)
        ready = [manager.ready_count()]
        spawned[sorted(spawned)[0]].message.crash()
        host.settle_virtual(4.0)
        ready.append(manager.ready_count())
        autoscaler.stop()
        manager.stop()
        return ready, len(spawned), decisions
    ready, spawned, decisions = both(scenario)
    assert ready == [2, 2] and spawned == 3
    assert ("up", "below-floor") in decisions


# -- the two pools' autoscalers -------------------------------------------------------------

def itl_snapshot(package, topic_path, values):
    sketch = Host(package).m.sketch.Sketch("serving_itl_seconds")
    for value in values:
        sketch.observe(value)
    return json.dumps({"topic_path": topic_path, "snapshot": {
        "serving_itl_seconds": {"type": "sketch", "series": [{
            "labels": {"decoder": "d"}, **sketch.to_dict()}]}}})


def test_two_pool_autoscalers_equal_jax():
    """Each pool scales on its own signal only: a prefill backlog grows
    the prefill pool and not the decode pool; an ITL breach grows the
    decode pool; a quiet fleet shrinks both, the decode pool's shrink
    drained; the default policies equal JAX's."""
    def scenario(package):
        host = Host(package)
        disagg = {"jax": JD, "torch": TD}[package]
        rt = host.runtime("pools")
        prefill_pool, decode_pool = StubManager(1), StubManager(1)
        prefill, decode = disagg.two_pool_autoscalers(
            rt, prefill_pool, decode_pool, interval=1.0)
        decode.drain_s = 2.0
        decisions = {"prefill": watch(prefill), "decode": watch(decode)}
        policies = (prefill.policy, decode.policy)
        names = (prefill.name, decode.name)
        for _ in range(5):
            publish_snapshot(rt, "prefill0", prefill_queue=20)
            host.settle_virtual(1.0)
        for step in range(6):
            rt.publish("test/host/decode0/0/metrics",
                       itl_snapshot(package, "test/host/decode0",
                                    [0.2 + 0.01 * i for i in
                                     range(8 * (step + 1))]))
            host.settle_virtual(1.0)
        host.settle_virtual(60.0)
        for _ in range(40):
            publish_snapshot(rt, "prefill0", prefill_queue=0,
                             active_slots=0)
            host.settle_virtual(1.0)
        prefill.stop()
        decode.stop()
        return (names, repr(policies), prefill_pool.actions,
                decode_pool.actions, decisions)
    names, _, prefill_actions, decode_actions, decisions = both(scenario)
    assert names == ("prefill-pool", "decode-pool")
    assert 1 in prefill_actions and 1 in decode_actions
    assert ("down", "underload") in decisions["decode"]
    assert any(isinstance(a, tuple) and a[1] == 2.0 for a in decode_actions)
