"""Process supervision, the lifecycle fleet, the recorder and storage on
the port, held against the JAX package: the scenarios of
tests/test_services.py and tests/test_logging.py on both packages —
seeded restart delays call for call, child processes spawned, exiting,
killed, respawned under a RestartPolicy and given up on as a crash loop;
the LifeCycleManager's handshake, EC-mirrored shares, deletion, handshake
timeout and the replacement of dead clients; the recorder's log, metrics
and alert rings and its persistence to storage; storage commands and
the discover-call-respond request; an actor's log records reaching the
recorder over the transport.  Runtimes of one package share one broker
and one engine under a virtual clock, with the same names."""

import json
import os
import sys
import time

import pytest

from aiko_services_tpu import actor as JA
from aiko_services_tpu import event as JE
from aiko_services_tpu import lifecycle as JL
from aiko_services_tpu import process_manager as JPM
from aiko_services_tpu import recorder as JRec
from aiko_services_tpu import storage as JS
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu.service import ServiceFilter as JServiceFilter
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu.utils import generate as jgenerate
from aiko_services_tpu_torch import actor as TA
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import lifecycle as TL
from aiko_services_tpu_torch import process_manager as TPM
from aiko_services_tpu_torch import recorder as TRec
from aiko_services_tpu_torch import storage as TS
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.service import ServiceFilter as TServiceFilter
from aiko_services_tpu_torch.transport import memory as TM
from aiko_services_tpu_torch.utils import TransportLoggingHandler
from aiko_services_tpu_torch.utils import generate as tgenerate
from aiko_services_tpu_torch.utils.configuration import (
    BootstrapResponder, pid_start_time, pid_verified)

PACKAGES = {
    "jax": dict(actor=JA, event=JE, lifecycle=JL, pm=JPM, recorder=JRec,
                storage=JS, runtime=JProcessRuntime, registrar=JRegistrar,
                filter=JServiceFilter, memory=JM, generate=jgenerate),
    "torch": dict(actor=TA, event=TE, lifecycle=TL, pm=TPM, recorder=TRec,
                  storage=TS, runtime=TProcessRuntime, registrar=TRegistrar,
                  filter=TServiceFilter, memory=TM, generate=tgenerate),
}


def both(scenario):
    port, reference = scenario("torch"), scenario("jax")
    assert port == reference
    return port


class Host:
    """One package's engine (virtual clock) and broker, and runtimes on
    them."""

    def __init__(self, package):
        self.m = PACKAGES[package]
        self.engine = self.m["event"].EventEngine(
            self.m["event"].VirtualClock())
        self.broker = self.m["memory"].MemoryBroker()

    def runtime(self, name, **kwargs):
        memory = self.m["memory"]
        return self.m["runtime"](
            name=name, engine=self.engine, namespace="test",
            process_id=name, transport_factory=lambda on_message, lwt_topic,
            lwt_payload, lwt_retain: memory.MemoryMessage(
                on_message=on_message, broker=self.broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain), **kwargs).initialize()

    def settle(self, steps=8):
        for _ in range(steps):
            self.engine.step()

    def drive(self, predicate, wall_seconds=20.0, advance=0.2):
        """Real children, virtual supervision timers: advance the clock
        while polling, bounded by wall time."""
        deadline = time.monotonic() + wall_seconds
        while not predicate() and time.monotonic() < deadline:
            self.engine.clock.advance(advance)
            self.engine.step()
            time.sleep(0.01)
        return predicate()


# -- process manager ----------------------------------------------------------

def test_restart_delays_match_jax_call_for_call():
    """The same seeded RestartPolicy gives the same respawn delays and
    the same crash-loop verdict at the same death."""
    def scenario(package):
        pm = PACKAGES[package]["pm"]
        policy = pm.RestartPolicy(max_restarts=6, window=10.0, backoff=0.3,
                                  backoff_max=4.0, jitter=0.25, seed=5)
        window = pm.RestartWindow(policy)
        return [window.record(now) for now in
                (0.0, 0.5, 1.0, 1.2, 3.0, 4.0, 6.0, 8.0, 12.5, 30.0)]
    delays = both(scenario)
    assert None in delays and all(d is None or d >= 0.3 for d in delays)


def test_process_manager_spawns_exits_kills_and_refuses_duplicates():
    def scenario(package):
        host = Host(package)
        exits = []
        manager = host.m["pm"].ProcessManager(
            host.engine, lambda id, pid, code: exits.append((id, code)))
        pid = manager.spawn("ok", [sys.executable, "-c", "pass"])
        assert host.drive(lambda: exits)
        manager.spawn_python("sleeper", "time")     # `python -m time`
        manager.spawn("slow", [sys.executable, "-c",
                               "import time; time.sleep(60)"])
        with pytest.raises(ValueError):
            manager.spawn("slow", [sys.executable, "-c", "pass"])
        manager.delete("slow")
        alive = "slow" in manager
        manager.terminate()
        return isinstance(pid, int), exits, alive, manager.process_ids()
    assert both(scenario) == (True, [("ok", 0)], False, [])


def test_process_manager_restart_policy_and_crash_loop():
    def scenario(package):
        host = Host(package)
        exits, loops = [], []
        pm = host.m["pm"]
        manager = pm.ProcessManager(
            host.engine, lambda id, pid, code: exits.append((id, code)),
            crash_loop_handler=lambda id, times: loops.append(id))
        manager.spawn("dying", [sys.executable, "-c",
                                "import sys; sys.exit(3)"],
                      restart=pm.RestartPolicy(max_restarts=1, window=1e6,
                                               backoff=0.05, jitter=0.0))
        manager.spawn("clean", [sys.executable, "-c", "pass"],
                      restart=pm.RestartPolicy(backoff=0.05, jitter=0.0))
        assert host.drive(lambda: loops == ["dying"] and
                          ("clean", 0) in exits)
        state = manager.restart_state("dying")
        with pytest.raises(OSError):
            manager.spawn("w", ["/nonexistent/binary"],
                          restart=pm.RestartPolicy(backoff=0.05))
        manager.terminate()
        return sorted(exits), state, manager.restart_state("clean"), \
            manager.restart_state("w")
    exits, state, clean, failed = both(scenario)
    assert exits == [("clean", 0), ("dying", 3)]
    assert state == {"recent_exits": 2, "crash_looping": True,
                     "respawn_pending": False}
    assert clean == {} and failed == {}


def test_pid_identity_checks():
    own = pid_start_time(os.getpid())
    assert own is not None
    assert pid_verified(os.getpid(), start_time=own)
    assert pid_verified(os.getpid(), marker="python")
    assert not pid_verified(2 ** 22 + 12345, start_time=own)


def test_bootstrap_responder_answers_on_loopback():
    """The responder answers a "boot?" datagram sent to it on 127.0.0.1
    (no broadcast) with its transport endpoint."""
    import socket
    responder = BootstrapResponder(host="broker.local", port=1883,
                                   bind="127.0.0.1", bootstrap_port=0)
    port = responder._sock.getsockname()[1]
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(3.0)
    try:
        sock.sendto(b"boot?", ("127.0.0.1", port))
        data, _ = sock.recvfrom(128)
        assert data == b"boot broker.local 1883"
    finally:
        sock.close()
        responder.stop()


# -- lifecycle ----------------------------------------------------------------

def test_lifecycle_fleet_handshake_mirror_delete_and_timeout():
    def scenario(package):
        host = Host(package)
        lifecycle = host.m["lifecycle"]
        manager_rt = host.runtime("lcm_host")

        def spawner(client_id, manager_topic):
            rt = host.runtime(f"worker_{client_id}")
            lifecycle.LifeCycleClient(rt, f"client_{client_id}",
                                      manager_topic, client_id)
            return rt
        changes = []
        manager = lifecycle.LifeCycleManager(
            manager_rt, "lcm", spawner,
            client_change_handler=lambda kind, cid, _: changes.append(
                (kind, cid)))
        ids = manager.create_clients(3)
        host.settle(12)
        ready = (manager.ready_count(), manager.ec_producer.get(
            "client_count"), str(manager.clients[ids[0]].share.get(
                "client_id")))
        manager.delete_client(ids[0])
        host.settle(8)
        after = (manager.ready_count(), manager.ready_ids())
        lonely = lifecycle.LifeCycleManager(
            manager_rt, "lcm2", spawner=lambda cid, topic: None,
            handshake_lease_time=5.0)
        lonely.create_clients(2)
        pending = len(lonely.clients)
        host.engine.clock.advance(6.0)
        host.settle(4)
        return ids, ready, after, changes, pending, len(lonely.clients)
    ids, ready, after, changes, pending, reaped = both(scenario)
    assert ids == ["0", "1", "2"] and ready == (3, 3, "0")
    assert after == (2, ["1", "2"]) and ("remove", "0") in changes
    assert pending == 2 and reaped == 0


def test_lifecycle_restart_policy_replaces_dead_clients():
    def scenario(package):
        host = Host(package)
        lifecycle, pm = host.m["lifecycle"], host.m["pm"]
        spawned = {}

        def spawner(client_id, manager_topic):
            rt = host.runtime(f"worker3_{client_id}")
            lifecycle.LifeCycleClient(rt, f"client3_{client_id}",
                                      manager_topic, client_id)
            spawned[client_id] = rt
            return rt
        manager = lifecycle.LifeCycleManager(
            host.runtime("lcm3_host"), "lcm3", spawner,
            restart_policy=pm.RestartPolicy(max_restarts=2, window=1e6,
                                            backoff=0.2, jitter=0.0))
        manager.create_clients(2)
        settle = host.m["event"].settle_virtual
        settle(host.engine, 2.0)
        trace = []
        for _ in range(3):
            victim = min(cid for cid in manager.clients if cid != "1")
            spawned[victim].message.crash()
            settle(host.engine, 2.0)
            trace.append((dict(manager.restart_stats), manager.ready_count(),
                          manager.crash_looping, manager.ready_ids()))
        return trace
    trace = both(scenario)
    assert trace[-1][0] == {"respawns": 2, "deaths": 3}
    assert trace[-1][1:3] == (1, True)


# -- recorder and storage ---------------------------------------------------

def test_recorder_rings_metrics_alerts_and_persistence(tmp_path):
    def scenario(package):
        host = Host(package)
        m = host.m
        rt = host.runtime("rec_host")
        recorder = m["recorder"].Recorder(rt, ring_limit=4,
                                          metrics_ring_limit=2)
        store_rt = host.runtime("store_host")
        storage = m["storage"].Storage(
            store_rt, database_path=str(tmp_path / f"{package}.db"))
        host.settle(4)
        log_topic = "test/host/123-0/1/log"
        for i in range(6):
            rt.publish(log_topic, f"line {i} (weird chars)")
        metrics_topic = "test/host/77-0/0/metrics"
        for tick in range(3):
            rt.publish(metrics_topic, json.dumps({
                "process": "p77", "time": tick, "snapshot": {}}))
        rt.publish(metrics_topic, "not json")
        for state in ("firing", "resolved"):
            rt.publish("test/alert/ttft", json.dumps({
                "rule": "ttft", "state": state, "exemplars": ["t1"]}))
        rt.publish("test/alert/queue", json.dumps({
            "rule": "queue", "state": "firing", "exemplars": ["t9"]}))
        host.settle(12)
        rt.publish(recorder.topic_in, f"(persist {storage.topic_in})")
        host.settle(10)
        got = []
        collector = m["storage"].ResponseCollector(store_rt, got.extend)
        store_rt.publish(storage.topic_in, m["generate"](
            "get", [f"log/{log_topic}", collector.topic]))
        host.settle(10)
        share = {key: recorder.ec_producer.get(key) for key in (
            "topic_count", "record_count", "metrics_topic_count",
            "alerts_firing", "persisted_topics",
            "persisted_metrics_topics")}
        return (recorder.tail(log_topic, 99), recorder.topics(),
                [doc["time"] for doc in
                 recorder.metrics_tail(metrics_topic, 99)],
                recorder.alert_exemplars(), share, got)
    tail, topics, times, exemplars, share, got = both(scenario)
    assert tail == [f"line {i} (weird chars)" for i in range(2, 6)]
    assert times == [1, 2] and exemplars == {"queue": ["t9"]}
    assert share == {"topic_count": 1, "record_count": 4,
                     "metrics_topic_count": 1, "alerts_firing": 1,
                     "persisted_topics": 1, "persisted_metrics_topics": 1}
    assert got == [tail]


def test_storage_commands_and_the_discovered_request():
    def scenario(package):
        host = Host(package)
        m = host.m
        m["registrar"](host.runtime("reg_host"))
        host.engine.clock.advance(2.1)
        host.settle(6)
        store_rt = host.runtime("svc_host")
        storage = m["storage"].Storage(store_rt)
        storage.put("alpha", {"x": 1})
        storage.put("beta", [1, 2, 3])
        answers = []
        for command, args in (("get", ["alpha"]), ("keys", []),
                              ("delete", ["alpha"]), ("get", ["alpha"])):
            if command == "delete":
                storage.delete(*args)
                continue
            collector = m["storage"].ResponseCollector(store_rt,
                                                       answers.append)
            getattr(storage, command)(*args, collector.topic)
            host.settle(6)
        client_rt = host.runtime("cli_host")
        host.settle(8)
        results = []
        m["storage"].do_request(
            client_rt, m["storage"].Storage,
            m["filter"](protocol=str(storage.protocol)),
            lambda proxy, topic: proxy.get("beta", topic), results.append)
        host.settle(20)
        return answers, results
    answers, results = both(scenario)
    assert answers == [[{"x": 1}], ["alpha", "beta"], []]
    assert results == [[[1, 2, 3]]]


def test_actor_logs_reach_the_recorder_over_the_transport():
    def scenario(package):
        host = Host(package)
        recorder = host.m["recorder"].Recorder(host.runtime("ops_host"))
        app_rt = host.runtime("app_host", log_transport=True)
        worker = host.m["actor"].Actor(app_rt, f"log_worker_{package}")
        quiet = host.m["actor"].Actor(host.runtime("quiet_host"),
                                      f"quiet_{package}")
        host.settle(15)
        worker.logger.warning("thermal threshold crossed")
        quiet.logger.warning("should stay local")
        host.settle(10)
        tail = recorder.tail(worker.topic_log)
        handler = worker._transport_log_handler
        worker.stop()
        return ([line.replace(package, "P") for line in tail],
                quiet.topic_log in recorder.topics(),
                handler in worker.logger.handlers)
    tail, quiet_logged, still_attached = both(scenario)
    assert tail == ["WARNING actor.log_worker_P: thermal threshold crossed"]
    assert not quiet_logged and not still_attached


def test_transport_handler_rings_until_connected():
    import logging

    class Transport:
        up, published = False, []

        def connected(self):
            return self.up

        def publish(self, topic, payload):
            self.published.append((topic, payload))
    transport = Transport()
    handler = TransportLoggingHandler(lambda: transport, "t/log")
    logger = logging.getLogger("test_torch_lifecycle.ring")
    logger.addHandler(handler)
    logger.propagate = False
    try:
        logger.warning("early")
        assert transport.published == []
        transport.up = True
        logger.warning("late")
        assert [p for _, p in transport.published] == ["early", "late"]
    finally:
        logger.removeHandler(handler)
