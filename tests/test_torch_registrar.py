"""The port's Registrar (registrar.py, on state/fsm.py) held against the
JAX package's: the same scripted sequence — two registrars electing a
primary, services registering and leaving, a ServicesCache following
the table, the primary crashing (its last wills fire) and the secondary
promoting, a graceful primary stop — runs on each package with the same
process ids, and must give the same FSM states, service tables, history,
retained boot records and cache handler calls."""

import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu.service import Service as JService
from aiko_services_tpu.service import ServiceFilter as JServiceFilter
from aiko_services_tpu.service import ServiceProtocol as JServiceProtocol
from aiko_services_tpu.share import ServicesCache as JServicesCache
from aiko_services_tpu.state import StateMachine as JStateMachine
from aiko_services_tpu.state import StateMachineError as JStateMachineError
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.service import Service as TService
from aiko_services_tpu_torch.service import ServiceFilter as TServiceFilter
from aiko_services_tpu_torch.service import ServiceProtocol as \
    TServiceProtocol
from aiko_services_tpu_torch.share import ServicesCache as TServicesCache
from aiko_services_tpu_torch.state import StateMachine as TStateMachine
from aiko_services_tpu_torch.state import StateMachineError as \
    TStateMachineError
from aiko_services_tpu_torch.transport import memory as TM

PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JRegistrar, JService, JServiceFilter,
            JServiceProtocol, JServicesCache),
    "torch": (TE, TM, TProcessRuntime, TRegistrar, TService, TServiceFilter,
              TServiceProtocol, TServicesCache),
}


def script(package):
    """The scripted sequence; returns what it observed, step by step."""
    (event, memory, runtime_class, registrar_class, service_class,
     filter_class, protocol_class, cache_class) = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        return runtime_class(name=name, engine=engine, namespace="test",
                             process_id=name,
                             transport_factory=factory).initialize()

    def settle(seconds=0.0):
        while engine.step():
            pass
        if seconds:
            engine.clock.advance(seconds)
            while engine.step():
                pass

    log = []

    def snapshot(label, registrars):
        log.append((label, [
            (r.topic_path, r.state_machine.state,
             sorted((f.topic_path, f.name, f.protocol, tuple(f.tags))
                    for f in r.services),
             [f.topic_path for f in r.history])
            for r in registrars],
            broker.retained("test/service/registrar")))

    reg_a = registrar_class(runtime("reg_a"))
    snapshot("searching", [reg_a])
    settle(2.1)                             # the 2.0 s primary search
    snapshot("elected", [reg_a])
    reg_b = registrar_class(runtime("reg_b"))
    settle()
    snapshot("standby", [reg_a, reg_b])

    calls = []
    client = runtime("client")
    cache = cache_class(client)
    cache.add_handler(
        lambda command, fields: calls.append((command, fields.topic_path,
                                              fields.name)),
        filter_class(protocol="*"))
    worker = runtime("worker")
    services = [service_class(worker, name, protocol_class(name),
                              tags=[f"role={name}"])
                for name in ("asr", "tts")]
    settle()
    snapshot("registered", [reg_a, reg_b])
    services[1].stop()
    settle()
    snapshot("one left", [reg_a, reg_b])

    # the primary's process crashes: its will "(primary absent)" and its
    # state LWT fire, the secondary searches and promotes
    reg_a.runtime.message.crash()
    settle()
    snapshot("crashed", [reg_b])
    settle(2.1)
    snapshot("promoted", [reg_b])
    # the services re-register with the new primary; the cache follows
    worker2 = runtime("worker2")
    service_class(worker2, "detect", protocol_class("detect"))
    settle()
    snapshot("re-registered", [reg_b])
    worker2.terminate(graceful=False)       # a process dies: purge
    settle()
    snapshot("purged", [reg_b])
    reg_b.stop()
    settle()
    snapshot("stopped", [reg_b])
    return log, calls, sorted(f.topic_path for f in cache.get_services())


def test_the_registrar_script_runs_alike_on_both_packages():
    port = script("torch")
    reference = script("jax")
    assert port == reference
    log, calls, cached = port
    states = {label: [state for _, state, _, _ in registrars]
              for label, registrars, _ in log}
    assert states["searching"] == ["primary_search"]
    assert states["elected"] == ["primary"]
    assert states["standby"] == ["primary", "secondary"]
    assert states["crashed"] == ["primary_search"]
    assert states["promoted"] == ["primary"]
    assert states["stopped"] == ["secondary"]
    events = [(command, name) for command, _, name in calls]
    assert events[2:5] == [("add", "asr"), ("add", "tts"), ("remove", "tts")]
    assert events[-2:] == [("add", "detect"), ("remove", "detect")]
    assert [path.rsplit("/", 2)[1] for path in cached] == \
        ["reg_a", "reg_b", "worker"]
    boot = {label: retained for label, _, retained in log}
    assert boot["searching"] is None and boot["stopped"] is None
    assert "found" in str(boot["elected"])
    assert boot["crashed"] == "(primary absent)"


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_state_machine_transitions_and_fail_fast(package):
    machine_class, error = {
        "jax": (JStateMachine, JStateMachineError),
        "torch": (TStateMachine, TStateMachineError)}[package]
    entered = []

    class Delegate:
        def on_enter_run(self, *args):
            entered.append(("run", args))

    machine = machine_class(
        Delegate(), ["idle", "run", "stop"],
        [{"trigger": "go", "source": "idle", "dest": "run"},
         {"trigger": "halt", "source": "*", "dest": "stop"}],
        initial="idle")
    machine.transition("go", 1)
    assert machine.state == "run" and entered == [("run", (1,))]
    with pytest.raises(error):
        machine.transition("go")
    machine.transition("halt")
    assert machine.state == "stop"
    quiet = machine_class(Delegate(), ["a"], [], initial="a",
                          fail_fast=False)
    quiet.transition("nothing")
    assert quiet.state == "a"
