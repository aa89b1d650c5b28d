"""Shared scaffolding of the operations-plane parity tests
(tests/test_torch_{export,series,autoscaler,placement,dashboard,
trace_legacy,lock_order}.py): each package's modules under one name, and
one package's engine (virtual clock), broker and runtimes.  A scenario
written once against `Host(package).m` runs on both packages, and
`both` requires equal results."""

from types import SimpleNamespace

from aiko_services_tpu import autoscaler as JAutoscaler
from aiko_services_tpu import dashboard as JDashboard
from aiko_services_tpu import dashboard_plugins as JPlugins
from aiko_services_tpu import event as JEvent
from aiko_services_tpu import legacy as JLegacy
from aiko_services_tpu import lifecycle as JLifecycle
from aiko_services_tpu import placement as JPlacement
from aiko_services_tpu import trace as JTrace
from aiko_services_tpu.observe import export as JExport
from aiko_services_tpu.observe import metrics as JMetrics
from aiko_services_tpu.observe import series as JSeries
from aiko_services_tpu.observe import sketch as JSketch
from aiko_services_tpu.observe import tracing as JTracing
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JMemory
from aiko_services_tpu_torch import autoscaler as TAutoscaler
from aiko_services_tpu_torch import dashboard as TDashboard
from aiko_services_tpu_torch import dashboard_plugins as TPlugins
from aiko_services_tpu_torch import event as TEvent
from aiko_services_tpu_torch import legacy as TLegacy
from aiko_services_tpu_torch import lifecycle as TLifecycle
from aiko_services_tpu_torch import placement as TPlacement
from aiko_services_tpu_torch import trace as TTrace
from aiko_services_tpu_torch.observe import export as TExport
from aiko_services_tpu_torch.observe import metrics as TMetrics
from aiko_services_tpu_torch.observe import series as TSeries
from aiko_services_tpu_torch.observe import sketch as TSketch
from aiko_services_tpu_torch.observe import tracing as TTracing
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TMemory

PACKAGES = {
    "jax": SimpleNamespace(
        autoscaler=JAutoscaler, dashboard=JDashboard, plugins=JPlugins,
        event=JEvent, legacy=JLegacy, lifecycle=JLifecycle,
        placement=JPlacement, trace=JTrace, export=JExport,
        metrics=JMetrics, series=JSeries, sketch=JSketch,
        tracing=JTracing, runtime=JProcessRuntime, memory=JMemory),
    "torch": SimpleNamespace(
        autoscaler=TAutoscaler, dashboard=TDashboard, plugins=TPlugins,
        event=TEvent, legacy=TLegacy, lifecycle=TLifecycle,
        placement=TPlacement, trace=TTrace, export=TExport,
        metrics=TMetrics, series=TSeries, sketch=TSketch,
        tracing=TTracing, runtime=TProcessRuntime, memory=TMemory),
}


class Host:
    """One package's engine (virtual clock) and broker, and runtimes on
    them, named alike on both packages."""

    def __init__(self, package: str):
        self.package = package
        self.m = PACKAGES[package]
        self.engine = self.m.event.EventEngine(self.m.event.VirtualClock())
        self.broker = self.m.memory.MemoryBroker()

    def runtime(self, name: str, **kwargs):
        memory = self.m.memory
        return self.m.runtime(
            name=name, engine=self.engine, namespace="test",
            process_id=name, transport_factory=lambda on_message, lwt_topic,
            lwt_payload, lwt_retain: memory.MemoryMessage(
                on_message=on_message, broker=self.broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain), **kwargs).initialize()

    def settle(self, steps: int = 10) -> None:
        for _ in range(steps):
            self.engine.step()

    def settle_virtual(self, seconds: float) -> None:
        self.m.event.settle_virtual(self.engine, seconds)


def both(scenario):
    """Run scenario(package) on the port, then on the JAX package; the
    results must be equal.  Returns the port's."""
    port, reference = scenario("torch"), scenario("jax")
    assert port == reference
    return port
