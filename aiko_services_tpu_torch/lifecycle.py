# LifeCycleManager / LifeCycleClient: spawn a fleet of worker processes and
# track their health.
#
# The port's own copy of aiko_services_tpu/lifecycle.py:
#   * the manager spawns N clients (via a spawner callable — OS processes
#     through ProcessManager, or in-process runtimes in tests);
#   * each client calls back `(add_client topic_path id)` on the manager's
#     control topic within a handshake lease (30 s default);
#   * the manager EC-consumes each client's share to watch its lifecycle
#     state, and purges clients whose process dies (its LWT);
#   * deletion leases force-kill stragglers; a RestartPolicy replaces
#     dead clients under backoff until the crash-loop budget is spent.

from __future__ import annotations

from dataclasses import dataclass, field

from .actor import Actor
from .lease import Lease
from .process import STATE_ABSENT
from .process_manager import RestartPolicy, RestartWindow
from .service import ServiceProtocol, ServiceTopicPath
from .share import ECConsumer
from .utils import generate, get_logger, parse


def state_topic_of(service_topic_path: str) -> str:
    """The process-liveness topic (service 0's state, where the LWT
    fires) for any service topic path; "" when unparseable."""
    parsed = ServiceTopicPath.parse(service_topic_path)
    return f"{parsed.process_path}/0/state" if parsed else ""


def is_absent(payload) -> bool:
    """True for the process-death payload (STATE_ABSENT contract)."""
    try:
        command, _ = parse(str(payload))
    except Exception:
        return False
    return command == STATE_ABSENT.strip("()")

__all__ = ["LifeCycleManager", "LifeCycleClient",
           "PROTOCOL_LIFECYCLE_MANAGER", "PROTOCOL_LIFECYCLE_CLIENT"]

PROTOCOL_LIFECYCLE_MANAGER = ServiceProtocol("lifecycle_manager")
PROTOCOL_LIFECYCLE_CLIENT = ServiceProtocol("lifecycle_client")
_HANDSHAKE_LEASE = 30.0     # seconds
_DELETION_LEASE = 30.0      # seconds


@dataclass
class _ClientRecord:
    client_id: str
    topic_path: str = ""
    state: str = "spawned"          # spawned | ready | deleting | gone
    lease: Lease | None = None
    consumer: ECConsumer | None = None
    share: dict = field(default_factory=dict)
    state_topic: str = ""           # client process LWT topic (crash watch)


class LifeCycleManager(Actor):
    """Spawns clients via `spawner(client_id, manager_topic_path)` and
    tracks them.  spawner returns an opaque handle passed to
    `terminator(client_id, handle)` on deletion (both injectable: OS
    processes, in-process runtimes)."""

    def __init__(self, runtime, name: str, spawner, terminator=None,
                 client_change_handler=None,
                 handshake_lease_time: float = _HANDSHAKE_LEASE,
                 restart_policy: RestartPolicy | None = None):
        super().__init__(runtime, name, PROTOCOL_LIFECYCLE_MANAGER)
        self.logger = get_logger(f"lifecycle_manager.{name}")
        self.spawner = spawner
        self.terminator = terminator
        self.client_change_handler = client_change_handler
        self.handshake_lease_time = handshake_lease_time
        # restart_policy supervises the FLEET: a client that dies (LWT)
        # is replaced under backoff; too many deaths inside the policy
        # window is a crash loop and replacement stops
        self.restart_policy = restart_policy
        self.crash_looping = False
        self._restart_window = RestartWindow(restart_policy) \
            if restart_policy else None
        self._restart_timers: set[int] = set()
        self.restart_stats = {"respawns": 0, "deaths": 0}
        self.clients: dict[str, _ClientRecord] = {}
        self._handles: dict[str, object] = {}
        self._counter = 0
        # crash watch refcounts: several clients may share one process,
        # so the state-topic handler lives until the LAST of them goes
        self._state_watch: dict[str, set] = {}    # topic -> client_ids
        runtime.add_message_handler(self._control_handler,
                                    self.topic_control)
        self.ec_producer.update("client_count", 0)

    # -- spawning ----------------------------------------------------------
    def create_clients(self, count: int) -> list[str]:
        ids = []
        for _ in range(count):
            client_id = str(self._counter)
            self._counter += 1
            record = _ClientRecord(client_id)
            record.lease = Lease(
                self.runtime.event, self.handshake_lease_time, client_id,
                lease_expired_handler=self._handshake_expired)
            self.clients[client_id] = record
            self._handles[client_id] = self.spawner(client_id,
                                                    self.topic_path)
            ids.append(client_id)
        self._publish_count()
        return ids

    def _handshake_expired(self, client_id) -> None:
        record = self.clients.get(str(client_id))
        if record and record.state == "spawned":
            self.logger.warning("client %s missed handshake; deleting",
                                client_id)
            self.delete_client(str(client_id))

    # -- protocol ----------------------------------------------------------
    def _control_handler(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "add_client" and len(params) >= 2:
            self._add_client(params[0], str(params[1]))

    def _add_client(self, topic_path: str, client_id: str) -> None:
        record = self.clients.get(client_id)
        if record is None or record.state != "spawned":
            return
        record.topic_path = topic_path
        record.state = "ready"
        if record.lease:
            record.lease.terminate()
            record.lease = None
        # mirror the client's share (lifecycle state etc.)
        record.consumer = ECConsumer(
            self.runtime, record.share, f"{topic_path}/control")
        # crash detection: the client process's LWT (watching the state
        # topic directly needs no registrar in the loop)
        record.state_topic = state_topic_of(topic_path)
        if record.state_topic:
            watchers = self._state_watch.setdefault(record.state_topic,
                                                    set())
            if not watchers:
                self.runtime.add_message_handler(
                    self._client_state_handler, record.state_topic)
            watchers.add(client_id)
        self.logger.info("client %s ready at %s", client_id, topic_path)
        if self.client_change_handler:
            self.client_change_handler("add", client_id, record)
        self._publish_count()

    def _client_state_handler(self, topic, payload) -> None:
        if not is_absent(payload):
            return
        died = 0
        for client_id, record in list(self.clients.items()):
            if record.state_topic == topic:
                self.logger.warning("client %s died (LWT on %s)",
                                    client_id, topic)
                died += 1
                self.delete_client(client_id)
        for _ in range(died):
            self._client_died()

    # -- supervised replacement ---------------------------------------------
    def _client_died(self) -> None:
        if self._restart_window is None or self.crash_looping:
            return
        self.restart_stats["deaths"] += 1
        delay = self._restart_window.record(
            self.runtime.event.clock.now())
        if delay is None:
            self.crash_looping = True
            self.logger.error(
                "lifecycle %s: client crash loop (%d deaths in %.1fs); "
                "no further replacements", self.name,
                len(self._restart_window.events),
                self.restart_policy.window)
            if self.client_change_handler:
                self.client_change_handler("crash_loop", "", None)
            return
        self.logger.warning(
            "lifecycle %s: replacing dead client in %.2fs "
            "(death %d/%d in window)", self.name, delay,
            len(self._restart_window.events),
            self.restart_policy.max_restarts)
        handle_box = []

        def respawn():
            self._restart_timers.discard(handle_box[0])
            if not self.crash_looping:
                self.restart_stats["respawns"] += 1
                self.create_clients(1)

        # each death queues exactly one replacement; every pending
        # handle is tracked so stop() cancels them all
        handle_box.append(
            self.runtime.event.add_oneshot_handler(respawn, delay))
        self._restart_timers.add(handle_box[0])

    def _unwatch_state(self, topic: str, client_id: str) -> None:
        watchers = self._state_watch.get(topic)
        if watchers is None:
            return
        watchers.discard(client_id)
        if not watchers:
            del self._state_watch[topic]
            self.runtime.remove_message_handler(self._client_state_handler,
                                                topic)

    # -- deletion ----------------------------------------------------------
    def delete_client(self, client_id: str,
                      drain_s: float | None = None) -> None:
        """Retire one client.  Default: polite `(control_stop)` now,
        deletion lease force-kills stragglers.  With `drain_s` the
        retirement routes through graceful drain
        instead of kill: the client gets `(control_drain drain_s)` —
        a serving actor winds its decoder down, migrates session KV,
        then stops itself — and only a Lease at the HARD deadline
        falls back to the stop/terminate crash path.  Either way the
        record pops NOW: the client's eventual LWT must read as a
        planned exit, never as a death the restart policy respawns."""
        record = self.clients.pop(str(client_id), None)
        if record is None:
            return
        record.state = "deleting"
        if record.lease:
            record.lease.terminate()
        if record.consumer:
            record.consumer.terminate()
        if record.state_topic:
            self._unwatch_state(record.state_topic, str(client_id))
        drain = drain_s is not None and drain_s > 0 \
            and bool(record.topic_path)
        if record.topic_path:
            if drain:
                self.runtime.publish(f"{record.topic_path}/in",
                                     f"(control_drain {drain_s})")
                # the hard deadline: a client that did not finish its
                # drain inside the window gets the crash path after all
                Lease(self.runtime.event, float(drain_s), client_id,
                      lease_expired_handler=lambda cid,
                      topic=record.topic_path:
                          self.runtime.publish(f"{topic}/in",
                                               "(control_stop)"))
            else:
                # polite ask first; the deletion lease force-kills
                # stragglers
                self.runtime.publish(f"{record.topic_path}/in",
                                     "(control_stop)")
        handle = self._handles.pop(str(client_id), None)
        if self.terminator:
            grace = (float(drain_s) if drain else 0.0) + _DELETION_LEASE
            Lease(self.runtime.event, grace, client_id,
                  lease_expired_handler=lambda cid, h=handle:
                      self.terminator(str(cid), h))
        if self.client_change_handler:
            self.client_change_handler("remove", str(client_id), record)
        self._publish_count()

    def delete_all(self) -> None:
        for client_id in list(self.clients):
            self.delete_client(client_id)

    def ready_count(self) -> int:
        return sum(1 for r in self.clients.values() if r.state == "ready")

    def ready_ids(self) -> list[str]:
        """Ready client ids in creation order (ids are monotonic)."""
        return sorted((cid for cid, record in self.clients.items()
                       if record.state == "ready"), key=int)

    # -- elastic capacity (the autoscaler's actuator) -----------------------
    def scale_to(self, count: int, drain_s: float | None = None) -> int:
        """Grow or shrink the fleet to `count` clients.  Growth spawns
        through the normal create path (handshake-leased, supervised
        under the restart policy); shrink retires the NEWEST ready
        clients first — the oldest capacity is the warmest (compiled
        programs, filled caches), so it is the last to go.  With
        `drain_s` each retirement routes through graceful
        drain (see delete_client) instead of an immediate stop.
        Returns the signed delta actually applied."""
        count = max(0, int(count))
        current = len(self.clients)
        if count > current:
            self.create_clients(count - current)
            return count - current
        removed = 0
        for client_id in reversed(self.ready_ids()):
            if current - removed <= count:
                break
            self.delete_client(client_id, drain_s=drain_s)
            removed += 1
        return -removed

    def _publish_count(self) -> None:
        self.ec_producer.update("client_count", len(self.clients))

    def stop(self) -> None:
        for handle in self._restart_timers:
            self.runtime.event.remove_timer_handler(handle)
        self._restart_timers.clear()
        for record in self.clients.values():
            if record.lease:
                record.lease.terminate()
            if record.consumer:
                record.consumer.terminate()
        for topic in list(self._state_watch):
            self.runtime.remove_message_handler(self._client_state_handler,
                                                topic)
        self._state_watch.clear()
        self.runtime.remove_message_handler(self._control_handler,
                                            self.topic_control)
        super().stop()


class LifeCycleClient(Actor):
    """Worker-side half: announces itself to the manager's control topic
    on creation."""

    def __init__(self, runtime, name: str, manager_topic_path: str,
                 client_id: str, protocol=None):
        super().__init__(runtime, name,
                         protocol or PROTOCOL_LIFECYCLE_CLIENT)
        self.client_id = client_id
        self.manager_topic_path = manager_topic_path
        self.ec_producer.update("client_id", client_id)
        runtime.publish(f"{manager_topic_path}/control",
                        generate("add_client",
                                 [self.topic_path, client_id]))
