# Process runtime: identity, transport, topic routing, registrar bootstrap.
#
# Capability parity with the reference process runtime
# (reference: aiko_services/process.py:76-330): topic roots
# {namespace}/{hostname}/{process_id}, wildcard topic→handler routing,
# service table with incrementing service ids, last-will liveness on the
# process state topic, and the registrar bootstrap protocol
# "(primary found ...)" / "(primary absent)".
#
# Design changes:
#   * instantiable ProcessRuntime — many logical "processes" can share one
#     EventEngine + MemoryBroker, so whole multi-node systems run
#     deterministically inside a single pytest (the reference needs a live
#     mosquitto and real OS processes);
#   * transport injected via factory (memory default, MQTT optional);
#   * inbound messages always marshalled from the transport thread onto the
#     event engine before any handler runs.
#
# Binary topics (add_message_handler(..., binary=True)) carry tensor and
# media streams: their bytes payloads reach handlers undecoded, and the
# transport gives them its data-plane treatment (bounded per-client
# queues on the memory broker).  Binary wire envelopes (transport/wire.py)
# pass through undecoded on any topic.
#
# The peer data plane (enable_peer, transport/peer.py) moves binary
# envelopes bound for a negotiated topic over a direct channel instead of
# the broker.  Distributed logging (log_transport) makes every actor's
# logger publish its records to {topic_path}/{sid}/log.
#
# The port's own copy of aiko_services_tpu/process.py.

from __future__ import annotations

import itertools
import os

from .connection import Connection, ConnectionState
from .event import EventEngine
from .transport.memory import MemoryMessage
from .transport.message import topic_matches
from .transport.wire import is_envelope as wire_is_envelope
from .utils import (
    generate, get_hostname, get_namespace, get_username, get_logger, parse,
)

__all__ = ["ProcessRuntime", "REGISTRAR_BOOT_SUFFIX", "STATE_ABSENT"]

REGISTRAR_BOOT_SUFFIX = "service/registrar"
STATE_ABSENT = "(absent)"
_process_counter = itertools.count()


class ProcessRuntime:
    """One logical process on the control plane."""

    def __init__(self, name: str | None = None, engine: EventEngine = None,
                 transport_factory=None, namespace: str | None = None,
                 process_id: str | None = None,
                 terminate_on_registrar_absent: bool = False,
                 log_transport: bool | None = None):
        self.namespace = namespace or get_namespace()
        self.hostname = get_hostname()
        # unique id even when many runtimes share one OS process (tests)
        self.process_id = process_id or \
            f"{os.getpid()}-{next(_process_counter)}"
        self.username = get_username()
        self.topic_path = \
            f"{self.namespace}/{self.hostname}/{self.process_id}"
        self.topic_state = f"{self.topic_path}/0/state"
        self.topic_registrar_boot = \
            f"{self.namespace}/{REGISTRAR_BOOT_SUFFIX}"
        self.name = name or self.process_id
        self.logger = get_logger(f"process.{self.name}")
        # distributed logging: actors publish their records to
        # {topic_path}/{sid}/log (the Recorder's namespace filter)
        self.log_transport = log_transport if log_transport is not None \
            else os.environ.get("AIKO_TPU_LOG_TRANSPORT", "0") == "1"

        self.event = engine or EventEngine()
        self.connection = Connection()
        self.registrar: dict | None = None     # {"topic_path": ..., ...}
        self.terminate_on_registrar_absent = terminate_on_registrar_absent

        self._transport_factory = transport_factory or self._default_factory
        self.message = None
        self.peer = None        # PeerHost once enable_peer() is called
        self._message_handlers: list[tuple[str, object]] = []
        self._exact_handlers: dict[str, list] = {}
        self._wildcard_handlers: list[tuple[str, object]] = []
        self._services: dict[int, object] = {}
        self._service_counter = itertools.count(1)
        self._registrar_handlers = []
        self._binary_topics: set[str] = set()
        self._queue_name = f"message:{self.topic_path}"
        self._initialized = False

    @property
    def transport_name(self) -> str:
        return "memory" if isinstance(self.message, MemoryMessage) else "mqtt"

    @staticmethod
    def _default_factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return MemoryMessage(on_message=on_message, lwt_topic=lwt_topic,
                             lwt_payload=lwt_payload, lwt_retain=lwt_retain)

    # -- lifecycle ---------------------------------------------------------
    def initialize(self) -> "ProcessRuntime":
        if self._initialized:
            return self
        self._initialized = True
        self.event.add_queue_handler(self._on_message_queue, self._queue_name)
        self.add_message_handler(self._on_registrar,
                                 self.topic_registrar_boot)
        self.message = self._transport_factory(
            self._on_transport_message,
            self.topic_state, STATE_ABSENT, True)
        for topic, _ in self._message_handlers:
            self.message.subscribe(topic)
        for topic in self._binary_topics:
            self._mark_data_plane(topic)
        self.message.connect()
        self.connection.update(ConnectionState.TRANSPORT)
        # liveness: retained presence marker cleared by our LWT on death
        self.message.publish(self.topic_state, "(present)", retain=True)
        return self

    def run(self, loop_when_no_handlers=False) -> None:
        self.initialize()
        self.event.loop(loop_when_no_handlers)

    def terminate(self, graceful: bool = True) -> None:
        # stop() overrides run teardown (e.g. a primary registrar clears its
        # retained boot record and announces "(primary absent)")
        if self.peer is not None:
            self.peer.close()
            self.peer = None
        for service_id, service in list(self._services.items()):
            stop = getattr(service, "stop", None)
            if stop:
                stop()
            else:
                self.remove_service(service_id)
        if self.message is not None:
            if graceful:
                # explicit absent marker (broker LWT only fires on crash)
                self.message.publish(self.topic_state, STATE_ABSENT,
                                     retain=True)
                self.message.disconnect()
            else:
                crash = getattr(self.message, "crash", None)
                crash() if crash else self.message.disconnect()
        self.event.remove_queue_handler(self._queue_name)
        self.connection.update(ConnectionState.NONE)

    # -- inbound message path ---------------------------------------------
    def _on_transport_message(self, topic: str, payload,
                              ack=None) -> None:
        # may be called on a transport thread: marshal onto the event
        # engine.  `ack` (optional) is invoked when the item is drained
        # — the peer data plane uses it to bound its in-flight window
        self.event.queue_put(self._queue_name,
                             (topic, payload) if ack is None
                             else (topic, payload, ack))

    def _on_message_queue(self, _name, item, _put_time) -> None:
        topic, payload = item[0], item[1]
        if len(item) > 2:
            item[2]()           # delivery ack: the queue slot is free
        if isinstance(payload, bytes) and \
                not self._is_binary_topic(topic) and \
                not wire_is_envelope(payload):
            try:
                payload = payload.decode("utf-8")
            except UnicodeDecodeError:
                pass
        # exact handlers hash-match; only wildcard patterns scan — a
        # linear topic_matches walk here is O(handlers) per message,
        # which turns an N-consumer fan-out into O(N²) (the reference's
        # documented bottleneck, its lifecycle.py:18-24)
        for handler in list(self._exact_handlers.get(topic, ())):
            handler(topic, payload)
        for pattern, handler in list(self._wildcard_handlers):
            if topic_matches(pattern, topic):
                handler(topic, payload)

    def _is_binary_topic(self, topic: str) -> bool:
        return any(topic_matches(p, topic) for p in self._binary_topics)

    def _mark_data_plane(self, topic: str) -> None:
        """Binary topics carry tensor/media streams: give them the
        transport's data-plane treatment (bounded per-client queues
        with a drop policy on the memory broker) so a slow consumer
        sheds stale frames instead of growing without bound."""
        mark = getattr(self.message, "mark_data_plane", None)
        if mark is not None:
            mark(topic)

    def add_message_handler(self, handler, topic: str,
                            binary: bool = False) -> None:
        self._message_handlers.append((topic, handler))
        if "+" in topic or "#" in topic:
            self._wildcard_handlers.append((topic, handler))
        else:
            self._exact_handlers.setdefault(topic, []).append(handler)
        if binary:
            self._binary_topics.add(topic)
            if self.message is not None:
                self._mark_data_plane(topic)
        if self.message is not None:
            self.message.subscribe(topic)

    def remove_message_handler(self, handler, topic: str) -> None:
        self._message_handlers = [
            (t, h) for t, h in self._message_handlers
            if not (t == topic and h == handler)]
        self._wildcard_handlers = [
            (t, h) for t, h in self._wildcard_handlers
            if not (t == topic and h == handler)]
        exact = self._exact_handlers.get(topic)
        if exact is not None:
            self._exact_handlers[topic] = [h for h in exact
                                           if h != handler]
            if not self._exact_handlers[topic]:
                del self._exact_handlers[topic]
        if self.message is not None and \
                not any(t == topic for t, _ in self._message_handlers):
            self.message.unsubscribe(topic)

    def publish(self, topic: str, payload, retain: bool = False,
                wait: bool = False) -> None:
        # peer data plane: binary envelopes bound for a topic with a live
        # negotiated channel bypass the broker entirely; everything else
        # — control text, retained state, unpinned topics, dead channels
        # — falls through to the broker path
        if self.peer is not None and not retain and \
                self.peer.maybe_send(topic, payload):
            return
        self.message.publish(topic, payload, retain, wait)

    # -- peer data plane ---------------------------------------------------
    def enable_peer(self, kinds=("mem",), **kwargs):
        """Turn on the peer data plane for this runtime: services
        registered by this process advertise a direct-channel endpoint
        (tag "peer=..."), inbound handshakes are answered, and
        publish() pins negotiated data-plane traffic off the broker.
        Idempotent; returns the PeerHost."""
        if self.peer is None:
            from .transport.peer import PeerHost
            self.peer = PeerHost(self, kinds=kinds, **kwargs)
            # services registered before enabling re-advertise with the
            # endpoint tag so existing discovery records pick it up
            for service in self._services.values():
                service.add_tags([self.peer.tag])
                if self.registrar is not None and self.message is not None:
                    self._register_service(service)
        return self.peer

    # -- service table -----------------------------------------------------
    def add_service(self, service) -> int:
        service_id = next(self._service_counter)
        self._services[service_id] = service
        # assign the address here: service_fields() (used for registrar
        # registration below) needs topic_path before Service.__init__ has
        # returned
        service.service_id = service_id
        service.topic_path = f"{self.topic_path}/{service_id}"
        if self.peer is not None and self.peer.tag not in service.tags:
            # every service of a peer-enabled runtime advertises the
            # direct-channel endpoint in its discovery record
            service.tags.append(self.peer.tag)
        if self.registrar is not None:
            self._register_service(service)
        return service_id

    def remove_service(self, service_id: int) -> None:
        service = self._services.pop(service_id, None)
        if service is not None and self.registrar is not None and \
                self.message is not None and self.message.connected():
            self.publish(f"{self.registrar['topic_path']}/in",
                         generate("remove", [service.topic_path]))

    def services(self):
        return dict(self._services)

    def service_by_name(self, name: str):
        for service in self._services.values():
            if service.name == name:
                return service
        return None

    # -- registrar bootstrap ----------------------------------------------
    def add_registrar_handler(self, handler) -> None:
        """handler(registrar_or_None) on found/absent; fired with current."""
        self._registrar_handlers.append(handler)
        handler(self.registrar)

    def _register_service(self, service) -> None:
        fields = service.service_fields()
        self.publish(
            f"{self.registrar['topic_path']}/in",
            generate("add", fields.to_record()))

    def _on_registrar(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "primary" and len(params) >= 2 and \
                params[0] == "found":
            self.registrar = {
                "topic_path": params[1],
                "version": params[2] if len(params) > 2 else "0",
                "timestamp": params[3] if len(params) > 3 else "0",
            }
            for service in self._services.values():
                self._register_service(service)
            self.connection.update(ConnectionState.REGISTRAR)
        elif command == "primary" and params and params[0] == "absent":
            self.registrar = None
            if self.connection.state >= ConnectionState.REGISTRAR:
                self.connection.update(ConnectionState.TRANSPORT)
            if self.terminate_on_registrar_absent:
                self.event.terminate()
        for handler in list(self._registrar_handlers):
            handler(self.registrar)
