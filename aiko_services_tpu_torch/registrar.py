# Registrar: the service-discovery service, with primary failover.
#
# Capability parity with the reference registrar
# (reference: aiko_services/registrar.py:129-357):
#   * FSM start → primary_search → (secondary | primary) with a 2 s
#     promotion timeout;
#   * on promotion: clear the retained boot topic, arm a last-will
#     "(primary absent)", publish retained "(primary found topic version
#     time)";
#   * service table protocol on topic_in: (add record), (remove topic),
#     (share response_topic lease_time filter), (history response count);
#     live add/remove events republished on topic_out;
#   * watches {namespace}/+/+/+/state for "(absent)" last-wills and purges
#     every service of a dead process (service-id 0 = whole process);
#   * history ring buffer of departed services.
#
# The port's own copy of aiko_services_tpu/registrar.py; the port's
# ServicesCache (share.py) consumes its table.

from __future__ import annotations

from collections import deque

from .service import (
    Service, ServiceFields, ServiceFilter, ServiceProtocol, Services,
    ServiceTopicPath,
)
from .state import StateMachine
from .utils import generate, get_logger, parse, parse_int

__all__ = ["Registrar", "PROTOCOL_REGISTRAR"]

PROTOCOL_REGISTRAR = ServiceProtocol("registrar")
_PRIMARY_SEARCH_TIMEOUT = 2.0      # seconds (reference: registrar.py:130)
_HISTORY_LIMIT = 4096              # entries (reference: registrar.py:129)
_VERSION = "0"

_STATES = ["start", "primary_search", "secondary", "primary"]
_TRANSITIONS = [
    {"trigger": "initialize", "source": "start", "dest": "primary_search"},
    {"trigger": "primary_found", "source": "primary_search",
     "dest": "secondary"},
    {"trigger": "primary_promotion", "source": "primary_search",
     "dest": "primary"},
    {"trigger": "primary_absent", "source": "secondary",
     "dest": "primary_search"},
    {"trigger": "primary_yield", "source": "primary", "dest": "secondary"},
]


class Registrar(Service):
    def __init__(self, runtime):
        super().__init__(runtime, "registrar", PROTOCOL_REGISTRAR)
        self.logger = get_logger("registrar")
        self.services = Services()
        self.history: deque[ServiceFields] = deque(maxlen=_HISTORY_LIMIT)
        self._search_timer = None
        self._primary_topic_path: str | None = None   # whom we stand by for
        self.state_machine = StateMachine(
            self, _STATES, _TRANSITIONS, initial="start")

        runtime.add_message_handler(self._boot_handler,
                                    runtime.topic_registrar_boot)
        runtime.add_message_handler(self._in_handler, self.topic_in)
        runtime.add_message_handler(
            self._state_handler, f"{runtime.namespace}/+/+/+/state")
        self.state_machine.transition("initialize")

    @property
    def is_primary(self) -> bool:
        return self.state_machine.state == "primary"

    # -- election ----------------------------------------------------------
    def on_enter_primary_search(self) -> None:
        self._search_timer = self.runtime.event.add_oneshot_handler(
            self._search_timeout, _PRIMARY_SEARCH_TIMEOUT)

    def _search_timeout(self) -> None:
        self._search_timer = None
        if self.state_machine.state == "primary_search":
            self.state_machine.transition("primary_promotion")

    def _cancel_search(self) -> None:
        if self._search_timer is not None:
            self.runtime.event.remove_timer_handler(self._search_timer)
            self._search_timer = None

    def on_enter_secondary(self) -> None:
        self._cancel_search()
        self.logger.info("registrar %s: secondary (standby)",
                         self.topic_path)

    def on_enter_primary(self) -> None:
        self._cancel_search()
        runtime = self.runtime
        boot_topic = runtime.topic_registrar_boot
        # clear any stale retained boot record, arm failover will, announce
        runtime.publish(boot_topic, "", retain=True)
        add_will = getattr(runtime.message, "add_last_will_and_testament",
                           None)
        if add_will:
            add_will(boot_topic, generate("primary", ["absent"]), True)
        self._announce_primary()
        self.logger.info("registrar %s: primary", self.topic_path)

    def _announce_primary(self) -> None:
        timestamp = f"{self.runtime.event.clock.now():.3f}"
        self.runtime.publish(
            self.runtime.topic_registrar_boot,
            generate("primary",
                     ["found", self.topic_path, _VERSION, timestamp]),
            retain=True)

    def _boot_handler(self, _topic, payload) -> None:
        if payload in ("", b"", None):
            return
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command != "primary" or not params:
            return
        if params[0] == "found":
            primary_topic = params[1] if len(params) > 1 else None
            if primary_topic == self.topic_path:
                return      # our own announcement
            if primary_topic:
                self._primary_topic_path = primary_topic
            if self.state_machine.state == "primary_search":
                self.state_machine.transition("primary_found")
            elif self.state_machine.state == "primary":
                # Split-brain (simultaneous promotion — the reference's
                # known defect, registrar.py:54-55): resolve by
                # deterministic order.  Lower topic_path wins; the loser
                # yields and disarms its failover will, the winner
                # re-asserts so the retained boot record converges on it.
                if primary_topic and primary_topic < self.topic_path:
                    self.logger.warning(
                        "registrar %s: yielding primary to %s",
                        self.topic_path, primary_topic)
                    remove_will = getattr(
                        self.runtime.message,
                        "remove_last_will_and_testament", None)
                    if remove_will:
                        remove_will(self.runtime.topic_registrar_boot)
                    self.state_machine.transition("primary_yield")
                else:
                    self._announce_primary()
        elif params[0] == "absent":
            if self.state_machine.state == "secondary":
                self.state_machine.transition("primary_absent")

    # -- service table protocol -------------------------------------------
    def _in_handler(self, _topic, payload) -> None:
        if not self.is_primary:
            return
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "add" and len(params) >= 5:
            try:
                fields = ServiceFields.from_record(params)
            except Exception:
                return
            existing = self.services.get(fields.topic_path)
            self.services.add(fields)
            if existing == fields:
                # idempotent re-registration (reconnect replay, periodic
                # re-announce): the table is already right — do not storm
                # every cache in the fleet with a no-op event.  A CHANGED
                # record (e.g. new tags) still propagates.
                return
            self.runtime.publish(
                self.topic_out,
                generate("add", [fields.to_record()]))
        elif command == "remove" and params:
            fields = self.services.remove(params[0])
            if fields is not None:
                # audited: deque(maxlen=_HISTORY_LIMIT)  # graft: disable=lint-unbounded-queue
                self.history.appendleft(fields)
                self.runtime.publish(self.topic_out,
                                     generate("remove", [params[0]]))
        elif command == "share" and len(params) >= 2:
            self._share(params[0], params[2] if len(params) > 2 else "*")
        elif command == "history" and params:
            self._share_history(params[0],
                                parse_int(params[1], 16)
                                if len(params) > 1 else 16)

    def _share(self, response_topic: str, protocol_filter) -> None:
        service_filter = ServiceFilter(
            protocol=protocol_filter if isinstance(protocol_filter, str)
            else "*")
        records = [f for f in self.services if service_filter.matches(f)]
        self.runtime.publish(response_topic,
                             generate("item_count", [str(len(records))]))
        for fields in records:
            self.runtime.publish(
                response_topic, generate("add", [fields.to_record()]))

    def _share_history(self, response_topic: str, count: int) -> None:
        records = list(self.history)[:count]
        self.runtime.publish(response_topic,
                             generate("item_count", [str(len(records))]))
        for fields in records:
            self.runtime.publish(
                response_topic, generate("history", [fields.to_record()]))

    # -- process liveness --------------------------------------------------
    def _state_handler(self, topic, payload) -> None:
        try:
            command, _ = parse(payload) if payload else ("", [])
        except Exception:
            return
        if command != "absent":
            return
        if self.state_machine.state == "secondary":
            # Failover hardening: the boot-topic "(primary
            # absent)" LWT is ONE message on a lossy transport — if it is
            # dropped, a secondary that only listened there stands by
            # forever.  The primary's process-state LWT ("(absent)",
            # RETAINED on its state topic) is an independent death
            # signal carried by the same wildcard subscription, so a
            # secondary promotes on either.
            primary = self._primary_topic_path
            parsed = ServiceTopicPath.parse(primary) if primary else None
            if parsed is not None and \
                    topic == f"{parsed.process_path}/0/state":
                self.logger.warning(
                    "registrar %s: primary %s process died (state LWT); "
                    "starting promotion", self.topic_path, primary)
                self.state_machine.transition("primary_absent")
            return
        if not self.is_primary:
            return
        topic_path = ServiceTopicPath.parse(topic.rsplit("/", 1)[0])
        if topic_path is None:
            return
        if topic_path.service_id == "0":
            removed = self.services.remove_process(topic_path.process_path)
            for fields in removed:
                # audited: deque(maxlen=_HISTORY_LIMIT)  # graft: disable=lint-unbounded-queue
                self.history.appendleft(fields)
                self.runtime.publish(self.topic_out,
                                     generate("remove", [fields.topic_path]))

    # -- shutdown ----------------------------------------------------------
    def stop(self) -> None:
        was_primary = self.is_primary
        if was_primary:
            boot_topic = self.runtime.topic_registrar_boot
            self.runtime.publish(boot_topic, "", retain=True)
            self.runtime.publish(boot_topic,
                                 generate("primary", ["absent"]))
            remove_will = getattr(self.runtime.message,
                                  "remove_last_will_and_testament", None)
            if remove_will:
                remove_will(boot_topic)
        # full teardown: a stopped registrar must neither keep serving its
        # protocol nor re-assert primacy when a successor announces itself
        self._cancel_search()
        runtime = self.runtime
        runtime.remove_message_handler(self._boot_handler,
                                       runtime.topic_registrar_boot)
        runtime.remove_message_handler(self._in_handler, self.topic_in)
        runtime.remove_message_handler(
            self._state_handler, f"{runtime.namespace}/+/+/+/state")
        if was_primary:
            self.state_machine.transition("primary_yield")
        super().stop()
