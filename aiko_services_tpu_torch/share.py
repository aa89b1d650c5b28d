# Eventual-consistency shared state over the control plane.
#
# Capability parity with the reference share layer
# (reference: aiko_services/share.py:70-656):
#   * ECProducer — owns a (≤2-level) dict, serves "(share response_topic
#     lease_time filter)" snapshot requests with "(item_count N)" +
#     "(add k v)"…, then streams "(add/update/remove)" deltas to every
#     leaseholder whose filter matches; accepts remote add/update/remove
#     commands (dashboard mutation path); local get/update/remove API with
#     change-handler fan-out.
#   * ECConsumer — mirrors a producer's filtered share into a local cache,
#     auto-extends its lease at 0.8x by re-requesting the share.
#   * ServicesCache — client-side replica of the registrar's service table
#     with add/remove handler fan-out per ServiceFilter.
#
# Simplification vs the reference: a lease re-request doubles as both
# extension and resync, so there is a single code path for join/extend.
#
# The port's own copy of aiko_services_tpu/share.py.

from __future__ import annotations

import itertools

from .connection import ConnectionState
from .lease import Lease
from .service import ServiceFields, ServiceFilter, Services
from .utils import generate, generate_sexpr, parse, parse_int, parse_sexpr

__all__ = ["ECProducer", "ECConsumer", "ServicesCache",
           "EC_LEASE_TIME", "filter_matches_item"]

EC_LEASE_TIME = 300.0     # seconds (reference: share.py:86)
_consumer_counter = itertools.count()


def filter_matches_item(item_filter, name: str) -> bool:
    """Share filters select top-level item names; "*" selects all.
    "a.b" items match a filter entry "a" (whole-branch selection)."""
    if item_filter in ("*", None) or item_filter == ["*"]:
        return True
    if isinstance(item_filter, str):
        item_filter = [item_filter]
    top = name.split(".")[0]
    return any(f == name or f == top for f in item_filter)


def _flatten(share: dict) -> dict:
    """{"a": 1, "b": {"c": 2}} → {"a": 1, "b.c": 2}"""
    flat = {}
    for key, value in share.items():
        if isinstance(value, dict):
            for sub, leaf in value.items():
                flat[f"{key}.{sub}"] = leaf
        else:
            flat[key] = value
    return flat


def _set_path(share: dict, name: str, value) -> None:
    if "." in name:
        top, sub = name.split(".", 1)
        share.setdefault(top, {})[sub] = value
    else:
        share[name] = value


def _del_path(share: dict, name: str) -> None:
    if "." in name:
        top, sub = name.split(".", 1)
        branch = share.get(top)
        if isinstance(branch, dict):
            branch.pop(sub, None)
            if not branch:
                share.pop(top, None)
    else:
        share.pop(name, None)


class ECProducer:
    def __init__(self, service, share: dict | None = None):
        self.service = service
        self.runtime = service.runtime
        self.share = share if share is not None else {}
        # Maintained flattened view: the producer
        # used to call _flatten(self.share) — a full dict rebuild — on
        # EVERY get/update existence check and again per consumer sync,
        # an O(n)-per-operation pattern that collapses at session
        # cardinality (1e5 keys × a sync storm = 1e10 key visits).
        # The view is updated incrementally on update/remove (O(1) per
        # leaf; O(branch) only when a whole top-level branch is
        # replaced or removed), so a sync is O(items shipped) and a
        # get/update is O(1).  Invariant: all mutations go through
        # update()/remove() (the remote command path already does) —
        # writing producer.share[...] directly was never part of the
        # API and now additionally bypasses delta publication.
        self._flat = _flatten(self.share)
        self._handlers = []       # handler(command, name, value)
        # response_topic → {"lease": Lease, "filter": ...}
        self._consumers: dict[str, dict] = {}
        self.runtime.add_message_handler(
            self._control_handler, service.topic_control)

    # -- local API ---------------------------------------------------------
    def get(self, name: str, default=None):
        if name in self._flat:
            return self._flat[name]
        return self.share.get(name, default)

    def update(self, name: str, value) -> None:
        exists = name in self._flat or name in self.share
        self._flat_forget(name)
        _set_path(self.share, name, value)
        if "." not in name and isinstance(value, dict):
            for sub, leaf in value.items():
                self._flat[f"{name}.{sub}"] = leaf
        else:
            self._flat[name] = value
        command = "update" if exists else "add"
        self._notify(command, name, value)

    def remove(self, name: str) -> None:
        self._flat_forget(name)
        _del_path(self.share, name)
        self._notify("remove", name, None)

    def _flat_forget(self, name: str) -> None:
        """Drop `name`'s current leaves from the flat view, BEFORE the
        backing dict changes (a replaced top-level branch enumerates
        its old keys from the share, not by scanning the view)."""
        if "." in name:
            self._flat.pop(name, None)
            return
        old = self.share.get(name)
        if isinstance(old, dict):
            for sub in old:
                self._flat.pop(f"{name}.{sub}", None)
        self._flat.pop(name, None)

    def keys(self):
        return list(self._flat.keys())

    def add_handler(self, handler) -> None:
        self._handlers.append(handler)

    def remove_handler(self, handler) -> None:
        if handler in self._handlers:
            self._handlers.remove(handler)

    def terminate(self) -> None:
        """Detach from the control topic and drop all consumer leases."""
        self.runtime.remove_message_handler(self._control_handler,
                                            self.service.topic_control)
        for consumer in self._consumers.values():
            consumer["lease"].terminate()
        self._consumers.clear()
        self._handlers.clear()

    # -- wire protocol -----------------------------------------------------
    def _control_handler(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "share" and len(params) >= 2:
            response_topic = params[0]
            lease_time = parse_int(params[1], int(EC_LEASE_TIME))
            item_filter = params[2] if len(params) > 2 else "*"
            if len(params) > 3:
                item_filter = params[2:]
            self._handle_share(response_topic, lease_time, item_filter)
        elif command in ("add", "update") and len(params) >= 2:
            value = _decode_value(params[1])
            self.update(params[0], value)
        elif command == "remove" and params:
            self.remove(params[0])

    def _handle_share(self, response_topic, lease_time, item_filter) -> None:
        existing = self._consumers.get(response_topic)
        if existing:
            existing["lease"].extend(lease_time)
            existing["filter"] = item_filter
        else:
            lease = Lease(self.runtime.event, lease_time, response_topic,
                          lease_expired_handler=self._lease_expired)
            self._consumers[response_topic] = {
                "lease": lease, "filter": item_filter}
        self._synchronize(response_topic, item_filter)

    def _lease_expired(self, response_topic) -> None:
        self._consumers.pop(response_topic, None)

    def _synchronize(self, response_topic, item_filter) -> None:
        items = [(k, v) for k, v in self._flat.items()
                 if filter_matches_item(item_filter, k)]
        publish = self.runtime.publish
        publish(response_topic, generate("item_count", [str(len(items))]))
        for name, value in items:
            publish(response_topic,
                    generate("add", [name, generate_sexpr(value)]))
        # end-of-snapshot marker on the response topic: per-publisher FIFO
        # ordering makes this arrive after every snapshot item, so the
        # consumer synchronizes on it rather than counting adds (counting
        # mis-fires when live deltas interleave with the snapshot);
        # topic_out carries it too for observers (reference: share.py:322-333)
        publish(response_topic, generate("sync", [response_topic]))
        publish(self.service.topic_out,
                generate("sync", [response_topic]))

    def _notify(self, command, name, value) -> None:
        for handler in list(self._handlers):
            handler(command, name, value)
        for response_topic, consumer in list(self._consumers.items()):
            if filter_matches_item(consumer["filter"], name):
                params = [name] if command == "remove" else \
                    [name, generate_sexpr(value)]
                self.runtime.publish(response_topic,
                                     generate(command, params))


def _decode_value(value):
    """Invert the producer's generate_sexpr encoding, then fold scalar
    strings back to bool/int/float (the wire is typeless).

    Without the parse_sexpr step, any string containing spaces/parens
    came back wearing its canonical length prefix ("34:devices=..."),
    and lists/dicts came back as their unparsed source text."""
    if isinstance(value, str):
        try:
            value = parse_sexpr(value)
        except Exception:
            pass
    return _fold_scalars(value)


def _fold_scalars(value):
    if isinstance(value, str):
        if value == "true":
            return True
        if value == "false":
            return False
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                continue
        return value
    if isinstance(value, list):
        return [_fold_scalars(item) for item in value]
    if isinstance(value, dict):
        return {key: _fold_scalars(item) for key, item in value.items()}
    return value


class ECConsumer:
    def __init__(self, runtime, cache: dict, producer_topic_control: str,
                 item_filter="*", lease_time: float = EC_LEASE_TIME):
        self.runtime = runtime
        self.cache = cache
        self.producer_topic_control = producer_topic_control
        self.item_filter = item_filter
        self.lease_time = lease_time
        self.synchronized = False
        self._handlers = []       # handler(command, item_name, value)
        self._expected = None
        self._lease = None
        # share-request dedup: a reconnect flap
        # storm — N connection transitions inside one lease window —
        # must hold ONE outstanding share request, not N.  Each request
        # makes the producer replay the full filtered snapshot; N
        # requests at session cardinality is an N×n item storm.  The
        # outstanding flag clears on the sync marker (the snapshot
        # completed) or on a timeout (the producer died mid-snapshot;
        # the next lease extension re-requests).
        self.stats = {"share_requests": 0, "share_requests_deduped": 0}
        self._request_outstanding = False
        self._request_timer = None
        self._was_connected = False
        self.response_topic = (f"{runtime.topic_path}/0/ec/"
                               f"{next(_consumer_counter)}")
        runtime.add_message_handler(self._consumer_handler,
                                    self.response_topic)
        runtime.connection.add_handler(self._connection_handler)

    def _connection_handler(self, _connection, state) -> None:
        if state < ConnectionState.TRANSPORT:
            # transport lost: the NEXT recovery resynchronizes (once)
            self._was_connected = False
            return
        if self._lease is None:
            self._lease = Lease(
                self.runtime.event, self.lease_time, self.response_topic,
                lease_extend_handler=lambda *_: self._share_request(),
                automatic_extend=True)
            self._share_request()
        elif not self._was_connected:
            # reconnect: the producer may have expired our lease while
            # we were gone — resync, deduped across flap storms
            self._share_request()
        self._was_connected = True

    def _share_request(self) -> None:
        if self._request_outstanding:
            self.stats["share_requests_deduped"] += 1
            return
        self._request_outstanding = True
        timeout = max(1.0, min(self.lease_time * 0.4, 30.0))
        self._request_timer = self.runtime.event.add_oneshot_handler(
            self._request_expired, timeout)
        self.stats["share_requests"] += 1
        item_filter = self.item_filter
        params = [self.response_topic, str(int(self.lease_time))]
        if isinstance(item_filter, (list, tuple)):
            params.extend(item_filter)
        else:
            params.append(item_filter)
        self.runtime.publish(self.producer_topic_control,
                             generate("share", params))

    def _request_expired(self) -> None:
        # no sync marker arrived inside the window: stop holding the
        # dedup gate shut so the next extend/reconnect can re-request
        self._request_timer = None
        self._request_outstanding = False

    def _request_settled(self) -> None:
        self._request_outstanding = False
        if self._request_timer is not None:
            self.runtime.event.remove_timer_handler(self._request_timer)
            self._request_timer = None

    def _consumer_handler(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "item_count" and params:
            self._expected = parse_int(params[0])    # diagnostic only
        elif command in ("add", "update") and len(params) >= 2:
            self.cache[params[0]] = _decode_value(params[1])
            self._fire(command, params[0], self.cache[params[0]])
        elif command == "remove" and params:
            self.cache.pop(params[0], None)
            self._fire("remove", params[0], None)
        elif command == "sync":
            # end-of-snapshot marker: ordered after every snapshot item
            # by per-publisher FIFO, immune to interleaved live deltas
            # (counting adds is not — they decrement the count early)
            self._expected = None
            self._request_settled()
            if not self.synchronized:
                self.synchronized = True
                self._fire("sync", None, None)

    def _fire(self, command, name, value) -> None:
        for handler in list(self._handlers):
            handler(command, name, value)

    def add_handler(self, handler) -> None:
        self._handlers.append(handler)

    def terminate(self) -> None:
        if self._lease:
            self._lease.terminate()
        self._request_settled()
        self.runtime.connection.remove_handler(self._connection_handler)
        self.runtime.remove_message_handler(self._consumer_handler,
                                            self.response_topic)


class ServicesCache:
    """Local replica of the registrar's service table."""

    def __init__(self, runtime, history_limit: int = 64):
        self.runtime = runtime
        self.services = Services()
        self.history: list[ServiceFields] = []
        self.history_limit = history_limit
        self.synchronized = False
        self._handlers = []       # (handler, ServiceFilter)
        self._expected = None
        self._registrar_out = None
        self.response_topic = (f"{runtime.topic_path}/0/cache/"
                               f"{next(_consumer_counter)}")
        runtime.add_message_handler(self._response_handler,
                                    self.response_topic)
        runtime.add_registrar_handler(self._registrar_handler)

    def _registrar_handler(self, registrar) -> None:
        if registrar is None:
            self.synchronized = False
            return
        registrar_out = f"{registrar['topic_path']}/out"
        if self._registrar_out != registrar_out:
            if self._registrar_out:
                self.runtime.remove_message_handler(self._event_handler,
                                                    self._registrar_out)
            self._registrar_out = registrar_out
            self.runtime.add_message_handler(self._event_handler,
                                             registrar_out)
        self.runtime.publish(
            f"{registrar['topic_path']}/in",
            generate("share", [self.response_topic, str(int(EC_LEASE_TIME)),
                               "*"]))

    def _response_handler(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "item_count" and params:
            self._expected = parse_int(params[0])
            if self._expected == 0:
                self._expected = None
                self.synchronized = True
        elif command == "add" and params:
            self._add_record(params[0])
            if self._expected is not None:
                self._expected -= 1
                if self._expected <= 0:
                    self._expected = None
                    self.synchronized = True

    def _event_handler(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "add" and params:
            self._add_record(params[0])
        elif command == "remove" and params:
            fields = self.services.remove(params[0])
            if fields is not None:
                self._remember(fields)
                self._fire("remove", fields)

    def _add_record(self, record) -> None:
        if isinstance(record, str):
            record = parse_sexpr(record)
        try:
            fields = ServiceFields.from_record(record)
        except Exception:
            return
        self.services.add(fields)
        self._fire("add", fields)

    def _remember(self, fields) -> None:
        self.history.insert(0, fields)
        del self.history[self.history_limit:]

    def _fire(self, command, fields) -> None:
        for handler, service_filter in list(self._handlers):
            if service_filter.matches(fields):
                handler(command, fields)

    def add_handler(self, handler, service_filter: ServiceFilter) -> None:
        """handler(command, ServiceFields); replays current matches."""
        self._handlers.append((handler, service_filter))
        for fields in self.services.filter(service_filter):
            handler("add", fields)

    def remove_handler(self, handler) -> None:
        self._handlers = [(h, f) for h, f in self._handlers if h != handler]

    def get_services(self) -> Services:
        return self.services

    def terminate(self) -> None:
        """Detach all transport subscriptions and handlers."""
        self.runtime.remove_message_handler(self._response_handler,
                                            self.response_topic)
        if self._registrar_out:
            self.runtime.remove_message_handler(self._event_handler,
                                                self._registrar_out)
            self._registrar_out = None
        self._handlers.clear()
