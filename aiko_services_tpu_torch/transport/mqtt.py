# MQTT transport (optional): real-broker interop for multi-host control.
#
# The port's own copy of aiko_services_tpu/transport/mqtt.py: connect
# with LWT, TLS/credentials, subscribe/unsubscribe, wait-for-publish,
# automatic reconnect with exponential backoff, re-subscribe after
# reconnect, and bounded buffering of publishes made while disconnected.
#
# Reconnect ownership: a real paho client reconnects ITSELF — its
# loop_start thread retries with reconnect_delay_set backoff, and racing
# a second reconnect() against it corrupts the socket state.  So with
# paho we configure its backoff and stand down; the timer-based
# machinery below drives reconnection only for injected clients (tests,
# alternative transports) that do not auto-reconnect.
#
# The underlying client is injectable (`client_factory`) so the
# machinery is testable without a live broker; the default factory
# builds a real paho client.  Gated on paho-mqtt being installed; the
# in-memory broker is the default transport so nothing in the framework
# requires it.  paho is imported only when a real client is built, never
# when this module is imported: the card's machine has no paho.

from __future__ import annotations

import importlib.util
import random
import threading
from collections import deque

from ..observe.metrics import MirroredStats
from ..utils import get_logger, jittered_backoff
from .message import Message
from .wire import is_envelope

__all__ = ["MQTT_AVAILABLE", "MQTTMessage"]

MQTT_AVAILABLE = importlib.util.find_spec("paho") is not None

_BACKOFF_MIN = 0.5         # seconds; doubles per failed attempt
_BACKOFF_MAX = 30.0
_BACKOFF_JITTER = 0.25     # fraction of the delay added, seeded rng —
                           # a broker restart must not get every client
                           # redialing on the same doubling schedule
_BUFFER_LIMIT = 1024       # publishes held while disconnected

logger = get_logger("transport.mqtt")


def _paho():               # pragma: no cover - needs paho installed
    import paho.mqtt.client as paho
    return paho


def _paho_factory():       # pragma: no cover - needs paho installed
    if not MQTT_AVAILABLE:
        raise ImportError(
            "paho-mqtt is not installed; use the memory transport or "
            "install paho-mqtt for multi-host control planes")
    paho = _paho()
    return paho.Client(callback_api_version=paho.CallbackAPIVersion.VERSION2)


def _is_failure(reason_code) -> bool:
    """True when a CONNACK reason code reports failure (paho v2 passes a
    ReasonCode object; fakes/v1 pass an int, 0 = success)."""
    if hasattr(reason_code, "is_failure"):
        return bool(reason_code.is_failure)
    return bool(reason_code)


class MQTTMessage(Message):
    """Message transport over an MQTT broker.

    The client object must expose the paho v2 surface used here:
    connect/reconnect/disconnect, loop_start/loop_stop, subscribe/
    unsubscribe, publish, will_set, and the on_connect/on_disconnect/
    on_message callback slots."""

    BINARY = True       # MQTT payloads are bytes; envelopes pass through

    def __init__(self, on_message=None, subscriptions=(),
                 host="localhost", port=1883, username=None, password=None,
                 tls=False, lwt_topic=None, lwt_payload=None,
                 lwt_retain=False, client_factory=None,
                 backoff_min=_BACKOFF_MIN, backoff_max=_BACKOFF_MAX,
                 backoff_jitter=_BACKOFF_JITTER, jitter_seed=None,
                 buffer_limit=_BUFFER_LIMIT):
        super().__init__(on_message, subscriptions)
        self.host, self.port = host, port
        self.backoff_min, self.backoff_max = backoff_min, backoff_max
        self.backoff_jitter = backoff_jitter
        # seeded so tests reproduce the exact delay sequence; None keeps
        # production spread (urandom-seeded)
        self._jitter_rng = random.Random(jitter_seed)
        self._attempts = 0          # consecutive reconnect attempts
        self._connected_event = threading.Event()
        self._closing = False
        self._lock = threading.RLock()
        self._pending = deque(maxlen=buffer_limit)   # (topic, payload, retain)
        self._reconnect_timer = None
        # counter increments mirror onto the metrics registry
        # (mqtt_client_events_total{kind=...}); last_error is a string
        # and stays dict-only
        self.stats = MirroredStats(
            {"reconnects": 0, "buffered": 0, "dropped": 0,
             "last_error": None},
            metric="mqtt_client_events_total",
            help="MQTT client lifecycle/buffering events by kind")

        self._client = (client_factory or _paho_factory)()
        # paho's network-loop thread auto-reconnects; give it our backoff
        # and let it own reconnection (see module docstring)
        self._client_reconnects = MQTT_AVAILABLE and \
            isinstance(self._client, _paho().Client)
        if self._client_reconnects:              # pragma: no cover - paho
            # paho takes integer seconds and requires min <= max
            min_delay = max(1, int(round(backoff_min)))
            self._client.reconnect_delay_set(
                min_delay=min_delay,
                max_delay=max(min_delay, int(round(backoff_max))))
        if username:
            self._client.username_pw_set(username, password)
        if tls:                                      # pragma: no cover
            self._client.tls_set()
        if lwt_topic is not None:
            self._client.will_set(lwt_topic, lwt_payload, retain=lwt_retain)
        self._client.on_connect = self._on_connect
        self._client.on_disconnect = self._on_disconnect
        self._client.on_message = self._on_paho_message

    # -- callbacks (broker/network thread) --------------------------------
    def _on_connect(self, client, userdata, flags, reason_code,
                    properties=None):
        if _is_failure(reason_code):
            # rejected CONNACK (bad credentials, not authorized, ...):
            # NOT a connection — the broker will close the socket
            self.stats["last_error"] = f"connect rejected: {reason_code}"
            logger.warning("MQTT connect rejected by %s:%s: %s",
                           self.host, self.port, reason_code)
            return
        # re-subscribe EVERY topic on EVERY (re)connect: broker-side
        # session state cannot be assumed (clean-session default)
        for topic in tuple(self.subscriptions):
            client.subscribe(topic)
        self._attempts = 0
        # drain the buffer BEFORE announcing connected: a concurrent
        # publish() seeing connected()=True must not overtake buffered
        # messages (retained last-write-wins topics would invert state)
        self._flush_pending()
        self._connected_event.set()
        self._flush_pending()       # anything buffered during the drain

    def _on_disconnect(self, client, userdata, flags, reason_code=None,
                       properties=None):
        self._connected_event.clear()
        if not self._closing and not self._client_reconnects:
            self._schedule_reconnect()

    def _on_paho_message(self, client, userdata, message):
        if self.on_message is not None:
            payload = message.payload
            if not is_envelope(payload):
                try:
                    payload = payload.decode("utf-8")
                except UnicodeDecodeError:
                    pass    # binary topic: hand bytes through
            self.on_message(message.topic, payload)

    # -- reconnect machinery (non-paho clients only) -----------------------
    def _schedule_reconnect(self) -> None:
        with self._lock:
            if self._closing or (self._reconnect_timer is not None
                                 and self._reconnect_timer.is_alive()):
                return
            # jittered exponential backoff (shared formula, utils/
            # backoff.py) so a fleet of clients fans out instead of
            # stampeding the broker together
            self._attempts += 1
            delay = jittered_backoff(
                self.backoff_min, self._attempts, self.backoff_max,
                self.backoff_jitter, self._jitter_rng)
            timer = threading.Timer(delay, self._attempt_reconnect)
            timer.daemon = True
            self._reconnect_timer = timer
            timer.start()

    def _attempt_reconnect(self) -> None:
        # the lock spans the closing-check AND the reconnect so a
        # concurrent disconnect() cannot interleave (reconnect-after-
        # shutdown); RLock + fakes calling _on_connect synchronously is
        # re-entrant-safe
        with self._lock:
            self._reconnect_timer = None
            if self._closing or self.connected():
                return
            self.stats["reconnects"] += 1
            try:
                self._client.reconnect()
            except Exception as exc:
                self.stats["last_error"] = repr(exc)
                logger.warning("MQTT reconnect to %s:%s failed (%r); "
                               "retrying in ~%.1fs",
                               self.host, self.port, exc,
                               min(self.backoff_min * (2 ** self._attempts),
                                   self.backoff_max))
                self._schedule_reconnect()    # next try, doubled backoff

    def _flush_pending(self) -> None:
        # serialized so two threads (on_connect network thread + a
        # publish() caller hitting the re-check) cannot interleave pops
        # and reorder the buffered messages.  Publishing under the lock
        # is deliberate here — paho's publish() only enqueues to its own
        # network thread, and releasing between pop and publish would
        # reopen the reorder window the lock exists to close.
        with self._lock:
            while self._pending:
                try:
                    topic, payload, retain = self._pending.popleft()
                except IndexError:        # pragma: no cover - race
                    break
                # graft: disable=lint-publish-locked (see comment above)
                self._client.publish(topic, payload, retain=retain)

    # -- Message interface -------------------------------------------------
    def connect(self, timeout=5.0) -> None:
        self._closing = False
        try:
            self._client.connect(self.host, self.port)
        except Exception as exc:
            self.stats["last_error"] = repr(exc)
            logger.warning("MQTT connect to %s:%s failed (%r)",
                           self.host, self.port, exc)
            self._client.loop_start()
            if not self._client_reconnects:
                self._schedule_reconnect()
            return
        self._client.loop_start()
        self._connected_event.wait(timeout)

    def disconnect(self) -> None:
        with self._lock:
            self._closing = True
            if self._reconnect_timer is not None:
                self._reconnect_timer.cancel()
                self._reconnect_timer = None
        self._client.loop_stop()
        self._client.disconnect()
        self._connected_event.clear()

    def crash(self) -> None:
        """Simulate abrupt process death (tests / chaos soaks): stop
        the reconnect machinery, then sever the link UNGRACEFULLY so
        the broker fires this client's LWT.  Loopback clients
        (transport/paho_loopback.py) expose drop() for the ungraceful
        cut; against a real paho client the socket is simply abandoned
        — the broker's keepalive generates the LWT."""
        with self._lock:
            self._closing = True
            if self._reconnect_timer is not None:
                self._reconnect_timer.cancel()
                self._reconnect_timer = None
        drop = getattr(self._client, "drop", None)
        if drop is not None:
            drop()
        else:                               # pragma: no cover — real paho
            self._client.loop_stop()
        self._connected_event.clear()

    def connected(self) -> bool:
        return self._connected_event.is_set()

    def wait_connected(self, timeout=5.0) -> bool:
        return self._connected_event.wait(timeout)

    def publish(self, topic, payload, retain=False, wait=False) -> None:
        if not self.connected():
            # wait=True means the caller needs delivery, not buffering
            # (e.g. presence marker before exit): give the reconnect a
            # bounded chance first
            if not (wait and self._connected_event.wait(2.0)):
                self.stats["buffered"] += 1
                if len(self._pending) == self._pending.maxlen:
                    self.stats["dropped"] += 1
                self._pending.append((topic, payload, retain))
                # a reconnect may have flushed between the check and the
                # append — drain again so the message cannot strand
                if self.connected():
                    self._flush_pending()
                return
        info = self._client.publish(topic, payload, retain=retain)
        if wait and hasattr(info, "wait_for_publish"):
            info.wait_for_publish(timeout=2.0)

    def subscribe(self, topic) -> None:
        self.subscriptions.add(topic)
        # always forward: if the resubscribe loop in _on_connect already
        # snapshotted (race), this call lands it; while disconnected paho
        # returns MQTT_ERR_NO_CONN without raising and the next
        # _on_connect replays from self.subscriptions
        try:
            self._client.subscribe(topic)
        except Exception:
            pass

    def unsubscribe(self, topic) -> None:
        self.subscriptions.discard(topic)
        try:
            self._client.unsubscribe(topic)
        except Exception:
            pass

    def set_last_will_and_testament(self, topic, payload,
                                    retain=False) -> None:
        """LWT can only change on (re)connect: cycle the connection if
        live (reference behavior: aiko_services/message/mqtt.py:187-196)."""
        self._client.will_set(topic, payload, retain=retain)
        if self.connected():
            # paho auto-reconnects only on UNEXPECTED drops; after a
            # requested disconnect we must redial explicitly
            self._client.disconnect()
            if self._client_reconnects:          # pragma: no cover - paho
                try:
                    self._client.reconnect()
                except Exception as exc:
                    self.stats["last_error"] = repr(exc)
