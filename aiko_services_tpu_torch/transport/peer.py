# Peer data plane: registrar-negotiated direct binary channels.
#
# The port's own copy of aiko_services_tpu/transport/peer.py.  The broker
# carries discovery, control, and the channel HANDSHAKE; bulk data-plane
# envelopes (transport/wire.py) move over direct peer channels negotiated
# through that control plane.
#
#   * PeerHost      — one per ProcessRuntime: advertises an endpoint in
#                     the service discovery record (tag "peer=..."),
#                     answers broker-mediated handshakes, owns the
#                     channel table and the topic→channel pin map the
#                     runtime's publish() consults;
#   * MemoryPeerChannel — same-process peers: envelopes hop straight
#                     from the sender into the receiver runtime's event
#                     queue (no broker lock, no routing, no per-client
#                     queues);
#   * SocketPeerChannel — same-host peers over a unix socket, cross-host
#                     peers over TCP: length-prefixed frames carrying
#                     (topic, payload), one reader and one writer thread
#                     per connection, inbound frames marshalled onto the
#                     event engine;
#   * ChaosPeerChannel — the chaos seam: a FaultPlan gets the same
#                     drop / delay / duplicate / truncate / partition
#                     control over peer channels it has over the broker
#                     (transport/chaos.py), applied on the SEND side.
#
# Negotiation (all over the broker, so it inherits its delivery
# guarantees and its chaos):
#
#   caller                                  serving
#   ------                                  -------
#   read "peer=kind:addr:nonce" tag from the discovery record
#   (peer_open hs_id reply_topic name
#              own_endpoint nonce kind
#              (reply_topics...))  ──────►  nonce == current?  no → refuse
#                                           accept_handler veto? → refuse
#                                           create/expect channel, pin
#                                           reply_topics → channel
#   pin data topics → channel     ◄──────  (peer_accept hs_id chan_id
#                                           kind name)
#
# The nonce is minted per PeerHost incarnation: a stale discovery record
# from a restarted process fails the handshake loudly instead of
# pinning frames to a corpse.  Duplicate accepts (chaos duplication,
# caller retries) dedup on the handshake id.
#
# Fallback ladder — peer, then broker: a refused handshake, a dead
# channel, or a failover leaves (or puts back) the broker path; the
# pipeline's recovery machinery (retry, candidate rotation, in-flight
# redirect, dedup/replay) and tracing/deadlines ride either path
# unchanged because the envelope payload is byte-identical.  A channel
# death also schedules re-negotiation on the initiating side, so a
# transient kill degrades to the broker and then climbs back onto the
# direct path.
#
# Socket channels deliver from their reader threads in wall time.  A
# drive on a VirtualClock must not advance the clock while envelopes are
# still on a socket (hop leases and batch windows would expire early):
# in_flight(hosts) counts what the hosts' channels have queued but the
# other ends have not yet handed to their engines.

from __future__ import annotations

import contextlib
import itertools
import os
import random
import shutil
import socket
import struct
import tempfile
import threading
import uuid
from collections import deque

from ..observe.metrics import MirroredStats, default_registry
from ..service import ServiceTopicPath
from ..utils import Lock, generate, get_logger, jittered_backoff, parse
from .wire import is_envelope

__all__ = [
    "PeerHost", "PeerChannel", "MemoryPeerChannel", "SocketPeerChannel",
    "ChaosPeerChannel", "parse_endpoints", "in_flight", "PEER_TAG",
]

PEER_TAG = "peer"
_HANDSHAKE_TIMEOUT = 2.0        # seconds (engine clock)
_HANDSHAKE_ATTEMPTS = 3
_RENEGOTIATE_DELAY = 0.5        # base re-dial delay (doubles per redial)
_RENEGOTIATE_MAX_DELAY = 30.0
_MAX_REDIALS = 8                # then park the record on the cool-down
_GIVEUP_COOLDOWN = 60.0         # parked-record re-dial period: the
                                # registrar suppresses identical re-add
                                # events, so a caller that gave up must
                                # climb back on its OWN slow clock, not
                                # wait for a rediscovery that may never
                                # fire for an unchanged record
_ANSWERED_OPEN_CAP = 256        # served handshake ids kept for replay
_EXPECTED_HELLO_CAP = 64        # accepted-but-unconnected socket slots
_FRAME_HEAD = struct.Struct("<BIQ")     # is_text, topic_len, payload_len
_MAX_FRAME = 1 << 31            # sanity bound on one socket frame

logger = get_logger("transport.peer")

# Same-process endpoint table: token → PeerHost.  The "mem" flavor of a
# channel is just two hosts in one interpreter handing payloads to each
# other's event queues; this table is how a caller recognizes that the
# advertised endpoint lives in its own process.
_MEM_ENDPOINTS: dict[str, "PeerHost"] = {}
_channel_counter = itertools.count(1)


def parse_endpoints(tag_value: str) -> list[tuple]:
    """Parse a "peer" tag value into (kind, address, nonce) descriptors.

    Formats (joined by ","):  mem:<token>:<nonce>
                              uds:<path>:<nonce>
                              tcp:<host>:<port>:<nonce>
    """
    endpoints = []
    for desc in (tag_value or "").split(","):
        parts = desc.strip().split(":")
        if len(parts) < 3:
            continue
        kind = parts[0]
        if kind in ("mem", "uds"):
            endpoints.append((kind, ":".join(parts[1:-1]), parts[-1]))
        elif kind == "tcp" and len(parts) >= 4:
            try:
                port = int(parts[-2])
            except ValueError:
                # a malformed foreign tag must degrade to "no peer
                # endpoint", never raise into discovery handlers
                continue
            endpoints.append((kind, (":".join(parts[1:-2]), port),
                              parts[-1]))
    return endpoints


class PeerChannel:
    """One direct data-plane link.  send() returns False when the
    channel can no longer carry traffic — the caller falls back to the
    broker and the close path schedules re-negotiation."""

    kind = "?"

    def __init__(self, channel_id: str, peer_name: str = ""):
        self.channel_id = channel_id
        self.peer_name = peer_name      # remote runtime's name
        self.alive = True
        self.initiated = False          # True on the dialing side
        self.service_topic_path = None  # set on the dialing side
        self.sent = 0                   # per-channel counters (reports)
        self.received = 0
        self.close_reason = ""

    def send(self, topic: str, payload) -> bool:
        raise NotImplementedError

    def close(self, reason: str = "") -> None:
        raise NotImplementedError

    def info(self) -> dict:
        return {"kind": self.kind, "peer": self.peer_name,
                "alive": self.alive, "sent": self.sent,
                "received": self.received,
                "close_reason": self.close_reason}


class MemoryPeerChannel(PeerChannel):
    """Same-process channel: one shared pair of ends; send() enqueues
    straight into the remote runtime's event queue.  No broker lock, no
    subscription matching, no per-client queue — the entire per-message
    cost is one thread-safe queue append."""

    kind = "mem"

    def __init__(self, channel_id: str, host: "PeerHost", peer_name: str):
        super().__init__(channel_id, peer_name)
        self.host = host
        self.remote: "MemoryPeerChannel | None" = None   # other end

    @classmethod
    def pair(cls, channel_id: str, host_a: "PeerHost",
             host_b: "PeerHost") -> tuple:
        end_a = cls(channel_id, host_a, host_b.runtime.name)
        end_b = cls(channel_id, host_b, host_a.runtime.name)
        end_a.remote, end_b.remote = end_b, end_a
        return end_a, end_b

    def send(self, topic: str, payload) -> bool:
        remote = self.remote
        if not self.alive or remote is None or not remote.alive:
            return False
        self.sent += 1
        remote.received += 1
        remote.host._receive(topic, payload, remote)
        return True

    def close(self, reason: str = "") -> None:
        ends = [self, self.remote] if self.remote is not None else [self]
        for end in ends:
            if end.alive:
                end.alive = False
                end.close_reason = end.close_reason or reason
                end.host._channel_closed(end, reason)


class SocketPeerChannel(PeerChannel):
    """Localhost-unix-socket or TCP channel.  Frames are
    (is_text u8, topic_len u32, payload_len u64, topic, payload); a
    daemon reader thread per connection delivers inbound frames to the
    owning host, and a daemon WRITER thread drains a bounded outbound
    queue — send() never touches the socket, so a slow peer whose
    kernel buffer fills can never block the event loop (send keeps
    appending, the queue sheds its OLDEST frame past the cap, exactly
    the broker data plane's drop policy)."""

    TX_LIMIT = 1024             # outbound frames held for the writer

    def __init__(self, channel_id: str, host: "PeerHost", sock,
                 kind: str, peer_name: str = ""):
        super().__init__(channel_id, peer_name)
        self.kind = kind
        self.host = host
        self._sock = sock
        self._write_lock = Lock(f"peer.write.{channel_id}")
        self._tx: deque = deque()
        self._tx_ready = threading.Event()
        self.shed = 0           # outbound frames dropped at the cap

    def start_reader(self) -> None:
        for target, label in ((self._read_loop, "read"),
                              (self._write_loop, "write")):
            thread = threading.Thread(
                target=target, daemon=True,
                name=f"peer-{label}-{self.channel_id}")
            thread.start()

    # -- framing -----------------------------------------------------------
    @staticmethod
    def write_frame(sock, topic: str, payload) -> None:
        is_text = isinstance(payload, str)
        body = payload.encode("utf-8") if is_text else bytes(payload)
        topic_bytes = topic.encode("utf-8")
        sock.sendall(_FRAME_HEAD.pack(1 if is_text else 0,
                                      len(topic_bytes), len(body))
                     + topic_bytes + body)

    @staticmethod
    def read_exact(sock, count: int) -> bytes | None:
        chunks = []
        while count > 0:
            chunk = sock.recv(min(count, 1 << 20))
            if not chunk:
                return None
            chunks.append(chunk)
            count -= len(chunk)
        return b"".join(chunks)

    @classmethod
    def read_frame(cls, sock):
        head = cls.read_exact(sock, _FRAME_HEAD.size)
        if head is None:
            return None
        is_text, topic_len, payload_len = _FRAME_HEAD.unpack(head)
        if topic_len > _MAX_FRAME or payload_len > _MAX_FRAME:
            return None
        topic = cls.read_exact(sock, topic_len)
        body = cls.read_exact(sock, payload_len)
        if topic is None or body is None:
            return None
        return (topic.decode("utf-8"),
                body.decode("utf-8") if is_text else body)

    # -- channel interface -------------------------------------------------
    def send(self, topic: str, payload) -> bool:
        if not self.alive:
            return False
        with self._write_lock:
            if len(self._tx) >= self.TX_LIMIT:
                # streaming consumers want the freshest frame: shed the
                # stalest (hop retries/dedup recover request/response)
                self._tx.popleft()
                self.shed += 1
                self.host.stats["tx_shed"] += 1
            self._tx.append((topic, payload))
        self._tx_ready.set()
        self.sent += 1
        return True

    def _write_loop(self) -> None:
        while self.alive:
            self._tx_ready.wait(0.5)
            while True:
                with self._write_lock:
                    if not self._tx:
                        self._tx_ready.clear()
                        break
                    topic, payload = self._tx.popleft()
                try:
                    self.write_frame(self._sock, topic, payload)
                except OSError:
                    self.close("io-error")
                    return

    def _read_loop(self) -> None:
        while self.alive:
            try:
                frame = self.read_frame(self._sock)
            except (OSError, ValueError, UnicodeDecodeError):
                # a torn/corrupt frame poisons the whole stream (length
                # prefixes desync): treat it like a dead link — the
                # sender falls back to the broker and re-negotiates
                frame = None
            if frame is None:
                self.close("remote-closed")
                return
            # counted once the engine holds the frame: in_flight() reads
            # sent - received, and must not report an envelope that is
            # still on its way into the queue as delivered
            self.host._receive(frame[0], frame[1], self)
            self.received += 1

    def close(self, reason: str = "") -> None:
        if not self.alive:
            return
        self.alive = False
        self.close_reason = reason
        self._tx_ready.set()            # wake the writer so it exits
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self.host._channel_closed(self, reason)


class ChaosPeerChannel(PeerChannel):
    """FaultPlan seam for peer channels: wraps any channel and consults
    the plan per send — the same drop / delay / duplicate / truncate /
    partition vocabulary ChaosBroker applies per broker delivery
    (publish-side semantics, like ChaosMessage).  kill() severs the
    link as if the transport died: the wrapped channel closes, both
    sides unpin, and the initiator re-negotiates."""

    def __init__(self, inner: PeerChannel, plan, engine=None):
        self.inner = inner      # before base init: the alive property
        super().__init__(inner.channel_id, inner.peer_name)
        self.kind = inner.kind
        self.plan = plan
        self.engine = engine
        self.local_name = getattr(getattr(inner, "host", None),
                                  "client_id", "") or ""

    # state proxies: the raw channel owns liveness and counters
    @property
    def alive(self):                    # type: ignore[override]
        return self.inner.alive

    @alive.setter
    def alive(self, value):
        self.inner.alive = value

    def _now(self) -> float:
        return self.engine.clock.now() if self.engine is not None else 0.0

    def send(self, topic: str, payload) -> bool:
        if not self.inner.alive:
            return False
        verdict = self.plan.decide(topic, self.local_name,
                                   self.inner.peer_name, payload,
                                   self._now())
        if verdict.drop:
            return True         # "sent" — and lost on the wire
        delivered = payload
        if verdict.truncate_to is not None and \
                isinstance(payload, (bytes, bytearray, memoryview)):
            delivered = bytes(payload)[:verdict.truncate_to]
        ok = True
        for _ in range(1 + verdict.copies):
            if (verdict.delay > 0.0 or verdict.reorder) and \
                    self.engine is not None:
                self.engine.add_oneshot_handler(
                    lambda d=delivered: self.inner.send(topic, d),
                    verdict.delay)
            else:
                ok = self.inner.send(topic, delivered) and ok
        return ok

    def kill(self, reason: str = "chaos-kill") -> None:
        self.inner.close(reason)

    def close(self, reason: str = "") -> None:
        self.inner.close(reason)

    def info(self) -> dict:
        return self.inner.info()


class PeerHost:
    """The per-runtime peer data plane.

    Enable with ProcessRuntime.enable_peer(); afterwards every service
    this runtime registers advertises the endpoint tag, publish()
    consults the pin map, and inbound handshakes are answered on
    {topic_path}/0/peer.  kinds selects the channel flavors offered:
    "mem" (same process, always cheap), "uds" (same host), "tcp"
    (cross-host) — a caller picks the closest flavor it can reach.

    The JAX PeerHost offers "mem" whatever `kinds` says, so two runtimes
    of one process always pair in memory.  Here "mem" is offered, and
    dialed, only when `kinds` names it: kinds=("tcp",) on both sides of
    one process carries every envelope over a real socket (ROADMAP.md
    Queue 3 item 5)."""

    def __init__(self, runtime, kinds=("mem",), fault_plan=None,
                 tcp_host: str = "127.0.0.1", uds_dir: str | None = None,
                 accept_handler=None,
                 handshake_timeout: float = _HANDSHAKE_TIMEOUT,
                 handshake_attempts: int = _HANDSHAKE_ATTEMPTS,
                 renegotiate_delay: float = _RENEGOTIATE_DELAY,
                 data_queue_limit: int = 1024,
                 jitter_seed: int | None = None):
        self.runtime = runtime
        self.client_id = runtime.name
        self.nonce = uuid.uuid4().hex[:8]
        self.token = f"pr-{uuid.uuid4().hex[:10]}"
        self.fault_plan = fault_plan
        self.accept_handler = accept_handler    # (name, kind) -> ok|reason
        self.handshake_timeout = float(handshake_timeout)
        self.handshake_attempts = int(handshake_attempts)
        self.renegotiate_delay = float(renegotiate_delay)
        # the broker data plane bounds a slow consumer's queue and
        # sheds; the peer path mirrors that: at most
        # data_queue_limit channel-delivered envelopes may sit
        # unprocessed in the receiver's engine queue before inbound
        # channel deliveries are shed (counted, never silent)
        self.data_queue_limit = int(data_queue_limit)
        self._rx_pending = 0
        # re-dial jitter: unseeded spreads a fleet's redials for real;
        # seed it (chaos soak does) for bit-reproducible runs
        self._jitter_rng = random.Random(jitter_seed)
        self.closed = False
        self._lock = Lock(f"peer.host.{runtime.name}")
        self._channels: dict[str, PeerChannel] = {}
        self._pins: dict[str, PeerChannel] = {}     # topic → channel
        self._pending: dict[str, dict] = {}         # handshake_id → state
        self._offered: dict[str, PeerChannel] = {}  # mem ends awaiting adopt
        self._expected_hellos: dict[str, dict] = {}  # socket channel ids
        # serving side: answered handshake ids → accept params, so a
        # duplicated/retried peer_open replays the SAME accept instead
        # of building a second channel (bounded ring)
        self._answered_opens: dict[str, list] = {}
        # reply-pin attachment over a SHARED channel: a second pipeline
        # whose requests already ride an existing channel asks the
        # serving side to pin ITS reply topic too, instead of silently
        # taking broker replies forever.  (channel_id, topic) -> "pending" |
        # "acked"; dropped with the channel, re-sent when a pending
        # ask expires unanswered.
        self._attached: dict[tuple, str] = {}
        self._attach_pending: dict[str, dict] = {}
        # services whose accepted socket handshake is still dialing
        self._dialing: set[str] = set()
        # service_topic_path → negotiation record (for re-dialing)
        self._negotiations: dict[str, dict] = {}
        self._listeners: list = []      # (kind, sock, addr)
        self._endpoints: list[str] = []
        self.offers_mem = "mem" in kinds
        if self.offers_mem:
            self._endpoints.append(f"mem:{self.token}:{self.nonce}")
            _MEM_ENDPOINTS[self.token] = self
        if "uds" in kinds or "tcp" in kinds:
            self._start_listeners(kinds, tcp_host, uds_dir)
        self.topic_peer = f"{runtime.topic_path}/0/peer"
        runtime.add_message_handler(self._peer_handler, self.topic_peer)
        # aggregated across hosts (host names are unbounded — no label)
        self.stats = MirroredStats(
            {"sent": 0, "received": 0, "fallback": 0, "handshakes": 0,
             "accepted": 0, "refused": 0, "rejected_stale": 0,
             "dup_accepts": 0, "closed": 0, "renegotiations": 0,
             "expired_handshakes": 0, "rx_shed": 0, "tx_shed": 0,
             "attach_requests": 0, "attach_pins": 0, "attach_acks": 0},
            metric="peer_events_total",
            help="peer data-plane events by kind, all hosts")
        self._open_gauge = default_registry().gauge(
            "peer_channels_open", "currently-open peer channels")

    # -- advertisement -----------------------------------------------------
    @property
    def tag(self) -> str:
        """The discovery-record tag every service of this runtime
        advertises: peer=<desc>[,<desc>...]."""
        return f"{PEER_TAG}={','.join(self._endpoints)}"

    def _start_listeners(self, kinds, tcp_host, uds_dir) -> None:
        if "uds" in kinds and hasattr(socket, "AF_UNIX"):
            if uds_dir:
                directory = uds_dir
            else:
                directory = tempfile.mkdtemp(prefix="aiko_peer_")
                self._own_uds_dir = directory   # removed in close()
            path = os.path.join(directory, f"{self.token}.sock")
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            listener.bind(path)
            listener.listen(64)
            self._listeners.append(("uds", listener, path))
            self._endpoints.append(f"uds:{path}:{self.nonce}")
        if "tcp" in kinds:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((tcp_host, 0))
            listener.listen(64)
            host, port = listener.getsockname()[:2]
            self._listeners.append(("tcp", listener, (host, port)))
            self._endpoints.append(f"tcp:{host}:{port}:{self.nonce}")
        for kind, listener, _ in self._listeners:
            thread = threading.Thread(
                target=self._accept_loop, args=(kind, listener),
                daemon=True, name=f"peer-accept-{self.token}")
            thread.start()

    # -- hot path ----------------------------------------------------------
    def maybe_send(self, topic: str, payload) -> bool:
        """Try the peer data plane for one outbound message.  Only
        binary envelopes ride channels — text RPCs and retained state
        stay on the broker (they ARE the control plane)."""
        channel = self._pins.get(topic)
        if channel is None or not is_envelope(payload):
            return False
        if channel.send(topic, payload):
            self.stats["sent"] += 1
            return True
        # dead channel: shed the pin and let the broker carry this one
        # (the close path has/will schedule re-negotiation)
        self.stats["fallback"] += 1
        channel.close(channel.close_reason or "send-failed")
        return False

    def _receive(self, topic: str, payload, channel) -> None:
        """Inbound from a channel (any thread): hand to the runtime's
        transport-inbound path, which marshals onto the event engine.
        Bounded: past data_queue_limit unprocessed deliveries the
        newest inbound envelope is shed — a stalled receiver must not
        accumulate channel traffic without bound (the broker path's
        bounded per-client queues, mirrored)."""
        with self._lock:
            if self._rx_pending >= self.data_queue_limit:
                shed = True
            else:
                shed = False
                self._rx_pending += 1
        if shed:
            self.stats["rx_shed"] += 1
            return
        self.stats["received"] += 1
        self.runtime._on_transport_message(topic, payload,
                                           ack=self._rx_drained)

    def _rx_drained(self) -> None:
        with self._lock:
            self._rx_pending = max(0, self._rx_pending - 1)

    # -- caller side -------------------------------------------------------
    def negotiate(self, service_topic_path: str, tag_value: str,
                  pin_topics, reply_topics, _redial: bool = False) -> bool:
        """Open (or re-open) a channel to the process serving
        `service_topic_path`, advertised as `tag_value`.  pin_topics are
        the topics THIS host will send to over the channel; the serving
        side pins reply_topics back to it.  Idempotent: an existing pin
        or an in-flight handshake for the same service is left alone.
        Returns True when a handshake was started."""
        if self.closed:
            return False
        with self._lock:
            # record the CURRENT facts first, even when already pinned
            # or mid-handshake: a later re-negotiation (channel death)
            # must dial the freshest advertised endpoint, not the tag
            # from the original negotiation (a restarted service whose
            # re-add beat its LWT remove would otherwise strand us on
            # a stale nonce forever)
            record = self._negotiations.setdefault(
                service_topic_path,
                {"service": service_topic_path, "attempts": 0})
            # topics ACCUMULATE across negotiators: two pipelines
            # sharing one service each contribute their reply topic,
            # and a redial after a channel death must re-pin BOTH —
            # overwriting with the latest caller's list silently
            # stranded the earlier pipeline's replies on the broker
            # after every redial
            record.update({
                "tag": tag_value,
                "pin_topics": sorted(
                    set(record.get("pin_topics", ())) |
                    set(pin_topics)),
                "reply_topics": sorted(
                    set(record.get("reply_topics", ())) |
                    set(reply_topics))})
            if not _redial:
                # fresh EXTERNAL discovery facts earn a fresh retry/
                # redial budget (a service that once exhausted its
                # attempts must not keep a one-attempt budget forever);
                # internal re-dials keep their counters so the
                # escalation/cool-down ladder cannot be reset from
                # inside its own loop
                record["attempts"] = 0
                record["redials"] = 0
            pinned = next((self._pins[t] for t in pin_topics
                           if t in self._pins), None)
            missing: list = []
            if pinned is not None:
                # requests already ride a live channel: a SECOND
                # pipeline negotiating the same service only needs its
                # reply topics pinned on the serving side — attach
                # them over the existing channel instead of silently
                # leaving its replies on the broker.
                # The send happens OUTSIDE the lock (it publishes).
                missing = [t for t in reply_topics if pinned.alive and
                           (pinned.channel_id, t) not in self._attached]
                for topic in missing:
                    self._attached[(pinned.channel_id, topic)] = \
                        "pending"
            elif service_topic_path in self._dialing or \
                    any(p["service"] == service_topic_path
                        for p in self._pending.values()):
                return False
        if pinned is not None:
            if missing:
                self._send_attach(service_topic_path, pinned, missing)
            return False
        return self._dial(record)

    def _choose_endpoint(self, tag_value: str):
        """Closest reachable flavor wins: mem (same process, when this
        host offers mem too: the serving side pairs with our mem end) >
        uds (same host) > tcp."""
        endpoints = parse_endpoints(tag_value)
        for kind, address, nonce in endpoints:
            if kind == "mem" and self.offers_mem and \
                    address in _MEM_ENDPOINTS:
                return (kind, address, nonce)
        for preferred in ("uds", "tcp"):
            for kind, address, nonce in endpoints:
                if kind == preferred:
                    return (kind, address, nonce)
        return None

    def _dial(self, record: dict) -> bool:
        chosen = self._choose_endpoint(record.get("tag", ""))
        if chosen is None:
            return False
        kind, address, nonce = chosen
        handshake_id = uuid.uuid4().hex[:12]
        state = {"service": record["service"], "kind": kind,
                 "address": address, "nonce": nonce,
                 "pin_topics": record["pin_topics"],
                 "reply_topics": record["reply_topics"]}
        with self._lock:
            self._pending[handshake_id] = state
        state["timer"] = self.runtime.event.add_oneshot_handler(
            lambda: self._handshake_expired(handshake_id),
            self.handshake_timeout)
        self.stats["handshakes"] += 1
        parsed = ServiceTopicPath.parse(record["service"])
        process_path = parsed.process_path if parsed else record["service"]
        self.runtime.publish(
            f"{process_path}/0/peer",
            generate("peer_open",
                     [handshake_id, self.topic_peer, self.client_id,
                      ",".join(self._endpoints), nonce, kind,
                      list(record["reply_topics"])]))
        return True

    def _handshake_expired(self, handshake_id: str) -> None:
        with self._lock:
            state = self._pending.pop(handshake_id, None)
            # a mem end the serving side offered for this handshake is
            # now an orphan: close the pair so the serving side's
            # registered end (and its reply pin) is torn down too
            orphan = self._offered.pop(handshake_id, None)
        if orphan is not None:
            orphan.close("handshake-expired")
        if state is None:
            return
        self.stats["expired_handshakes"] += 1
        record = self._negotiations.get(state["service"])
        if record is None:
            return
        record["attempts"] += 1
        if record["attempts"] < self.handshake_attempts:
            self._dial(record)
        else:
            logger.warning(
                "peer %s: handshake with %s gave up after %d attempts; "
                "broker path until the cool-down re-dial",
                self.client_id, state["service"], record["attempts"])
            self._park_record(state["service"])

    # -- handshake protocol (broker messages) ------------------------------
    def _peer_handler(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "peer_open" and len(params) >= 7:
            self._on_peer_open(params)
        elif command == "peer_accept" and len(params) >= 4:
            self._on_peer_accept(params)
        elif command == "peer_refuse" and len(params) >= 2:
            self._on_peer_refuse(params)
        elif command == "peer_attach" and len(params) >= 5:
            self._on_peer_attach(params)
        elif command == "peer_attached" and len(params) >= 2:
            self._on_peer_attached(params)

    def _refuse(self, reply_topic, handshake_id, reason) -> None:
        self.stats["refused"] += 1
        self.runtime.publish(reply_topic,
                             generate("peer_refuse",
                                      [handshake_id, reason]))

    def _on_peer_open(self, params) -> None:
        handshake_id, reply_topic, caller_name, caller_endpoints, \
            nonce, kind = [str(p) for p in params[:6]]
        reply_topics = [str(t) for t in (params[6] or [])] \
            if isinstance(params[6], (list, tuple)) else [str(params[6])]
        if self.closed:
            return
        with self._lock:
            answered = self._answered_opens.get(handshake_id)
        if answered is not None:
            # duplicated (chaos) or retried peer_open: replay the SAME
            # accept — never build a second channel for one handshake
            self.runtime.publish(reply_topic,
                                 generate("peer_accept", answered))
            return
        if nonce != self.nonce:
            # a restarted incarnation minted a fresh nonce: the caller
            # is dialing a stale discovery record — refuse loudly so it
            # stays on the (correct) broker path until rediscovery
            self.stats["rejected_stale"] += 1
            self._refuse(reply_topic, handshake_id, "stale-nonce")
            return
        if self.accept_handler is not None:
            verdict = self.accept_handler(caller_name, kind)
            if verdict not in (True, None):
                self._refuse(reply_topic, handshake_id,
                             str(verdict) if verdict else "refused")
                return
        if kind == "mem":
            caller_host = None
            for ep_kind, address, _ in parse_endpoints(caller_endpoints):
                if ep_kind == "mem":
                    caller_host = _MEM_ENDPOINTS.get(address)
                    break
            if caller_host is None or caller_host.closed:
                self._refuse(reply_topic, handshake_id, "no-mem-endpoint")
                return
            channel_id = f"ch-{next(_channel_counter)}"
            ours, theirs = MemoryPeerChannel.pair(channel_id, self,
                                                 caller_host)
            self._register(ours, reply_topics)
            with caller_host._lock:
                caller_host._offered[handshake_id] = theirs
                # bound the adoption table: if offers pile up (accepts
                # all dropped AND expiry cleanup raced), the oldest
                # pair is torn down rather than leaked
                evicted = []
                while len(caller_host._offered) > _EXPECTED_HELLO_CAP:
                    evicted.append(caller_host._offered.pop(
                        next(iter(caller_host._offered))))
            for channel in evicted:
                channel.close("offer-evicted")
        elif kind in ("uds", "tcp"):
            channel_id = f"ch-{next(_channel_counter)}"
            with self._lock:
                self._expected_hellos[channel_id] = {
                    "reply_topics": reply_topics,
                    "peer_name": caller_name}
                # accepted-but-never-connected slots must not pile up
                # under a flaky dialer: oldest expectations expire
                while len(self._expected_hellos) > _EXPECTED_HELLO_CAP:
                    self._expected_hellos.pop(
                        next(iter(self._expected_hellos)))
        else:
            self._refuse(reply_topic, handshake_id,
                         f"unsupported-kind-{kind}")
            return
        accept = [handshake_id, channel_id, kind, self.client_id]
        with self._lock:
            self._answered_opens[handshake_id] = accept
            while len(self._answered_opens) > _ANSWERED_OPEN_CAP:
                self._answered_opens.pop(next(iter(self._answered_opens)))
        self.stats["accepted"] += 1
        self.runtime.publish(reply_topic, generate("peer_accept", accept))

    def _on_peer_accept(self, params) -> None:
        handshake_id, channel_id, kind, serving_name = \
            [str(p) for p in params[:4]]
        with self._lock:
            state = self._pending.pop(handshake_id, None)
            # an accept for a handshake we no longer await (chaos
            # duplicate, or OUR side expired it and re-dialed while the
            # open was in flight): any mem end offered under that id is
            # an orphan — close the pair so the serving side's
            # registered end and reply pin are torn down too
            orphan = None if state is not None \
                else self._offered.pop(handshake_id, None)
        if state is None:
            if orphan is not None:
                orphan.close("stale-handshake")
            self.stats["dup_accepts"] += 1
            return
        self._cancel_handshake_timer(state)
        if kind == "mem":
            with self._lock:
                channel = self._offered.pop(handshake_id, None)
            if channel is None:
                return
            channel.peer_name = serving_name
            channel.initiated = True
            channel.service_topic_path = state["service"]
            self._register(channel, state["pin_topics"])
            self._note_attached(channel.channel_id,
                                state["reply_topics"])
            record = self._negotiations.get(state["service"])
            if record is not None:      # a live channel earns a clean
                record["attempts"] = 0  # retry/redial budget back
                record["redials"] = 0
        else:
            # sockets: connect + hello off the event loop — a dial to a
            # dead host must not stall every pipeline in the process.
            # Until the dial thread pins the channel the service counts
            # as negotiating: the JAX host forgets the handshake here,
            # and a discovery event in that window opens a second
            # channel (ROADMAP.md Queue 3 item 6)
            with self._lock:
                self._dialing.add(state["service"])
            thread = threading.Thread(
                target=self._connect_socket,
                args=(state, channel_id, kind, serving_name), daemon=True,
                name=f"peer-dial-{channel_id}")
            thread.start()

    def _connect_socket(self, state, channel_id, kind,
                        serving_name) -> None:
        try:
            self._dial_socket(state, channel_id, kind, serving_name)
        finally:
            with self._lock:
                self._dialing.discard(state["service"])

    def _dial_socket(self, state, channel_id, kind, serving_name) -> None:
        try:
            if kind == "uds":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(state["address"])
            else:
                sock = socket.create_connection(state["address"],
                                                timeout=5.0)
                sock.settimeout(None)
            SocketPeerChannel.write_frame(
                sock, "", f"peer_hello {channel_id} {self.client_id}")
        except OSError as exc:
            logger.warning("peer %s: %s dial to %r failed: %r",
                           self.client_id, kind, state["address"], exc)
            record = self._negotiations.get(state["service"])
            if record is not None:
                self._schedule_renegotiation(state["service"])
            return
        channel = SocketPeerChannel(channel_id, self, sock, kind,
                                    peer_name=serving_name)
        channel.initiated = True
        channel.service_topic_path = state["service"]
        self._register(channel, state["pin_topics"])
        self._note_attached(channel_id, state["reply_topics"])
        channel.start_reader()
        record = self._negotiations.get(state["service"])
        if record is not None:
            record["attempts"] = 0
            record["redials"] = 0

    # -- reply-pin attachment over a shared channel -----------------------
    def _send_attach(self, service_topic_path: str, channel,
                     topics) -> None:
        """Ask the serving side of an existing channel to pin `topics`
        (our reply topics) to it.  Rides the broker like the handshake;
        an unanswered ask expires and a later negotiate retries."""
        attach_id = uuid.uuid4().hex[:12]
        state = {"channel_id": channel.channel_id,
                 "topics": list(topics)}
        with self._lock:
            self._attach_pending[attach_id] = state
            while len(self._attach_pending) > _EXPECTED_HELLO_CAP:
                self._expire_attach_locked(
                    next(iter(self._attach_pending)))
        state["timer"] = self.runtime.event.add_oneshot_handler(
            lambda: self._attach_expired(attach_id),
            self.handshake_timeout)
        self.stats["attach_requests"] += 1
        parsed = ServiceTopicPath.parse(service_topic_path)
        process_path = parsed.process_path if parsed \
            else service_topic_path
        self.runtime.publish(
            f"{process_path}/0/peer",
            generate("peer_attach",
                     [attach_id, self.topic_peer, channel.channel_id,
                      self.client_id, list(topics)]))

    def _expire_attach_locked(self, attach_id: str) -> None:
        state = self._attach_pending.pop(attach_id, None)
        if state is None:
            return
        for topic in state["topics"]:
            key = (state["channel_id"], topic)
            if self._attached.get(key) == "pending":
                del self._attached[key]     # a later negotiate retries

    def _attach_expired(self, attach_id: str) -> None:
        with self._lock:
            self._expire_attach_locked(attach_id)

    def _on_peer_attach(self, params) -> None:
        """Serving side: pin the caller's reply topics to an ALREADY
        open channel it shares with another pipeline of the same
        process — no new handshake, no second channel."""
        attach_id, reply_topic, channel_id, _caller = \
            [str(p) for p in params[:4]]
        topics = [str(t) for t in (params[4] or [])] \
            if isinstance(params[4], (list, tuple)) else [str(params[4])]
        if self.closed:
            return
        with self._lock:
            channel = self._channels.get(channel_id)
            if channel is not None and channel.alive:
                for topic in topics:
                    self._pins[topic] = channel
            else:
                channel = None
        if channel is None:
            self._refuse(reply_topic, attach_id, "no-channel")
            return
        self.stats["attach_pins"] += len(topics)
        logger.info("peer %s: attached %r to channel %s",
                    self.client_id, topics, channel_id)
        self.runtime.publish(reply_topic,
                             generate("peer_attached",
                                      [attach_id, channel_id]))

    def _on_peer_attached(self, params) -> None:
        attach_id = str(params[0])
        with self._lock:
            state = self._attach_pending.pop(attach_id, None)
            if state is not None:
                for topic in state["topics"]:
                    key = (state["channel_id"], topic)
                    if key in self._attached:
                        self._attached[key] = "acked"
        if state is None:
            return
        timer = state.get("timer")
        if timer is not None:
            self.runtime.event.remove_timer_handler(timer)
        self.stats["attach_acks"] += 1

    def _on_peer_refuse(self, params) -> None:
        handshake_id, reason = str(params[0]), str(params[1])
        attach_timer = None
        with self._lock:
            state = self._pending.pop(handshake_id, None)
            if state is None and handshake_id in self._attach_pending:
                # a refused ATTACH (channel died serving-side): clear
                # the pending marks so a later negotiate retries or
                # re-dials with current facts
                attach_timer = \
                    self._attach_pending[handshake_id].get("timer")
                self._expire_attach_locked(handshake_id)
        if attach_timer is not None:
            self.runtime.event.remove_timer_handler(attach_timer)
            return
        if state is None:
            return
        self._cancel_handshake_timer(state)
        logger.info("peer %s: handshake with %s refused (%s); "
                    "broker path stays", self.client_id,
                    state["service"], reason)
        # a stale-nonce refusal means our endpoint record is outdated:
        # drop the negotiation — rediscovery (a fresh registrar add with
        # the new tag) re-triggers negotiate() with current facts
        if reason == "stale-nonce":
            self._negotiations.pop(state["service"], None)

    def _cancel_handshake_timer(self, state) -> None:
        timer = state.get("timer")
        if timer is not None:
            self.runtime.event.remove_timer_handler(timer)
            state["timer"] = None

    # -- socket listener side ----------------------------------------------
    def _accept_loop(self, kind, listener) -> None:
        while not self.closed:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            thread = threading.Thread(
                target=self._serve_connection, args=(kind, sock),
                daemon=True, name=f"peer-conn-{self.token}")
            thread.start()

    def _serve_connection(self, kind, sock) -> None:
        try:
            frame = SocketPeerChannel.read_frame(sock)
        except (OSError, ValueError, UnicodeDecodeError):
            # stray connections (port scanners, misdirected clients)
            # send arbitrary bytes: reject and close, never let the
            # accept path die with a leaked fd
            frame = None
        if frame is None:
            sock.close()
            return
        parts = str(frame[1] if isinstance(frame[1], str)
                    else frame[1].decode("utf-8", "replace")).split()
        if len(parts) != 3 or parts[0] != "peer_hello":
            sock.close()
            return
        channel_id, peer_name = parts[1], parts[2]
        with self._lock:
            expected = self._expected_hellos.pop(channel_id, None)
        if expected is None:
            sock.close()
            return
        channel = SocketPeerChannel(channel_id, self, sock, kind,
                                    peer_name=peer_name)
        self._register(channel, expected["reply_topics"])
        channel.start_reader()

    # -- channel table -----------------------------------------------------
    def _wrap(self, channel: PeerChannel) -> PeerChannel:
        if self.fault_plan is None:
            return channel
        wrapper = ChaosPeerChannel(channel, self.fault_plan,
                                   engine=self.runtime.event)
        wrapper.local_name = self.client_id
        return wrapper

    def _register(self, channel: PeerChannel, topics) -> None:
        wrapped = self._wrap(channel)
        with self._lock:
            self._channels[channel.channel_id] = wrapped
            for topic in topics:
                self._pins[topic] = wrapped
        self._open_gauge.inc()
        logger.info("peer %s: %s channel %s to %s pinned for %r",
                    self.client_id, channel.kind, channel.channel_id,
                    channel.peer_name, list(topics))

    def _note_attached(self, channel_id: str, topics) -> None:
        """Record reply topics the serving side pinned as part of the
        ORIGINAL negotiation, so a later negotiate over the shared
        channel only attaches genuinely new ones."""
        with self._lock:
            for topic in topics or ():
                self._attached[(channel_id, topic)] = "acked"

    def _channel_closed(self, channel: PeerChannel, reason: str) -> None:
        with self._lock:
            registered = self._channels.pop(channel.channel_id, None)
            if registered is None:
                return
            dead_topics = [t for t, c in self._pins.items()
                           if c.channel_id == channel.channel_id]
            for topic in dead_topics:
                del self._pins[topic]
            for key in [k for k in self._attached
                        if k[0] == channel.channel_id]:
                del self._attached[key]
        self.stats["closed"] += 1
        self._open_gauge.dec()
        service = self._channel_service(channel) or \
            self._channel_service(registered)
        if not self.closed and reason not in ("released", "shutdown") \
                and service is not None:
            self._schedule_renegotiation(service)

    @staticmethod
    def _channel_service(channel):
        """The dialed service a channel belongs to — set on the RAW
        channel, so look through a ChaosPeerChannel wrapper too."""
        if channel is None:
            return None
        service = getattr(channel, "service_topic_path", None)
        if service is None:
            service = getattr(getattr(channel, "inner", None),
                              "service_topic_path", None)
        return service

    def _schedule_renegotiation(self, service_topic_path: str) -> None:
        """A dead dialed channel climbs back: after a (growing) delay
        the negotiation record re-dials — fresh handshake, fresh nonce
        check — while traffic keeps flowing over the broker.  Redials
        back off exponentially and are CAPPED: a persistently
        unreachable endpoint (accepted handshake, unconnectable socket)
        drops the record after _MAX_REDIALS, and only a fresh discovery
        event (new registrar add with current facts) starts over."""
        record = self._negotiations.get(service_topic_path)
        if record is None or self.closed:
            return
        record["attempts"] = 0              # fresh handshake budget
        record["redials"] = record.get("redials", 0) + 1
        if record["redials"] > _MAX_REDIALS:
            logger.warning(
                "peer %s: channel to %s keeps dying (%d redials); "
                "broker path until the cool-down re-dial",
                self.client_id, service_topic_path, _MAX_REDIALS)
            self._park_record(service_topic_path)
            return
        # the shared fleet-safe backoff formula (utils/backoff.py): a
        # restarted serving killing N callers' channels at once must
        # not get N re-dials in lockstep every round
        delay = jittered_backoff(self.renegotiate_delay,
                                 record["redials"],
                                 _RENEGOTIATE_MAX_DELAY, 0.25,
                                 self._jitter_rng)
        self.stats["renegotiations"] += 1
        self.runtime.event.add_oneshot_handler(
            lambda: self._renegotiate(service_topic_path), delay)

    def _park_record(self, service_topic_path: str) -> None:
        """Handshake/redial budget exhausted: keep the negotiation
        record but only re-dial on a slow cool-down clock.  Rediscovery
        cannot be relied on to restart us — the registrar suppresses
        identical re-add events — so the climb-back is self-driven."""
        record = self._negotiations.get(service_topic_path)
        if record is None or self.closed:
            return
        record["attempts"] = 0
        record["redials"] = 0
        delay = _GIVEUP_COOLDOWN * \
            (1.0 + 0.25 * self._jitter_rng.random())
        self.runtime.event.add_oneshot_handler(
            lambda: self._renegotiate(service_topic_path), delay)

    def _renegotiate(self, service_topic_path: str) -> None:
        record = self._negotiations.get(service_topic_path)
        if record is None or self.closed:
            return
        self.negotiate(service_topic_path, record.get("tag", ""),
                       record.get("pin_topics", ()),
                       record.get("reply_topics", ()), _redial=True)

    def unregister_reply_topic(self, topic: str) -> None:
        """Remove `topic` from every negotiation record's reply list and
        its attach marks: a per-instance reply topic (a disaggregated
        client's) whose owner is gone must not be re-pinned on every
        redial.  Serving-side pins of the dead topic die with the
        channel."""
        with self._lock:
            for record in self._negotiations.values():
                topics = record.get("reply_topics")
                if topics and topic in topics:
                    record["reply_topics"] = [t for t in topics
                                              if t != topic]
            for key in [k for k in self._attached if k[1] == topic]:
                del self._attached[key]

    def release(self, topic: str, close_channel: bool = True) -> None:
        """Drop the pin for `topic` (service left, pipeline stopped).
        The channel closes once nothing is pinned to it."""
        with self._lock:
            channel = self._pins.pop(topic, None)
            if channel is None:
                return
            still_pinned = any(c.channel_id == channel.channel_id
                               for c in self._pins.values())
        service = self._channel_service(channel)
        if service is not None:
            self._negotiations.pop(service, None)
        if close_channel and not still_pinned:
            channel.close("released")

    def kill_channels(self, reason: str = "chaos-kill") -> int:
        """Sever every open channel (chaos scenarios: the mid-stream
        link kill).  Traffic degrades to the broker; initiating sides
        re-negotiate after renegotiate_delay."""
        with self._lock:
            channels = list(self._channels.values())
        for channel in channels:
            channel.close(reason)
        return len(channels)

    # -- reporting ---------------------------------------------------------
    def info(self) -> dict:
        with self._lock:
            return {
                "endpoints": list(self._endpoints),
                "pins": {t: c.channel_id for t, c in self._pins.items()},
                "channels": {cid: c.info()
                             for cid, c in self._channels.items()},
                "stats": dict(self.stats),
            }

    def pinned(self, topic: str) -> bool:
        channel = self._pins.get(topic)
        return channel is not None and channel.alive

    # -- teardown ----------------------------------------------------------
    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        with self._lock:
            channels = list(self._channels.values())
            pending = list(self._pending.values())
            offered = list(self._offered.values())
            self._pending.clear()
            self._offered.clear()
            self._negotiations.clear()
        for state in pending:
            self._cancel_handshake_timer(state)
        for channel in channels + offered:
            channel.close("shutdown")
        for kind, listener, address in self._listeners:
            try:
                listener.close()
            except OSError:
                pass
            if kind == "uds":
                with contextlib.suppress(OSError):
                    os.unlink(address)
        if getattr(self, "_own_uds_dir", None):
            shutil.rmtree(self._own_uds_dir, ignore_errors=True)
        _MEM_ENDPOINTS.pop(self.token, None)
        self.runtime.remove_message_handler(self._peer_handler,
                                            self.topic_peer)

def in_flight(hosts) -> int:
    """Envelopes the socket channels between `hosts` have queued but the
    receiving ends have not yet handed to their engines.  Each channel
    joining two of the hosts has an end in each: per direction, what one
    end sent (less what its writer shed) minus what the other received.
    A drive on a VirtualClock waits for 0 before it advances the clock;
    memory channels deliver inside send() and never count."""
    ends: dict[str, list] = {}
    for host in hosts:
        with host._lock:
            channels = list(host._channels.values())
        for channel in channels:
            channel = getattr(channel, "inner", channel)
            if isinstance(channel, SocketPeerChannel):
                ends.setdefault(channel.channel_id, []).append(channel)
    total = 0
    for pair in ends.values():
        if len(pair) == 2:
            a, b = pair
            total += (a.sent - a.shed - b.received) + \
                (b.sent - b.shed - a.received)
    return total
