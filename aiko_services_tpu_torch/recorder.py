# Recorder: aggregate distributed log topics into browsable ring buffers.
#
# The port's own copy of aiko_services_tpu/recorder.py: subscribes the
# namespace log topic filter ({namespace}/+/+/+/log), keeps an LRU of
# per-topic ring buffers, and republishes counts into its EC share so
# dashboards can discover which services are logging and fetch their
# tails.  The same discipline holds the retained {topic_path}/0/metrics
# snapshots (browsable with metrics_tail, persistable to Storage beside
# the log rings) and the latest SLO alert record per rule.
#
# The topic names and the retained-JSON decode are the port's own copies
# of the few names it needs from aiko_services_tpu/observe/export.py and
# observe/series.py, which wait for ROADMAP.md Queue 1 item 13.

from __future__ import annotations

import json
from collections import deque

from .actor import Actor, get_remote_proxy
from .service import ServiceProtocol
from .storage import Storage
from .utils import LRUCache, get_logger

__all__ = ["Recorder", "PROTOCOL_RECORDER", "METRICS_TOPIC_SUFFIX",
           "ALERT_TOPIC_PREFIX", "parse_retained_json"]

PROTOCOL_RECORDER = ServiceProtocol("recorder")
METRICS_TOPIC_SUFFIX = "0/metrics"  # retained {topic_path}/0/metrics
ALERT_TOPIC_PREFIX = "alert"        # retained {namespace}/alert/{rule}
_TOPIC_LIMIT = 64           # LRU of log topics
_RING_LIMIT = 128           # records per topic
_METRICS_RING_LIMIT = 8     # snapshots kept per metrics topic (each is
                            # a full registry dump — deep history is the
                            # scraper's job, the tail is the Recorder's)


def parse_retained_json(payload, require_key: str | None = None):
    """Decode one retained control-plane JSON payload (metrics
    snapshot, alert record): bytes-tolerant, returns the dict or None
    on any malformed input — a bad retained record must never fail a
    subscriber.  `require_key` additionally rejects documents missing
    that key."""
    try:
        if isinstance(payload, (bytes, bytearray)):
            payload = payload.decode("utf-8")
        document = json.loads(payload)
    except Exception:
        return None
    if not isinstance(document, dict):
        return None
    if require_key is not None and require_key not in document:
        return None
    return document


class Recorder(Actor):
    def __init__(self, runtime, name: str = "recorder",
                 topic_limit: int = _TOPIC_LIMIT,
                 ring_limit: int = _RING_LIMIT,
                 metrics_ring_limit: int = _METRICS_RING_LIMIT):
        super().__init__(runtime, name, PROTOCOL_RECORDER)
        self.logger = get_logger("recorder")
        self.ring_limit = ring_limit
        self.metrics_ring_limit = metrics_ring_limit
        self.buffers: LRUCache = LRUCache(topic_limit)
        self.metrics_buffers: LRUCache = LRUCache(topic_limit)
        self._log_filter = f"{runtime.namespace}/+/+/+/log"
        runtime.add_message_handler(self._log_handler, self._log_filter)
        # topic_path is {namespace}/{host}/{pid}; snapshots ride
        # {topic_path}/0/metrics — retained, so a late-started Recorder
        # still catches the latest
        self._metrics_filter = \
            f"{runtime.namespace}/+/+/{METRICS_TOPIC_SUFFIX}"
        runtime.add_message_handler(self._metrics_handler,
                                    self._metrics_filter)
        # SLO alert records: retained {namespace}/alert/{rule} — the
        # Recorder keeps the latest record per rule so a late-joining
        # operator sees what fired
        self.alerts: dict[str, dict] = {}
        self._alert_filter = \
            f"{runtime.namespace}/{ALERT_TOPIC_PREFIX}/+"
        runtime.add_message_handler(self._alert_handler,
                                    self._alert_filter)
        self.ec_producer.update("topic_count", 0)
        self.ec_producer.update("record_count", 0)
        self.ec_producer.update("metrics_topic_count", 0)
        self.ec_producer.update("alerts_firing", 0)

    def _log_handler(self, topic: str, payload) -> None:
        ring = self.buffers.get(topic)
        if ring is None:
            ring = deque(maxlen=self.ring_limit)
            self.buffers.put(topic, ring)
            self.ec_producer.update("topic_count", len(self.buffers))
        ring.append(payload)
        total = sum(len(self.buffers.get(t)) for t in self.buffers.keys())
        self.ec_producer.update("record_count", total)

    def _metrics_handler(self, topic: str, payload) -> None:
        document = parse_retained_json(payload)
        if document is None:
            self.logger.debug("recorder: unparseable metrics snapshot "
                              "on %s", topic)
            return
        ring = self.metrics_buffers.get(topic)
        if ring is None:
            ring = deque(maxlen=self.metrics_ring_limit)
            self.metrics_buffers.put(topic, ring)
            self.ec_producer.update("metrics_topic_count",
                                    len(self.metrics_buffers))
        ring.append(document)

    def _alert_handler(self, topic: str, payload) -> None:
        record = parse_retained_json(payload, require_key="rule")
        if record is None:
            self.logger.debug("recorder: unparseable alert record on "
                              "%s", topic)
            return
        # keyed by fleet SLO rule names — bounded
        self.alerts[str(record["rule"])] = record
        self.ec_producer.update("alerts_firing", sum(
            1 for entry in self.alerts.values()
            if entry.get("state") == "firing"))

    def alert_records(self) -> dict:
        """Latest alert record per rule (firing or resolved)."""
        return dict(self.alerts)

    def alert_exemplars(self) -> dict:
        """Exemplar trace ids per FIRING rule: the requests behind each
        breaching quantile — the ids to grep this recorder's log rings
        for."""
        return {rule: list(record.get("exemplars", []))
                for rule, record in self.alerts.items()
                if record.get("state") == "firing"
                and record.get("exemplars")}

    def tail(self, topic: str, count: int = 16) -> list:
        ring = self.buffers.get(topic)
        return list(ring)[-count:] if ring else []

    def topics(self) -> list[str]:
        return list(self.buffers.keys())

    def metrics_tail(self, topic: str, count: int = 1) -> list:
        """The last `count` captured snapshot documents of one metrics
        topic (parsed: {"process", "topic_path", "time", "snapshot"})."""
        ring = self.metrics_buffers.get(topic)
        return list(ring)[-count:] if ring else []

    def metrics_topics(self) -> list[str]:
        return list(self.metrics_buffers.keys())

    def persist(self, storage_topic_in: str) -> None:
        """Write every ring durably to a Storage service (sqlite) as
        `log/<topic>` → record list and `metrics/<topic>` → snapshot
        list, over the standard `(put ...)` RPC.  Callable remotely:
        publish `(persist <storage_topic_in>)` to this recorder's in
        topic.

        Binary records (bytes from binary log topics) are persisted as
        latin-1 text — lossless byte mapping, not a Python repr."""
        storage = get_remote_proxy(self.runtime, str(storage_topic_in),
                                   Storage)
        for topic in self.buffers.keys():
            records = [record.decode("latin-1")
                       if isinstance(record, bytes) else str(record)
                       for record in self.buffers.get(topic)]
            storage.put(f"log/{topic}", records)
        for topic in self.metrics_buffers.keys():
            storage.put(f"metrics/{topic}",
                        list(self.metrics_buffers.get(topic)))
        self.ec_producer.update("persisted_topics", len(self.buffers))
        self.ec_producer.update("persisted_metrics_topics",
                                len(self.metrics_buffers))

    def stop(self) -> None:
        self.runtime.remove_message_handler(self._log_handler,
                                            self._log_filter)
        self.runtime.remove_message_handler(self._metrics_handler,
                                            self._metrics_filter)
        self.runtime.remove_message_handler(self._alert_handler,
                                            self._alert_filter)
        super().stop()
