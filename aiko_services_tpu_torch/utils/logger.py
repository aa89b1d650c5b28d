# Logging: console and transport-backed (distributed) handlers.
#
# The port's own copy of aiko_services_tpu/utils/logger.py: per-subsystem
# level env vars, a handler that publishes records to a pub/sub topic, and
# ring buffering of records until the transport is connected.

from __future__ import annotations

import logging
import os
import threading
from collections import deque

__all__ = ["get_logger", "get_log_level_name", "TransportLoggingHandler"]

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
_DATE_FORMAT = "%H:%M:%S"
_RING_SIZE = 128


def get_log_level_name(logger_or_level) -> str:
    level = getattr(logger_or_level, "level", logger_or_level)
    return logging.getLevelName(level)


def _resolve_level(name: str) -> int:
    env = os.environ.get(f"AIKO_TPU_LOG_LEVEL_{name.upper()}",
                         os.environ.get("AIKO_TPU_LOG_LEVEL",
                                        os.environ.get("AIKO_LOG_LEVEL")))
    if not env:
        return logging.INFO
    try:
        return int(env)
    except ValueError:
        return logging.getLevelName(env.upper()) \
            if isinstance(logging.getLevelName(env.upper()), int) \
            else logging.INFO


def get_logger(name: str, level=None, handler=None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = handler or logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT, _DATE_FORMAT))
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level if level is not None else _resolve_level(name))
    return logger


class TransportLoggingHandler(logging.Handler):
    """Publishes log records to `topic` on a Message transport.

    `message` may be the transport itself or a zero-arg callable
    returning it (lazy: actors are often built before the runtime's
    transport connects).  Records emitted before the transport is up are
    ring-buffered (up to 128) and flushed on first successful publish.
    """

    def __init__(self, message, topic: str):
        super().__init__()
        self.message = message
        self.topic = topic
        self._ring: deque = deque(maxlen=_RING_SIZE)
        # re-entrancy guard (per thread): transport.publish may itself
        # log (broker diagnostics, slow-consumer warnings) and that
        # record would arrive right back here — drop it instead of
        # recursing until the stack dies
        self._emitting = threading.local()
        self.dropped_reentrant = 0

    def _transport(self):
        return self.message() if callable(self.message) else self.message

    def emit(self, record):
        if getattr(self._emitting, "active", False):
            self.dropped_reentrant += 1
            return
        self._emitting.active = True
        try:
            try:
                payload = self.format(record)
            except Exception:
                return
            transport = self._transport()
            if transport is not None and transport.connected():
                while self._ring:
                    transport.publish(self.topic, self._ring.popleft())
                transport.publish(self.topic, payload)
            else:
                self._ring.append(payload)
        finally:
            self._emitting.active = False
