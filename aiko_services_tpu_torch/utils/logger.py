# Logging: console loggers with per-subsystem level env vars.
#
# The port's own copy of aiko_services_tpu/utils/logger.py without the
# transport-backed (distributed) handler, which waits for the port's
# registrar and recorder.

from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "get_log_level_name"]

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
_DATE_FORMAT = "%H:%M:%S"


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
