# Process identity from the environment.
#
# The port's own copy of the identity part of
# aiko_services_tpu/utils/configuration.py: namespace, hostname, pid and
# username.  Env vars use the AIKO_TPU_ prefix; the reference's AIKO_
# names are honoured as fallbacks.  The transport configuration and the
# bootstrap responder are not part of the port's local host plane.

from __future__ import annotations

import getpass
import os
import socket

__all__ = ["get_namespace", "get_hostname", "get_pid", "get_username"]

_DEFAULT_NAMESPACE = "aiko"


def _env(name: str, default=None):
    return os.environ.get(f"AIKO_TPU_{name}", os.environ.get(
        f"AIKO_{name}", default))


def get_namespace() -> str:
    return _env("NAMESPACE", _DEFAULT_NAMESPACE)


def get_hostname() -> str:
    return socket.gethostname().split(".")[0]


def get_pid() -> str:
    return str(os.getpid())


def get_username() -> str:
    try:
        return getpass.getuser()
    except Exception:
        return _env("USERNAME", "unknown")
