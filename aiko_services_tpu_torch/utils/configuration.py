# Process identity and transport configuration from the environment.
#
# The port's own copy of aiko_services_tpu/utils/configuration.py:
# namespace, hostname/pid/username identity, process identity checks
# (pid plus kernel start time), message-transport selection and host/port
# resolution, and the UDP bootstrap pair.  Env vars use the AIKO_TPU_
# prefix; the reference's AIKO_ names are honoured as fallbacks.

from __future__ import annotations

import dataclasses
import getpass
import os
import socket
import subprocess
import threading

__all__ = [
    "get_namespace", "get_hostname", "get_pid", "get_username",
    "pid_start_time", "pid_verified",
    "TransportConfig", "get_transport_configuration",
    "BootstrapResponder", "discover_bootstrap", "BOOTSTRAP_PORT",
]

_DEFAULT_NAMESPACE = "aiko"
_DEFAULT_MQTT_PORT = 1883
BOOTSTRAP_PORT = 4149


def _env(name: str, default=None):
    return os.environ.get(f"AIKO_TPU_{name}", os.environ.get(
        f"AIKO_{name}", default))


def get_namespace() -> str:
    return _env("NAMESPACE", _DEFAULT_NAMESPACE)


def get_hostname() -> str:
    return socket.gethostname().split(".")[0]


def get_pid() -> str:
    return str(os.getpid())


def pid_start_time(pid: int):
    """Kernel start time of `pid` (jiffies since boot from
    /proc/<pid>/stat field 22), or None when unknowable.  A (pid,
    start_time) pair uniquely names a process for the machine's
    uptime — the identity check that a bare pid (recyclable) or a
    cmdline substring (spoofable, brittle) cannot give.  Off-Linux
    falls back to `ps -o lstart=` (a wall-clock string; still unique
    per incarnation)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # comm (field 2) may contain spaces/parens — split after the
        # LAST ')' so field indices are stable
        fields = stat[stat.rindex(")") + 2:].split()
        return int(fields[19])          # starttime is field 22 overall
    except (OSError, ValueError, IndexError):
        try:
            out = subprocess.run(
                ["ps", "-p", str(pid), "-o", "lstart="],
                capture_output=True, text=True, timeout=2).stdout.strip()
            return out or None
        except (OSError, subprocess.SubprocessError):
            return None


def pid_verified(pid: int, marker: str = "aiko",
                 start_time=None) -> bool:
    """True when `pid` is alive AND still names the process we think
    it does — guards SIGKILL paths against pid reuse by an unrelated
    process (a stale dashboard row or pid file can outlive its
    process).

    When `start_time` (a value previously captured via
    `pid_start_time`) is given, identity is exact: the live process's
    start time must match.  Otherwise falls back to the weaker
    cmdline-contains-`marker` heuristic.  When neither source can
    answer, the result is False (callers degrade to a graceful
    stop)."""
    if start_time is not None:
        return pid_start_time(pid) == start_time
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read().replace(b"\0", b" ").decode(
                "utf-8", "replace")
    except OSError:
        try:
            cmdline = subprocess.run(
                ["ps", "-p", str(pid), "-o", "command="],
                capture_output=True, text=True, timeout=2).stdout
        except (OSError, subprocess.SubprocessError):
            return False
    return marker in cmdline


def get_username() -> str:
    try:
        return getpass.getuser()
    except Exception:
        return _env("USERNAME", "unknown")


@dataclasses.dataclass
class TransportConfig:
    transport: str = "memory"        # "memory" | "mqtt"
    host: str = "localhost"
    port: int = _DEFAULT_MQTT_PORT
    username: str | None = None
    password: str | None = None
    tls: bool = False


def get_transport_configuration() -> TransportConfig:
    """Resolve the control-plane transport from the environment.

    Default is the in-memory broker (single-host, test-friendly).  Setting
    AIKO_TPU_MQTT_HOST selects the MQTT transport, mirroring how the
    reference bootstraps from AIKO_MQTT_HOST.
    """
    host = _env("MQTT_HOST")
    transport = _env("MESSAGE_TRANSPORT", "mqtt" if host else "memory")
    return TransportConfig(
        transport=transport,
        host=host or "localhost",
        port=int(_env("MQTT_PORT", _DEFAULT_MQTT_PORT)),
        username=_env("USERNAME_MQTT", _env("USERNAME")),
        password=_env("PASSWORD"),
        tls=str(_env("MQTT_TLS", "")).lower() in ("1", "true", "yes"),
    )


# -- UDP broadcast bootstrap (DNS-less device discovery) ---------------------
# a device broadcasts "boot?" on BOOTSTRAP_PORT; any host running a
# responder answers "boot <host> <port>" with its transport endpoint.

class BootstrapResponder:
    """Answers "boot?" broadcasts with this host's transport endpoint.
    Runs a small daemon thread (network I/O, not event-loop work)."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 bind: str = "", bootstrap_port: int = BOOTSTRAP_PORT):
        config = get_transport_configuration()
        self.host = host or config.host
        self.port = port or config.port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind, bootstrap_port))
        self._sock.settimeout(0.5)
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while self._running:
            try:
                data, address = self._sock.recvfrom(64)
            except socket.timeout:
                continue
            except OSError:
                return
            if data.strip() == b"boot?":
                reply = f"boot {self.host} {self.port}".encode()
                try:
                    self._sock.sendto(reply, address)
                except OSError:
                    pass

    def stop(self) -> None:
        self._running = False
        self._sock.close()


def discover_bootstrap(timeout: float = 2.0,
                       bootstrap_port: int = BOOTSTRAP_PORT):
    """Broadcast "boot?" and return (host, port) of the first responder,
    or None — lets DNS-less devices find the control-plane broker."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.settimeout(timeout)
    try:
        sock.sendto(b"boot?", ("255.255.255.255", bootstrap_port))
    except OSError:
        # broadcast unavailable (containers): try loopback
        try:
            sock.sendto(b"boot?", ("127.0.0.1", bootstrap_port))
        except OSError:
            sock.close()
            return None
    try:
        while True:
            data, _address = sock.recvfrom(128)
            parts = data.decode(errors="replace").split()
            if len(parts) != 3 or parts[0] != "boot":
                continue            # stray datagram: keep listening
            try:
                return parts[1], int(parts[2])
            except ValueError:
                continue            # malformed port: keep listening
    except socket.timeout:
        return None
    finally:
        sock.close()
