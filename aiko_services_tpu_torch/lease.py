# Lease: the framework-wide timeout primitive.
# (capability parity: aiko_services/lease.py:31-83 — expire/extend handlers,
# optional automatic extension at 0.8x of the lease period)
#
# The port's own copy of aiko_services_tpu/lease.py.

from __future__ import annotations

__all__ = ["Lease"]

_EXTEND_FACTOR = 0.8


class Lease:
    def __init__(self, engine, lease_time: float, lease_id,
                 lease_expired_handler=None, lease_extend_handler=None,
                 automatic_extend: bool = False):
        self.event = engine
        self.lease_time = lease_time
        self.lease_id = lease_id
        self.lease_expired_handler = lease_expired_handler
        self.lease_extend_handler = lease_extend_handler
        self.automatic_extend = automatic_extend
        self.expired = False
        self._timer = None
        self._schedule()

    def _schedule(self) -> None:
        if self._timer is not None:
            self.event.remove_timer_handler(self._timer)
        delay = self.lease_time * _EXTEND_FACTOR if self.automatic_extend \
            else self.lease_time
        self._timer = self.event.add_oneshot_handler(self._fire, delay)

    def _fire(self) -> None:
        self._timer = None
        if self.expired:
            return
        if self.automatic_extend:
            if self.lease_extend_handler:
                self.lease_extend_handler(self.lease_time, self.lease_id)
            self._schedule()
        else:
            self.expired = True
            if self.lease_expired_handler:
                self.lease_expired_handler(self.lease_id)

    def extend(self, lease_time: float | None = None) -> None:
        if self.expired:
            return
        if lease_time is not None:
            self.lease_time = lease_time
        self._schedule()

    def cancel(self) -> None:
        """Retire the lease NOW: the timer is removed and neither the
        expired nor the extend handler will ever fire again.  Every code
        path that stops caring about a lease (reply arrived, stream
        destroyed, proxy re-resolved) must call this — an uncancelled
        timer on a dead hop fires an expired handler into state that no
        longer exists."""
        self.expired = True
        if self._timer is not None:
            self.event.remove_timer_handler(self._timer)
            self._timer = None

    # historical name; cancel() is the explicit spelling
    terminate = cancel

    @property
    def active(self) -> bool:
        return not self.expired
