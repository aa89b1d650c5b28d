# Device placement: the host's CUDA cards as an allocatable pool behind
# the lifecycle manager.
#
# The port's own copy of aiko_services_tpu/placement.py.  The same
# spawn / handshake / lease machinery as LifeCycleManager places device
# workloads: a DevicePool partitions the cards one process may see, each
# spawned client receives a DeviceSlice (the cards and the mesh geometry
# to lay over them) it builds its ComputeRuntime over, and the manager
# EC-shares pool occupancy and per-client placement so dashboards see
# device health next to process health.  The default placed spawner
# (placed_process_spawner) starts the client as an OS process that sees
# only its slice's cards, through CUDA_VISIBLE_DEVICES.

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from .lifecycle import LifeCycleManager, is_absent
from .parallel.mesh import MeshSpec, create_mesh
from .utils import get_logger

__all__ = ["DeviceSlice", "DevicePool", "PlacementManager",
           "report_compute", "placed_process_spawner"]


@dataclass
class DeviceSlice:
    """A contiguous run of devices plus the mesh geometry to lay over
    them.  Contiguity is deliberate: neighbouring cards of one host share
    the fastest links, so model and tensor-parallel axes stay on
    adjacent cards.  device_ids are the cards' CUDA indices (a device
    without an index, the CPU, is named by its position in the pool)."""
    owner: str
    devices: list
    mesh_axes: dict                     # resolved axis name -> size
    device_ids: list = field(default_factory=list)

    def __post_init__(self):
        if not self.device_ids:
            self.device_ids = [_device_id(device, position)
                               for position, device in
                               enumerate(self.devices)]

    def mesh(self):
        """Build the DeviceMesh for this slice (parallel/mesh.py
        create_mesh): a process drives one device of it, so the mesh
        spans the ranks of its process group (one rank, one card)."""
        return create_mesh(self.mesh_axes, self.devices[0])

    def cuda_visible_devices(self) -> str:
        """The slice's cards as a CUDA_VISIBLE_DEVICES value."""
        return ",".join(str(device_id) for device_id in self.device_ids)

    def describe(self) -> str:
        axes = ",".join(f"{k}={v}" for k, v in self.mesh_axes.items())
        return f"devices={self.device_ids} mesh=({axes})"


def _device_id(device, position: int) -> int:
    index = getattr(device, "index", None)
    return position if index is None else int(index)


def cuda_devices() -> list:
    """Every CUDA device this process can see; raises when there is
    none (a pool of no cards places nothing)."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("DevicePool: no CUDA device is visible; pass "
                           "an explicit list of devices")
    return [torch.device("cuda", index) for index in range(count)]


class DevicePool:
    """Allocator over the process-visible device inventory.

    Slices are handed out as contiguous runs (first-fit) and returned by
    owner; double allocation of a device is impossible by construction.
    devices=None lists the CUDA cards (torch.cuda.device_count()) and
    raises when there are none; tests pass an explicit list."""

    def __init__(self, devices=None):
        self.devices = list(cuda_devices() if devices is None else devices)
        self._owned: dict[str, DeviceSlice] = {}      # owner -> slice
        self._positions: dict[str, list] = {}         # owner -> positions

    # -- queries -----------------------------------------------------------
    @property
    def total(self) -> int:
        return len(self.devices)

    @property
    def allocated(self) -> int:
        return sum(len(s.devices) for s in self._owned.values())

    @property
    def free(self) -> int:
        return self.total - self.allocated

    def slice_of(self, owner: str) -> DeviceSlice | None:
        return self._owned.get(owner)

    def occupancy(self) -> dict:
        """owner -> device id list (EC-share friendly)."""
        return {owner: s.device_ids for owner, s in self._owned.items()}

    # -- allocate / release ------------------------------------------------
    def allocate(self, mesh_axes: dict | int, owner: str) -> DeviceSlice:
        """mesh_axes: axis dict ({"data": 2, "model": 2}) or a plain
        device count (1D data mesh).  Raises when owner already holds a
        slice or no contiguous run fits."""
        if owner in self._owned:
            raise ValueError(f"{owner!r} already holds "
                             f"{self._owned[owner].describe()}")
        if isinstance(mesh_axes, int):
            mesh_axes = {"data": mesh_axes}
        count = MeshSpec(dict(mesh_axes))
        if -1 in mesh_axes.values():
            # a wildcard axis can only fill what is contiguously
            # OBTAINABLE, not the raw free count (fragmentation)
            longest = self._longest_free_run()
            if longest == 0:
                raise RuntimeError(
                    f"pool exhausted ({self.total} devices allocated)")
            fixed = max(math.prod(
                v for v in mesh_axes.values() if v != -1), 1)
            if longest < fixed:
                raise RuntimeError(
                    f"fragmented pool: longest contiguous free run is "
                    f"{longest} devices but the fixed axes need "
                    f"multiples of {fixed} "
                    f"(free={self.free}/{self.total})")
            resolved = count.resolve(longest - longest % fixed)
        else:
            resolved = count.resolve(math.prod(mesh_axes.values()))
        need = math.prod(resolved.values())
        run = self._find_run(need)
        if run is None:
            raise RuntimeError(
                f"no contiguous run of {need} free devices "
                f"(free={self.free}/{self.total})")
        allocated = DeviceSlice(
            owner, [self.devices[p] for p in run], resolved,
            [_device_id(self.devices[p], p) for p in run])
        self._owned[owner] = allocated
        self._positions[owner] = run
        return allocated

    def release(self, owner: str) -> bool:
        self._positions.pop(owner, None)
        return self._owned.pop(owner, None) is not None

    def _taken(self) -> set:
        return {p for run in self._positions.values() for p in run}

    def _find_run(self, need: int):
        taken = self._taken()
        run: list = []
        for position in range(self.total):
            if position in taken:
                run = []
                continue
            run.append(position)
            if len(run) == need:
                return run
        return None

    def _longest_free_run(self) -> int:
        taken = self._taken()
        longest = current = 0
        for position in range(self.total):
            current = 0 if position in taken else current + 1
            longest = max(longest, current)
        return longest


def report_compute(client, compute) -> None:
    """Copy a ComputeRuntime's device identity into a LifeCycleClient's
    EC share: the manager mirrors the CLIENT's share, so this is how a
    worker's device health reaches the manager/dashboard."""
    for key in ("device_count", "platform", "device_kind", "mesh"):
        value = compute.ec_producer.get(key)
        if value is not None:
            client.ec_producer.update(key, value)


def placed_process_spawner(process_manager, command, arguments=()):
    """The default placed spawner: start `command arguments... client_id
    manager_topic_path` as an OS process through `process_manager`
    (process_manager.ProcessManager), its environment's
    CUDA_VISIBLE_DEVICES set to the slice's cards, so the child sees
    exactly its slice (as cuda:0, cuda:1, ...).  The handle is the
    process id the manager knows the child by."""
    def spawn(client_id, manager_topic_path, device_slice):
        env = {**os.environ,
               "CUDA_VISIBLE_DEVICES": device_slice.cuda_visible_devices()}
        process_manager.spawn(client_id, command,
                              [*arguments, client_id, manager_topic_path],
                              env=env)
        return str(client_id)
    return spawn


class PlacementManager(LifeCycleManager):
    """LifeCycleManager that owns a DevicePool: every client it spawns
    gets a DeviceSlice, and the slice returns to the pool when the
    client dies (handshake miss, registrar removal, or deletion).

    spawner(client_id, manager_topic_path, device_slice) -> handle (the
    extra argument against the base class): in-process runtimes in
    tests, OS processes through placed_process_spawner in deployment."""

    def __init__(self, runtime, name: str, spawner, pool: DevicePool,
                 client_mesh_axes: dict | int = 1, terminator=None,
                 **kwargs):
        self.pool = pool
        self.client_mesh_axes = client_mesh_axes
        self._placed_spawner = spawner
        self._user_terminator = terminator
        # state topic -> client_ids whose slices await vacate confirmation
        self._pending_release: dict[str, set] = {}
        super().__init__(runtime, name,
                         spawner=self._spawn_with_placement,
                         terminator=self._terminate_and_release, **kwargs)
        self.logger = get_logger(f"placement_manager.{name}")
        self._publish_pool()

    def _spawn_with_placement(self, client_id: str, topic_path: str):
        device_slice = self.pool.allocate(self.client_mesh_axes, client_id)
        self.ec_producer.update(f"placement.{client_id}",
                                device_slice.describe())
        self._publish_pool()
        try:
            return self._placed_spawner(client_id, topic_path,
                                        device_slice)
        except Exception:
            # spawn failed: the slice must not leak
            self.pool.release(client_id)
            self.ec_producer.remove(f"placement.{client_id}")
            self._publish_pool()
            raise

    def delete_client(self, client_id: str) -> None:
        """The slice is NOT freed here: a card is only safe to hand out
        again once the old client has provably vacated it (a process
        holding a CUDA context keeps its memory on the card), and even a
        client that missed its handshake may have opened one.  Release
        happens on the process's absent/LWT state, or at the latest when
        the deletion lease force-terminates the client."""
        client_id = str(client_id)
        record = self.clients.get(client_id)
        if record is None:
            return              # idempotent: repeat deletes must not
                                # touch slices already parked pending
        state_topic = record.state_topic
        super().delete_client(client_id)
        if self.pool.slice_of(client_id) is None:
            return                       # nothing held
        if state_topic:
            # watch for a FUTURE absent (operator-initiated delete); a
            # crash-driven delete is released by _client_state_handler
            # below, which owns the in-flight absent event
            pending = self._pending_release.setdefault(state_topic, set())
            if not pending:
                self.runtime.add_message_handler(self._release_on_absent,
                                                 state_topic)
            pending.add(client_id)
        # no state topic (never handshook): the always-armed deletion
        # lease (_terminate_and_release) reclaims after force-kill

    def _client_state_handler(self, topic, payload) -> None:
        """Absent arrives → base deletes the clients (parking their
        slices) → release them here, directly off the event: the death
        is confirmed, and waiting for a retained-message redelivery
        would hang when other clients keep the topic subscribed."""
        super()._client_state_handler(topic, payload)
        if is_absent(payload):
            self._release_pending(topic)

    def _release_on_absent(self, topic, payload) -> None:
        if is_absent(payload):
            self._release_pending(topic)

    def _release_pending(self, topic: str) -> None:
        for client_id in self._pending_release.pop(topic, set()):
            self._release(client_id)
        self.runtime.remove_message_handler(self._release_on_absent,
                                            topic)

    def _terminate_and_release(self, client_id: str, handle) -> None:
        """Deletion-lease expiry: force-kill (if the caller supplied a
        terminator) then reclaim — the bounded fallback when no LWT
        ever arrives."""
        if self._user_terminator is not None:
            self._user_terminator(client_id, handle)
        client_id = str(client_id)
        for topic, pending in list(self._pending_release.items()):
            if client_id in pending:
                pending.discard(client_id)
                if not pending:
                    del self._pending_release[topic]
                    self.runtime.remove_message_handler(
                        self._release_on_absent, topic)
        if self.pool.slice_of(client_id) is not None:
            self._release(client_id)

    def _release(self, client_id: str) -> None:
        if self.pool.release(client_id):
            self.ec_producer.remove(f"placement.{client_id}")
            self._publish_pool()

    def device_health(self) -> dict:
        """Aggregate of what ready clients report in their EC shares
        (ComputeRuntime publishes device_count/platform/mesh)."""
        health = {}
        for client_id, record in self.clients.items():
            health[client_id] = {
                "state": record.state,
                "devices": self.pool.slice_of(client_id).device_ids
                if self.pool.slice_of(client_id) else [],
                "reported_device_count":
                    record.share.get("device_count"),
                "platform": record.share.get("platform"),
            }
        return health

    def _publish_pool(self) -> None:
        self.ec_producer.update("devices_total", self.pool.total)
        self.ec_producer.update("devices_free", self.pool.free)
        self.ec_producer.update("devices_allocated", self.pool.allocated)

    def stop(self) -> None:
        for topic in list(self._pending_release):
            self.runtime.remove_message_handler(self._release_on_absent,
                                                topic)
        self._pending_release.clear()
        super().stop()
