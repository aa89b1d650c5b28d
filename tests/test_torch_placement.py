"""The port's device placement against the JAX package's: the 17 cases of
tests/test_placement.py.  The allocator's cases run on both packages
over eight devices (JAX's virtual CPU devices, an explicit list of eight
CUDA devices for the port: a torch.device needs no card) and must give
the same slices, ids, axes, counts and errors.  The PlacementManager's
cases run both packages' fleets of in-process clients on a virtual clock
and compare the pool, the EC-shared placement and the releases; each
package's clients build their own ComputeRuntime (JAX's over the slice's
mesh, the port's on the CPU: a port process drives one device, and a
slice of several cards is several processes).  The port-only cases: a
slice's mesh, the default placed spawner's CUDA_VISIBLE_DEVICES, and
DevicePool() listing the CUDA devices or raising when there are none."""

import numpy as np
import pytest
import torch

from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.placement import (DevicePool, DeviceSlice,
                                               placed_process_spawner)

from torch_ops_host import PACKAGES, Host, both

EIGHT = [torch.device("cuda", i) for i in range(8)]


def pool_of(package, devices=None):
    placement = PACKAGES[package].placement
    if package == "jax":
        return placement.DevicePool()
    return placement.DevicePool(EIGHT if devices is None else devices)


def view(device_slice):
    return device_slice.device_ids, dict(device_slice.mesh_axes)


def error(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as exc:
        return type(exc).__name__, str(exc)
    raise AssertionError("no error")


# -- the allocator ------------------------------------------------------------

def test_allocate_disjoint_slices():
    def scenario(package):
        pool = pool_of(package)
        a = pool.allocate(4, "a")
        b = pool.allocate({"data": 2, "model": 2}, "b")
        return pool.total, view(a), view(b), pool.free, pool.occupancy()
    total, a, b, free, _ = both(scenario)
    assert total == 8 and free == 0 and not set(a[0]) & set(b[0])


def test_overcommit_refused():
    def scenario(package):
        pool = pool_of(package)
        pool.allocate(6, "a")
        return error(lambda: pool.allocate(4, "b")), pool.free
    (kind, _), free = both(scenario)
    assert kind == "RuntimeError" and free == 2


def test_double_allocation_refused():
    def scenario(package):
        pool = pool_of(package)
        pool.allocate(2, "a")
        return error(lambda: pool.allocate(2, "a"))
    assert both(scenario)[0] == "ValueError"


def test_release_returns_devices():
    def scenario(package):
        pool = pool_of(package)
        first = pool.allocate(8, "a")
        free = pool.free
        released = pool.release("a")
        again = pool.allocate(8, "b")
        return free, released, view(first) == view(again), pool.release("x")
    assert both(scenario) == (0, True, True, False)


def test_wildcard_axis_fills_free_devices():
    def scenario(package):
        pool = pool_of(package)
        pool.allocate(4, "a")
        return view(pool.allocate({"data": -1, "model": 2}, "b"))
    assert both(scenario)[1] == {"data": 2, "model": 2}


def test_wildcard_resolves_to_obtainable_run_under_fragmentation():
    def scenario(package):
        pool = pool_of(package)
        pool.allocate(3, "a")
        pool.allocate(2, "b")
        pool.allocate(3, "c")
        pool.release("a")
        pool.release("c")
        d = view(pool.allocate({"data": -1}, "d"))
        pool.release("d")
        pool.release("b")
        pool.allocate(8, "all")
        return d, error(lambda: pool.allocate({"data": -1}, "e"))
    d, (_, message) = both(scenario)
    assert len(d[0]) == 3 and "exhausted" in message


def test_wildcard_fragmented_below_fixed_axes_is_clear_error():
    def scenario(package):
        pool = pool_of(package)
        pool.allocate(3, "a")
        pool.allocate(2, "b")
        pool.allocate(3, "c")
        pool.release("b")
        return error(lambda: pool.allocate({"data": -1, "model": 4}, "d"))
    assert "fragmented" in both(scenario)[1]


def test_fragmentation_respects_contiguity():
    def scenario(package):
        pool = pool_of(package)
        pool.allocate(3, "a")
        pool.allocate(2, "b")
        pool.allocate(3, "c")
        pool.release("b")
        refused = error(lambda: pool.allocate(3, "d"))
        return refused, view(pool.allocate(2, "d"))
    _, d = both(scenario)
    assert d[0] == [3, 4]


def test_slice_builds_a_mesh_of_its_process():
    """A port slice's mesh is a DeviceMesh over the process group's ranks
    (parallel/mesh.py create_mesh): one process, one device, so a slice
    of one CPU device gives a mesh of one, and a slice of two devices in
    one process is refused (JAX lays two devices out in one process)."""
    pool = DevicePool([torch.device("cpu")] * 4)
    one = pool.allocate(1, "one")
    mesh = one.mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
    assert mesh.device_type == "cpu"
    two = pool.allocate(2, "two")
    assert two.device_ids == [1, 2] and two.cuda_visible_devices() == "1,2"
    with pytest.raises(ValueError, match="wants 2 devices"):
        two.mesh()


# -- the PlacementManager ------------------------------------------------------

def fleet(package, client_axes, count, pool=None, terminator=None):
    """A PlacementManager over eight devices and `count` in-process
    clients, each reporting its ComputeRuntime into its share."""
    host = Host(package)
    m = host.m
    manager_rt = host.runtime("pm_host")
    pool = pool or pool_of(package)
    spawned = {}

    def spawner(client_id, manager_topic, device_slice):
        rt = host.runtime(f"pworker_{client_id}")
        if package == "jax":
            compute = JComputeRuntime(rt, f"compute_{client_id}",
                                      mesh=device_slice.mesh())
        else:
            compute = TComputeRuntime(rt, f"compute_{client_id}",
                                      device="cpu")
        client = m.lifecycle.LifeCycleClient(rt, f"pclient_{client_id}",
                                             manager_topic, client_id)
        m.placement.report_compute(client, compute)
        spawned[client_id] = (rt, compute, client, device_slice)
        return rt

    manager = m.placement.PlacementManager(
        manager_rt, "pm", spawner, pool, client_mesh_axes=client_axes,
        terminator=terminator)
    ids = manager.create_clients(count)
    host.settle(30)
    return host, manager, pool, spawned, ids


def shares(manager, ids):
    return (manager.ec_producer.get("devices_total"),
            manager.ec_producer.get("devices_free"),
            manager.ec_producer.get("devices_allocated"),
            [manager.ec_producer.get(f"placement.{i}") for i in ids])


def test_clients_get_disjoint_slices_and_compute():
    def scenario(package):
        host, manager, pool, spawned, ids = fleet(
            package, {"data": 2, "model": 2}, 2)
        a, b = (spawned[i][3] for i in ids)
        # each client's ComputeRuntime runs a program on its device
        outs = []
        for client_id in ids:
            compute = spawned[client_id][1]
            compute.register_program("square", lambda x: x * x)
            value = compute.run("square", np.arange(4.0))
            outs.append([float(v) for v in np.asarray(value)])
        return (manager.ready_count(), pool.free, view(a), view(b),
                shares(manager, ids), outs)
    ready, free, a, b, (total, free_share, _, placed), outs = both(scenario)
    assert ready == 2 and free == 0 and not set(a[0]) & set(b[0])
    assert total == 8 and free_share == 0
    assert all("devices=" in p for p in placed)
    assert outs == [[0.0, 1.0, 4.0, 9.0]] * 2


def test_deleting_client_returns_devices_after_vacate():
    def scenario(package):
        host, manager, pool, spawned, ids = fleet(
            package, 4, 2, terminator=lambda cid, rt: rt and rt.terminate())
        seen = [pool.free]
        manager.delete_client(ids[0])
        host.settle(8)
        seen.append(pool.free)                 # still owned: not vacated
        host.engine.clock.advance(31.0)
        host.settle(10)
        seen += [pool.free, shares(manager, ids)]
        new_ids = manager.create_clients(1)
        host.settle(30)
        seen += [pool.free, manager.ready_count(),
                 spawned[new_ids[0]][3].device_ids ==
                 spawned[ids[0]][3].device_ids]
        return seen
    seen = both(scenario)
    assert seen[:3] == [0, 0, 4] and seen[3][1] == 4
    assert seen[3][3][0] is None and seen[4:] == [0, 2, True]


def test_pool_exhaustion_fails_spawn_without_leak():
    def scenario(package):
        host, manager, pool, _, _ = fleet(package, 8, 1)
        refused = error(lambda: manager.create_clients(1))
        seen = [refused[0], pool.free, len(manager.clients)]
        host.engine.clock.advance(31.0)
        host.settle(8)
        return seen + [len(manager.clients)]
    assert both(scenario) == ["RuntimeError", 0, 2, 1]


def test_repeat_delete_does_not_release_parked_slice():
    def scenario(package):
        host, manager, pool, spawned, ids = fleet(package, 4, 2)
        manager.delete_client(ids[0])
        host.settle(5)
        seen = [pool.free]
        manager.delete_client(ids[0])
        host.settle(5)
        seen.append(pool.free)
        spawned[ids[0]][0].message.crash()
        host.settle(10)
        return seen + [pool.free]
    assert both(scenario) == [0, 0, 4]


def test_crashed_client_returns_devices():
    def scenario(package):
        host, manager, pool, spawned, ids = fleet(package, 4, 2)
        seen = [pool.free]
        spawned[ids[0]][0].message.crash()
        host.settle(10)
        return seen + [pool.free, manager.ready_count(),
                       ids[0] in manager.clients]
    assert both(scenario) == [0, 4, 1, False]


def test_device_health_aggregation():
    def scenario(package):
        host, manager, pool, spawned, ids = fleet(package, 4, 2)
        health = manager.device_health()
        return {client_id: {key: value for key, value in entry.items()
                            if key != "reported_device_count"}
                for client_id, entry in health.items()}, \
            [health[i]["reported_device_count"] for i in ids]
    health, reported = scenario("torch")
    assert health == scenario("jax")[0]
    for entry in health.values():
        assert entry["state"] == "ready" and len(entry["devices"]) == 4
        assert entry["platform"] == "cpu"
    # a port client's ComputeRuntime drives one device (its process's)
    assert reported == [1, 1]


class FakeProcessManager:
    def __init__(self, fail_on=None):
        self.spawned = []
        self.fail_on = fail_on

    def spawn(self, id, command, arguments=(), **popen_kwargs):
        if id == self.fail_on:
            raise OSError("exec failed")
        self.spawned.append((id, command, list(arguments),
                             popen_kwargs["env"]["CUDA_VISIBLE_DEVICES"]))
        return 1000 + len(self.spawned)


def test_placed_spawner_hands_each_child_its_cards():
    """The default placed spawner starts each client as a process that
    sees only its slice's cards (CUDA_VISIBLE_DEVICES), so stages of one
    pipeline land on distinct cards; a spawn that fails releases its
    slice (no leak) and the next client gets the same cards."""
    host = Host("torch")
    processes = FakeProcessManager(fail_on="2")
    manager = host.m.placement.PlacementManager(
        host.runtime("pm_proc"), "pm_proc",
        placed_process_spawner(processes, ["python", "-m", "worker"],
                               ["--flag"]),
        DevicePool([torch.device("cuda", i) for i in range(12)]),
        client_mesh_axes=4)
    manager.create_clients(2)
    with pytest.raises(OSError):
        manager.create_clients(1)
    assert manager.pool.free == 4
    assert manager.ec_producer.get("placement.2") is None
    processes.fail_on = None
    manager.create_clients(1)
    assert [(cid, cards) for cid, _, _, cards in processes.spawned] == \
        [("0", "0,1,2,3"), ("1", "4,5,6,7"), ("3", "8,9,10,11")]
    assert processes.spawned[0][2][:2] == ["--flag", "0"]
    assert manager.pool.free == 0
    manager.stop()


def test_compute_runtime_publishes_device_health():
    host = Host("torch")
    compute = TComputeRuntime(host.runtime("health_host"), "health_compute",
                              device="cpu")
    host.settle(4)
    assert compute.ec_producer.get("device.0.mem_pct") == -1
    assert compute.ec_producer.get("device_kind") == "cpu"
    assert compute.ec_producer.get("platform") == "cpu"


def test_default_pool_lists_the_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    pool = DevicePool()
    assert pool.devices == [torch.device("cuda", 0),
                            torch.device("cuda", 1)]
    assert pool.allocate(1, "a").device_ids == [0]
    assert pool.allocate(1, "b").describe() == "devices=[1] mesh=(data=1)"
    assert isinstance(pool.slice_of("b"), DeviceSlice)
    with pytest.raises(RuntimeError, match="no contiguous run"):
        pool.allocate(1, "c")
