"""The port's lock-order checker (utils/lock.py) against the JAX
package's: the ABBA fixture of tests/test_analysis.py is reported the
same way (one violation, the same cycle, both acquisition stacks), a
re-entrant acquire raises, misuse raises the same errors, and
AIKO_LOCK_CHECK is read at import.  Then the port's threaded parts run
with the port's checker on (the promoter's worker thread, the pipelined
results worker, the MetricsPublisher, the HealthAggregator and the
autoscaler beside them on one engine) and it reports nothing.  Each test
resets the checkers it turned on: the JAX package's report stays empty
for tests/conftest.py's gate, which does not read the port's."""

import collections
import json
import os
import subprocess
import sys
import threading

import pytest

import aiko_services_tpu.utils.lock as JLock
import aiko_services_tpu_torch.utils.lock as TLock

LOCKS = {"jax": JLock, "torch": TLock}


@pytest.fixture
def checked():
    """The port's checker on and empty for one test, restored after;
    yields a Counter of the lock names acquired under it."""
    was = TLock.lock_check_enabled()
    TLock.enable_lock_check(True)
    TLock.lock_check_reset()
    taken = collections.Counter()
    after_acquire = TLock._checker.after_acquire

    def counting(lock):
        taken[lock.name] += 1
        after_acquire(lock)

    TLock._checker.after_acquire = counting
    try:
        yield taken
    finally:
        del TLock._checker.after_acquire
        TLock.lock_check_reset()
        TLock.enable_lock_check(was)


def abba(package: str):
    module = LOCKS[package]
    was = module.lock_check_enabled()
    module.enable_lock_check(True)
    module.lock_check_reset()
    try:
        lock_a, lock_b = module.Lock("t_A"), module.Lock("t_B")
        with lock_a:
            with lock_b:
                pass
        consistent = module.lock_check_report()
        with lock_b:
            with lock_a:        # the inversion
                pass
        report = module.lock_check_report()
        return (consistent, len(report), report[0].cycle,
                bool(report[0].this_stack), bool(report[0].prior_stack),
                "test_torch_lock_order" in report[0].this_stack,
                str(report[0]).splitlines()[0])
    finally:
        module.lock_check_reset()
        module.enable_lock_check(was)


def test_abba_fixture_is_reported_as_jax_reports_it():
    port = abba("torch")
    assert port == abba("jax")
    assert port[:2] == ([], 1) and set(port[2]) == {"t_A", "t_B"}
    assert port[3:6] == (True, True, True)


def test_reentrant_acquire_raises_under_check():
    def scenario(package):
        module = LOCKS[package]
        was = module.lock_check_enabled()
        module.enable_lock_check(True)
        module.lock_check_reset()
        try:
            lock = module.Lock("t_reentrant")
            lock.acquire("outer")
            with pytest.raises(RuntimeError, match="re-entrant") as error:
                lock.acquire("inner")
            lock.release()
            return str(error.value).split(" (held")[0]
        finally:
            module.lock_check_reset()
            module.enable_lock_check(was)
    assert scenario("torch") == scenario("jax")


def test_misuse_raises_as_jax():
    def scenario(package):
        module = LOCKS[package]
        out = []
        lock = module.Lock("t_misuse")
        with pytest.raises(RuntimeError) as error:
            lock.release()
        out.append(str(error.value))
        lock.acquire("main-thread")
        errors = []

        def foreign():
            try:
                lock.release()
            except RuntimeError as exc:
                errors.append(str(exc))

        thread = threading.Thread(target=foreign, name="intruder")
        thread.start()
        thread.join()
        out.append(errors)
        out.append(lock.holder() == ("main-thread",
                                     threading.current_thread().name))
        out.append(lock.in_use())
        lock.release()
        out.append((lock.holder(), lock.in_use(), lock.max_hold >= 0.0))
        return out
    out = scenario("torch")
    assert out == scenario("jax")
    assert "release without acquire" in out[0] and "intruder" in out[1][0]


@pytest.mark.parametrize("value, enabled", [("1", True), ("0", False),
                                            ("", False), ("yes", True)])
def test_aiko_lock_check_is_read_at_import(value, enabled):
    env = {**os.environ, "AIKO_LOCK_CHECK": value}
    result = subprocess.run(
        [sys.executable, "-c",
         "import aiko_services_tpu_torch.utils.lock as L; "
         "print(L.lock_check_enabled())"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == str(enabled)


def test_the_threaded_parts_report_nothing(checked):
    from test_torch_compute_pipelined import _sums
    from test_torch_tiered import prefetch_cycle
    from torch_ops_host import Host

    # the host tier's promoter: a worker thread stages, the loop installs
    assert prefetch_cycle("torch")[3] > 0
    # the pipelined results worker: split() off the loop
    assert len(_sums(True)) == 7
    # the publisher, the health aggregator and the autoscaler on one
    # engine, fed retained snapshots
    host = Host("torch")
    m = host.m
    publisher_rt, watcher_rt = host.runtime("lk_pub"), host.runtime("lk_agg")
    registry = m.metrics.MetricsRegistry()
    depth = registry.gauge("event_mailbox_depth")
    publisher = m.export.MetricsPublisher(publisher_rt, interval=0.5,
                                          registry=registry, jitter=0.2)
    aggregator = m.series.HealthAggregator(
        watcher_rt, interval=0.5, registry=m.metrics.MetricsRegistry(),
        rules=[m.series.SLORule(name="deep", kind="level",
                                series="event_mailbox_depth",
                                threshold=50.0, window=2.0)])

    class Fleet:
        clients = {"0": None}

        def scale_to(self, count, drain_s=None):
            delta = count - len(self.clients)
            self.clients = {str(i): None for i in range(count)}
            return delta

    autoscaler = m.autoscaler.Autoscaler(
        watcher_rt, "lk_scale", manager=Fleet(), interval=0.5,
        policy=m.autoscaler.ScalePolicy(hysteresis=2, cooldown=1.0))
    for level in (10, 80, 120, 90, 5, 1, 1, 1):
        depth.set(level)
        host.settle_virtual(1.0)
    assert aggregator.fired.get("deep") == 1
    assert len(autoscaler.manager.clients) > 1
    snapshot = json.loads(json.dumps(registry.snapshot()))
    assert "metrics_publish_seconds" in snapshot
    for part in (publisher, aggregator, autoscaler):
        part.stop()

    assert TLock.lock_check_report() == []
    assert set(checked) >= {"observe.registry", "batching.scheduler"}
    assert any(name.endswith("._ready") for name in checked)
