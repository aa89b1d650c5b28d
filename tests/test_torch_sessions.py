"""The port's session state plane (state/sessions.py) against the JAX
package's, call for call: one script drives a SessionTable on each
package's engine under a virtual clock (create, get, update, touch,
lease expiry off the timer wheel, idle demotion, byte-budget demotion,
count-budget shedding, remove, a consumer SessionView, stop) and records
every return value, the table's accounting after each call and every
on_expired / on_demoted batch; the two records must be equal.  Also the
shard mapping, and the prefix cache's session pins released through the
hooks (tests/test_prefix_cache.py:310-355) on both packages."""

import dataclasses

import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu import process as JProcess
from aiko_services_tpu import service as JService
from aiko_services_tpu.state import sessions as JSessions
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import process as TProcess
from aiko_services_tpu_torch import service as TService
from aiko_services_tpu_torch.state import sessions as TSessions
from aiko_services_tpu_torch.transport import memory as TM

PACKAGES = {"jax": (JE, JM, JProcess, JService, JSessions),
            "torch": (TE, TM, TProcess, TService, TSessions)}


def _runtime(package, name="sessions_host"):
    event, memory, process, service, sessions = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = process.ProcessRuntime(name=name, engine=engine,
                                     transport_factory=factory).initialize()
    return engine, runtime, service.Service(runtime, "kv_table"), sessions


def _accounting(table):
    return {"len": len(table), "items": table.items(),
            "bytes": {t: table.tenant_bytes(t) for t in ("a", "b")},
            "counts": {t: table.tenant_sessions(t) for t in ("a", "b")},
            "timers": table.outstanding_timers(),
            "delta_bytes": table.delta_bytes(),
            "stats": dict(table.stats)}


def _table_script(package):
    engine, runtime, service, sessions = _runtime(package)
    event = PACKAGES[package][0]
    hooks = []
    table = sessions.SessionTable(
        service, num_shards=3, lease_time=2.0,
        budgets={"a": sessions.TenantBudget(max_sessions=3,
                                            max_bytes=120),
                 "b": sessions.TenantBudget(max_sessions=1)},
        on_expired=lambda keys: hooks.append(("expired", list(keys))),
        on_demoted=lambda keys: hooks.append(("demoted", list(keys))),
        demote_idle=1.5)
    view = sessions.SessionView(runtime, service.topic_path, 3,
                                tenants="a")
    log = []

    def note(value):
        log.append((value, _accounting(table), list(hooks),
                    round(engine.clock.now(), 6)))

    note(table.create("a", "s1", {"history": [1, 2, 3]}))
    note(table.create("a", "s2", {"history": "x" * 60}))
    note(table.create("b", "s1", "payload"))
    note(table.create("b", "s2", "over the count budget"))
    with pytest.raises(ValueError):
        table.create("a.b", "s", None)
    note(table.get("a", "s1"))
    event.settle_virtual(engine, 1.0)
    note(table.touch("a", "s1"))
    # a's byte budget demotes its oldest-touched sessions
    note(table.create("a", "s3", {"history": "y" * 70}))
    note(table.get("a", "s2"))
    event.settle_virtual(engine, 0.8)
    note(table.update("a", "s2", {"history": [4]}))
    note(table.get("a", "s2"))
    # b/s1 lapses; a/s1 idles past demote_idle before its lease lapses
    event.settle_virtual(engine, 1.0)
    note(view.get("a", "s1"))
    note(view.synchronized)
    note(table.remove("a", "s3"))
    note(table.create("a", "s3", None, lease_time=10.0))
    event.settle_virtual(engine, 3.0)
    note(sorted(view.cache))
    view.terminate()
    table.stop()
    note(engine.live_timer_handlers() and
         any(getattr(h, "__self__", None) is table
             for h in engine.live_timer_handlers()))
    return log


def test_session_shards_are_the_jax_mapping():
    for tenant, sid, shards in (("a", "s1", 8), ("default", "c0", 2),
                                ("t", "x" * 40, 3), ("é", "1", 5)):
        assert TSessions.session_shard(tenant, sid, shards) == \
            JSessions.session_shard(tenant, sid, shards)


def test_session_table_script_agrees_call_for_call():
    port = _table_script("torch")
    assert port == _table_script("jax")
    hooks = port[-1][2]
    assert any(kind == "expired" and ("b", "s1") in keys
               for kind, keys in hooks)
    assert any(kind == "demoted" for kind, _ in hooks)


def test_budgets_and_stop_leave_no_timer():
    engine, runtime, service, sessions = _runtime("torch", "budgets")
    table = sessions.SessionTable(
        service, num_shards=2, lease_time=5.0,
        default_budget=sessions.TenantBudget(max_sessions=2))
    assert table.create("t", "a") and table.create("t", "b")
    assert not table.create("t", "c")
    assert table.stats["shed"] == 1 and len(table) == 2
    assert dataclasses.asdict(sessions.TenantBudget()) == \
        {"max_sessions": None, "max_bytes": None}
    table.stop()
    assert not any(getattr(h, "__self__", None) is table
                   for h in engine.live_timer_handlers())
    # a KV memory ledger counts the table's lease pins and demotions
    from aiko_services_tpu_torch.observe.ledger import KVMemoryLedger
    engine, runtime, service, sessions = _runtime("torch", "ledgered")
    table = sessions.SessionTable(
        service, num_shards=2, lease_time=5.0,
        default_budget=sessions.TenantBudget(max_bytes=8))
    ledger = KVMemoryLedger(name="sessions")
    table.attach_ledger(ledger)
    assert table.create("t", "a", {"history": [1, 2, 3, 4]})
    assert ledger.stats["lease_pin"] == 1
    assert table.create("t", "b", {"history": [5, 6, 7, 8, 9]})
    assert ledger.stats["lease_pin"] == 2
    assert ledger.stats["lease_demote"] == table.stats["demoted"] >= 1
    table.stop()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_session_hooks_release_prefix_cache_pins(package):
    """Lease expiry and byte-budget demotion release the conversation KV
    pins the prefix cache holds for a session, through the table's
    hooks (on a paged cache here: the port has no other)."""
    from test_torch_prefix_cache import _cache, _insert_chain
    engine, runtime, service, sessions = _runtime(package, "kv_host")
    event = PACKAGES[package][0]
    cache, pool, _ = _cache(package, name=f"sess{package}")
    table = sessions.SessionTable(service, num_shards=2, lease_time=2.0,
                                  budgets={"t": sessions.TenantBudget(
                                      max_bytes=120)},
                                  on_expired=cache.release_sessions,
                                  on_demoted=cache.demote_sessions)
    _insert_chain(cache, pool, "t", list(range(8)))
    leaf, pinned = cache.session_store("t", "s1", list(range(8)))
    assert leaf is not None and pinned == 8
    assert table.create("t", "s1", {"kv": leaf, "kv_tokens": pinned})
    cache.session_store("t", "s2", list(range(4)))
    table.create("t", "s2", {"history": "x" * 100})
    cache.session_store("t", "s3", list(range(8)))
    # s3's payload pushes the tenant over its bytes: the oldest-touched
    # sessions, s1 and then s2, demote and their pins drop
    table.create("t", "s3", {"history": "y" * 100})
    assert cache.stats["session_released"] == 2
    assert cache.sessions() == [("t", "s3")]
    event.settle_virtual(engine, 2.5)
    assert len(table) == 0
    assert cache.stats["session_released"] == 3
    assert all(node.refs == 0 for node in cache._nodes.values())
    table.stop()
    assert cache.purge() == 2 and pool.used_blocks() == 0
