"""Session KV migration (SessionMigrator) on the port against the JAX
package (tests/test_drain_migrate.py TestMigrate and
tests/test_kv_ledger.py's migration case): two serving sides, each a
paged decoder, a prefix cache, a SessionTable and a migrator pumping
flat-out on one real-clock engine and broker.  A session served on side
A migrates to side B over chunk-streamed kv_transfer envelopes; its next
turn on B is a prefix hit whose tokens equal JAX's and
llama_greedy_decode's; the migrators' counters equal JAX's; the source
drains to zero pool blocks and both ledgers stay clean.  Also: handle
shipping to a warm destination, a host-tier source (rows promoted before
they ship), an empty table, an offer nobody answers (expiry: the session
stays at the source) and a destination whose table sheds the session
(refusal: done withheld)."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import process as JPR
from aiko_services_tpu import serving as JS
from aiko_services_tpu import serving_disagg as JD
from aiko_services_tpu import serving_tiered as JT
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.observe import ledger as JLG
from aiko_services_tpu.state import sessions as JSS
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import process as TPR
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch import serving_disagg as TD
from aiko_services_tpu_torch import serving_tiered as TT
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe import ledger as TLG
from aiko_services_tpu_torch.state import sessions as TSS
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
# 41 prompt tokens + 8 generated = 49: six full blocks at block 8
PROMPT41 = PROMPT + [5]
PACKAGES = {"jax": (JE, JPR, JS, JD, JT, JLG, JSS, JM),
            "torch": (TE, TPR, TS, TD, TT, TLG, TSS, TM)}
MIGRATOR_STATS = ("offers", "received", "acks", "chunks", "shipped_blocks",
                  "handle_blocks", "installed_blocks", "landed",
                  "migrated", "refused", "expired", "dropped_chunks",
                  "corrupt")
_SEQ = [0]


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def oracle(params, prompt, max_new):
    out = jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=max_new))(
        params, prompt=jnp.asarray([prompt], jnp.int32))
    return [int(t) for t in np.asarray(out)[0]]


class Side:
    """One serving runtime of one package: paged decoder, prefix cache
    (with a host tier of host_mb MiB when given), session table and
    migrator, pumping flat-out on the shared engine and broker."""

    def __init__(self, package, engine, broker, weights, name,
                 host_mb=None, chunk_blocks=8, ledger=False,
                 max_sessions=None, transfer_timeout=10.0):
        (_, process, serving, disagg, tiered, ledgers, sessions,
         memory) = PACKAGES[package]
        self.package = package

        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain,
                client_id=name)
        self.rt = process.ProcessRuntime(
            name=name, engine=engine,
            transport_factory=factory).initialize()
        _SEQ[0] += 1
        tag = f"tm{_SEQ[0]}{package}"
        self.cache = serving.PrefixKVCache(block_tokens=8,
                                           max_bytes=64 << 20, name=tag)
        if host_mb:
            self.cache.attach_host_store(tiered.HostBlockStore(
                max_bytes=host_mb << 20, name=f"{tag}h"))
        tree, config, extra = (weights[0], J_CONFIG, {}) \
            if package == "jax" else (weights[1], T_CONFIG,
                                      {"device": "cpu"})
        self.decoder = serving.ContinuousDecoder(
            tree, config, paged_kv=True, kv_block=8,
            prefix_cache=self.cache, max_slots=4, prefill_buckets=(64,),
            steps_per_sync=4, name=tag, **extra)
        self.ledger = None
        if ledger:
            self.ledger = ledgers.KVMemoryLedger(name=tag)
            self.decoder.attach_ledger(self.ledger)
        budget = sessions.TenantBudget(max_sessions=max_sessions) \
            if max_sessions else None
        self.table = sessions.SessionTable(
            SimpleNamespace(runtime=self.rt, topic_path=self.rt.topic_path),
            num_shards=1, default_budget=budget)
        self.mig = disagg.SessionMigrator(
            self.rt, self.cache, table=self.table, name=tag,
            chunk_blocks=chunk_blocks, transfer_timeout=transfer_timeout)
        self.engine = engine
        engine.add_flatout_handler(self.decoder.pump)

    def turn(self, rid, prompt, max_new, timeout=120.0):
        done = {}
        assert self.decoder.submit(rid, prompt, max_new,
                                   lambda r, t: done.update({r: t}))
        assert self.engine.run_until(lambda: rid in done, timeout=timeout)
        return [int(t) for t in done[rid]]

    def store(self, sid, history):
        leaf, kv_tokens = self.cache.session_store("default", sid, history)
        assert self.table.create("default", sid, {
            "history": history, "kv": leaf or "", "kv_tokens": kv_tokens})
        return kv_tokens

    def stop(self):
        self.mig.stop()
        self.table.stop()
        self.engine.remove_flatout_handler(self.decoder.pump)
        self.rt.terminate()


def pair(package, weights, host_a=None, chunk_blocks=8, **kwargs):
    event, *_, memory = PACKAGES[package]
    engine, broker = event.EventEngine(), memory.MemoryBroker()
    a = Side(package, engine, broker, weights, f"mig_a_{package}",
             host_mb=host_a, chunk_blocks=chunk_blocks,
             ledger=kwargs.get("ledger", False))
    b = Side(package, engine, broker, weights, f"mig_b_{package}",
             chunk_blocks=chunk_blocks, **kwargs)
    return engine, a, b


def migrate(engine, a, b, timeout=30.0):
    done = []
    sent = a.mig.migrate(b.mig.topic, on_done=lambda m: done.append(1))
    assert engine.run_until(lambda: bool(done), timeout=timeout)
    return sent


def both(weights, scenario):
    out = {}
    for package in PACKAGES:
        out[package] = scenario(package)
    assert out["torch"] == out["jax"]
    return out["torch"]


def migrator_stats(side) -> dict:
    return {k: side.mig.stats[k] for k in MIGRATOR_STATS}


@pytest.mark.parametrize("chunk_blocks", [2, 8])
def test_full_migration_chunked_wire(weights, chunk_blocks):
    """A turn on A, a migration to B over chunk-streamed envelopes, and
    turn 2 on B is a prefix hit; A drains to zero pool blocks and both
    ledgers are clean, with migrate_out / migrate_in recorded."""
    def scenario(package):
        engine, a, b = pair(package, weights, chunk_blocks=chunk_blocks,
                            ledger=True)
        ledgers = PACKAGES[package][5]
        try:
            out = a.turn("t1", PROMPT41, 8)
            history = PROMPT41 + out
            assert a.store("s1", history) == 48
            assert migrate(engine, a, b) == 1
            assert a.mig.pending_count() == b.mig.pending_count() == 0
            _, hit = b.cache.match("default", history[:48])
            landed = (hit, b.cache.sessions(),
                      b.table.get("default", "s1")["history"] == history,
                      len(a.table), a.cache.sessions())
            events = (a.ledger.stats["migrate_out"],
                      b.ledger.stats["migrate_in"],
                      a.ledger.audit(), b.ledger.audit())
            a.cache.purge(demote=False)
            ledgers.assert_ledger_clean(cache=a.cache, ledger=a.ledger)
            prompt2 = history + [9, 2, 4]
            out2 = b.turn("t2", prompt2, 8)
            b.cache.release_sessions([("default", "s1")])
            b.cache.purge(demote=False)
            ledgers.assert_ledger_clean(cache=b.cache, ledger=b.ledger)
            return (out, out2, migrator_stats(a), migrator_stats(b),
                    landed, events, b.decoder.stats["prefix_admits"])
        finally:
            a.stop()
            b.stop()

    out, out2, a_stats, b_stats, landed, events, admits = \
        both(weights, scenario)
    assert out2 == oracle(weights[0], PROMPT41 + out + [9, 2, 4], 8)
    # a cold destination: all six blocks ship, in ceil(6 / chunk)
    # envelopes, none as handles
    assert (a_stats["offers"], a_stats["migrated"], a_stats["expired"],
            a_stats["shipped_blocks"], a_stats["handle_blocks"],
            a_stats["chunks"]) == (1, 1, 0, 6, 0, -(-6 // chunk_blocks))
    assert (b_stats["landed"], b_stats["refused"],
            b_stats["installed_blocks"], b_stats["dropped_chunks"]) == \
        (1, 0, 6, 0)
    assert landed == (48, [("default", "s1")], True, 0, [])
    assert events == (6, 6, [], [])
    assert admits == 1


def test_handle_shipping_skips_resident_blocks(weights):
    """A destination that computed the same chain acks it as resident:
    every block crosses as a handle and only the bare final leg ships."""
    def scenario(package):
        engine, a, b = pair(package, weights)
        try:
            out = a.turn("t1", PROMPT41, 8)
            history = PROMPT41 + out
            assert a.store("s1", history) == 48
            assert b.turn("warm", PROMPT41, 8) == out
            assert migrate(engine, a, b) == 1
            return (migrator_stats(a), migrator_stats(b),
                    b.cache.sessions(),
                    b.table.get("default", "s1")["history"] == history,
                    len(a.table))
        finally:
            a.stop()
            b.stop()

    a_stats, b_stats, sessions, same, left = both(weights, scenario)
    assert (a_stats["handle_blocks"], a_stats["shipped_blocks"],
            a_stats["chunks"]) == (6, 0, 1)
    assert (b_stats["landed"], b_stats["installed_blocks"]) == (1, 0)
    assert sessions == [("default", "s1")] and same and left == 0


def test_host_tier_rows_promote_before_shipping(weights):
    """A demoted session (its rows on the host tier) still migrates: the
    ack leg promotes the chain back into the pool, then ships it."""
    def scenario(package):
        engine, a, b = pair(package, weights, host_a=64)
        try:
            out = a.turn("t1", PROMPT41, 8)
            history = PROMPT41 + out
            assert a.store("s1", history) == 48
            demoted = a.cache.demote_sessions([("default", "s1")])
            assert migrate(engine, a, b) == 1
            _, hit = b.cache.match("default", history[:48])
            return (demoted > 0, migrator_stats(a), migrator_stats(b), hit,
                    b.table.get("default", "s1")["history"] == history)
        finally:
            a.stop()
            b.stop()

    demoted, a_stats, b_stats, hit, same = both(weights, scenario)
    assert demoted and same and hit == 48
    assert (a_stats["migrated"], a_stats["shipped_blocks"],
            b_stats["installed_blocks"]) == (1, 6, 6)


def test_several_sessions_migrate_and_the_source_drains(weights):
    """Three sessions migrate together; every next turn on B is a prefix
    hit and A's pool drains to zero after the purge."""
    prompts = {f"s{i}": [(t + 3 * i) % 200 + 1 for t in PROMPT41]
               for i in range(3)}

    def scenario(package):
        engine, a, b = pair(package, weights, chunk_blocks=4)
        try:
            histories = {}
            for sid, prompt in prompts.items():
                histories[sid] = prompt + a.turn(sid, prompt, 8)
                assert a.store(sid, histories[sid]) == 48
            assert migrate(engine, a, b) == 3
            a.cache.purge(demote=False)
            drained = a.decoder.pool.used_blocks()
            turns = {sid: b.turn(f"{sid}.2", history + [7], 4)
                     for sid, history in histories.items()}
            return (turns, migrator_stats(a), migrator_stats(b), drained,
                    b.decoder.stats["prefix_admits"], sorted(
                        b.cache.sessions()))
        finally:
            a.stop()
            b.stop()

    turns, a_stats, b_stats, drained, admits, sessions = \
        both(weights, scenario)
    assert (a_stats["offers"], a_stats["migrated"],
            a_stats["shipped_blocks"], a_stats["chunks"]) == (3, 3, 18, 6)
    assert b_stats["installed_blocks"] == 18 and drained == 0
    assert admits == 3 and len(sessions) == 3


def test_empty_table_fires_done_immediately(weights):
    def scenario(package):
        engine, a, b = pair(package, weights)
        try:
            done = []
            sent = a.mig.migrate(b.mig.topic,
                                 on_done=lambda m: done.append(1))
            return sent, done
        finally:
            a.stop()
            b.stop()

    assert both(weights, scenario) == (0, [1])


def test_unanswered_offer_expires_and_the_session_stays(weights):
    """An offer to a topic nobody serves times out: expired, and the
    session (record and pin) stays at the source."""
    def scenario(package):
        engine, a, b = pair(package, weights)
        a.mig.transfer_timeout = 0.2
        try:
            out = a.turn("t1", PROMPT41, 8)
            assert a.store("s1", PROMPT41 + out) == 48
            done = []
            assert a.mig.migrate(f"{b.rt.topic_path}/nowhere",
                                 on_done=lambda m: done.append(1)) == 1
            assert engine.run_until(lambda: bool(done), timeout=10.0)
            return (migrator_stats(a), len(a.table), a.cache.sessions(),
                    a.mig.pending_count())
        finally:
            a.stop()
            b.stop()

    a_stats, kept, sessions, pending = both(weights, scenario)
    assert (a_stats["offers"], a_stats["expired"],
            a_stats["migrated"]) == (1, 1, 0)
    assert kept == 1 and sessions == [("default", "s1")] and pending == 0


def test_shed_destination_withholds_done(weights):
    """A destination whose table sheds the session releases the pin it
    took and withholds done: the source times out and keeps the
    session, and the corrupt leg is counted on the destination."""
    def scenario(package):
        engine, a, b = pair(package, weights, max_sessions=1,
                            transfer_timeout=0.5)
        a.mig.transfer_timeout = 0.5
        try:
            out = a.turn("t1", PROMPT41, 8)
            assert a.store("s1", PROMPT41 + out) == 48
            assert b.table.create("default", "other", {"history": []})
            done = []
            assert a.mig.migrate(b.mig.topic,
                                 on_done=lambda m: done.append(1)) == 1
            assert engine.run_until(lambda: bool(done), timeout=10.0)
            b.mig._on_message("", b"not an envelope")
            return (migrator_stats(a), migrator_stats(b), len(a.table),
                    b.cache.sessions(), b.table.get("default", "s1"))
        finally:
            a.stop()
            b.stop()

    a_stats, b_stats, kept, b_sessions, record = both(weights, scenario)
    assert (a_stats["expired"], a_stats["migrated"]) == (1, 0)
    assert (b_stats["refused"], b_stats["landed"], b_stats["corrupt"],
            b_stats["installed_blocks"]) == (1, 0, 1, 6)
    assert kept == 1 and b_sessions == [] and record is None


def test_migrator_needs_a_cache():
    with pytest.raises(ValueError, match="PrefixKVCache"):
        TD.SessionMigrator(SimpleNamespace(topic_path="x"), None)
