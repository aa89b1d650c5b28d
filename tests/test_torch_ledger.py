"""The port's KV memory ledger (observe/ledger.py) against the JAX
package's.

Ledger scripts run call for call on both packages (balances per tenant
and tier, byte-seconds on an injected clock, events, moves, violations,
the occupancy trend, the registry families).  Then a paged decoder +
prefix cache + pool + host store stack with a ledger attached serves
two tenants, demotes every session, promotes the chains back, serves
again and purges, on both packages (tiny preset, f32, native and int8):
at every pump round the port ledger's device bytes equal the pool's
used blocks x block_nbytes, its host bytes the store's, both equal the
JAX ledger's totals, the auditor finds nothing, and after the purge
every tier is at zero.  The auditor's findings (gauge drift, a seeded
host orphan, a seeded double release that lands in the flight
recorder's fault ring under its chain key) and the admission gate's
byte verdict (set_byte_policy / shed_on_bytes) are held against JAX's."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.observe import ledger as JLG
from aiko_services_tpu.observe import metrics as JM
from aiko_services_tpu.ops import admission as JA
from aiko_services_tpu.serving_tiered import HostBlockStore as JStore
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe import flight as TF
from aiko_services_tpu_torch.observe import ledger as TLG
from aiko_services_tpu_torch.observe import metrics as TM
from aiko_services_tpu_torch.ops import admission as TA
from aiko_services_tpu_torch.serving_tiered import HostBlockStore as TStore

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT_A = [(i * 13) % 50 + 1 for i in range(40)] + [5]
PROMPT_B = [(i * 7) % 50 + 1 for i in range(40)] + [9]


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


# -- ledger scripts ----------------------------------------------------------

def ledger_script(module, metrics):
    t = [0.0]
    registry = metrics.MetricsRegistry()
    ledger = module.KVMemoryLedger(name="script", registry=registry,
                                   clock=lambda: t[0], trend_window=5.0)
    calls = [("device", "tA", 4096, "alloc"), ("device", "tB", 2048,
                                                "alloc"),
             ("host", "tA", 1024, "demote"), ("device", "tA", -1024,
                                               "release"),
             ("move", "tA", "demote", 2), ("event", "session_pin", 3),
             ("device", "", 512, "cow"), ("host", "tA", -1024, "promote"),
             ("move", "tA", "promote", 1), ("device", "tB", -4096,
                                             "release"),
             ("device", "tB", 2048, "alloc"), ("host", "tC", 0, "")]
    trace = []
    for i, call in enumerate(calls):
        t[0] = 0.5 * i
        if call[0] == "device":
            ledger.device_delta(*call[1:])
        elif call[0] == "host":
            ledger.host_delta(*call[1:])
        elif call[0] == "move":
            ledger.move(*call[1:])
        else:
            ledger.event(*call[1:])
        trace.append((ledger.device_bytes(), ledger.host_bytes(),
                      ledger.tenants(), ledger.device_trend(),
                      round(ledger.byte_seconds(), 9)))
    violations = [{k: v for k, v in record.items() if k != "t"}
                  for record in ledger.violations]
    return trace, dict(ledger.stats), violations, registry.snapshot()


def test_ledger_script_matches_call_for_call():
    expected = ledger_script(JLG, JM)
    got = ledger_script(TLG, TM)
    assert got[0] == expected[0]
    assert got[1] == expected[1]
    assert got[2] == expected[2]
    # tB's release past its balance is the one negative-balance finding
    assert [v["kind"] for v in got[2]] == ["negative-balance"]
    assert got[3] == expected[3]


# -- the serving stack -------------------------------------------------------

_SEQ = [0]


def ledgered(package: str, **kwargs):
    """(decoder, cache, store, ledger): a paged decoder, its prefix cache
    and host tier, a ledger attached through the decoder."""
    _SEQ[0] += 1
    name = f"tlg{package}{_SEQ[0]}"
    params, model = weights()
    if package == "jax":
        module, store_type, ledger_type = JS, JStore, JLG.KVMemoryLedger
        config, weights_, extra = J_CONFIG, params, {}
    else:
        module, store_type, ledger_type = TS, TStore, TLG.KVMemoryLedger
        config, weights_, extra = T_CONFIG, model, {"device": "cpu"}
    cache = module.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                 name=name)
    store = store_type(max_bytes=64 << 20, name=f"{name}h")
    cache.attach_host_store(store)
    decoder = module.ContinuousDecoder(
        weights_, config, paged_kv=True, kv_block=8, prefix_cache=cache,
        max_slots=4, prefill_buckets=(64,), steps_per_sync=4, name=name,
        **kwargs, **extra)
    ledger = ledger_type(name=name)
    decoder.attach_ledger(ledger)
    return decoder, cache, store, ledger


def serve(decoder, requests, trace, ledger, store, rounds=400):
    """Pump to completion, appending each round's (device, host) ledger
    totals to `trace`; every round the ledger conserves against the pool
    and the store."""
    done = {}
    for rid, (prompt, max_new, tenant) in requests.items():
        assert decoder.submit(rid, prompt, max_new,
                              lambda rid, t: done.update({rid: t}),
                              tenant=tenant)
    pool = decoder.pool
    for _ in range(rounds):
        decoder.pump()
        trace.append((ledger.device_bytes(), ledger.host_bytes(),
                      {t: ledger.device_bytes(t) for t in ledger.tenants()}))
        assert ledger.device_bytes() == \
            pool.used_blocks() * pool.block_nbytes
        assert ledger.host_bytes() == store.bytes_used
        if len(done) == len(requests):
            break
    assert len(done) == len(requests)
    return done


def lifecycle(package: str, **kwargs):
    decoder, cache, store, ledger = ledgered(package, **kwargs)
    trace = []
    reqs = {"a": (PROMPT_A, 8, "tA"), "b": (PROMPT_B, 8, "tB")}
    out = serve(decoder, reqs, trace, ledger, store)
    pairs = []
    for rid, (prompt, _, tenant) in reqs.items():
        cache.session_store(tenant, rid, prompt + out[rid])
        pairs.append((tenant, rid))
    demoted = cache.demote_sessions(pairs)
    trace.append((ledger.device_bytes(), ledger.host_bytes(),
                  ledger.host_bytes("tA"), ledger.host_bytes("tB")))
    promoted = [cache.promote_for(tenant, prompt + out[rid])
                for rid, (prompt, _, tenant) in reqs.items()]
    trace.append((ledger.device_bytes(), ledger.host_bytes()))
    out2 = serve(decoder, {rid + "x": spec for rid, spec in reqs.items()},
                 trace, ledger, store)
    findings = ledger.audit()
    evicted = cache.purge(demote=False)
    return (out, out2, demoted, promoted, trace, findings, evicted,
            dict(ledger.stats)), (decoder, cache, store, ledger)


@pytest.mark.parametrize("extra", [{}, {"kv_cache_dtype": "int8"}],
                         ids=["native", "int8"])
def test_stack_conserves_every_round_like_jax(extra):
    expected, _ = lifecycle("jax", **extra)
    got, (decoder, cache, store, ledger) = lifecycle("torch", **extra)
    out, out2, demoted, promoted, trace, findings, evicted, stats = got
    assert out2["ax"] == out["a"] and out2["bx"] == out["b"]
    assert demoted > 0 and all(promoted) and findings == []
    assert got == expected
    # drained: pool, cache, store and ledger all at zero
    TLG.assert_ledger_clean(cache=cache, ledger=ledger)
    assert stats["demote"] > 0 and stats["promote"] > 0


def test_gauge_drift_is_found_once():
    decoder, cache, store, ledger = ledgered("torch")
    serve(decoder, {"a": (PROMPT_A, 8, "tA")}, [], ledger, store)
    assert ledger.audit() == []
    decoder.pool._used += 1
    assert {r["kind"] for r in ledger.audit()} == {"gauge-drift"}
    assert ledger.audit() == []                     # a standing finding
    ledger._device["tA"] += decoder.pool.block_nbytes
    assert "device-conservation" in {r["kind"] for r in ledger.audit()}
    decoder.pool._used -= 1
    ledger._device["tA"] -= decoder.pool.block_nbytes
    assert ledger.audit() == [] and not ledger._open


def test_seeded_leaks_name_their_chain_in_flight():
    recorder = TF.FlightRecorder(name="ledger-leaks")
    try:
        decoder, cache, store, ledger = ledgered("torch")
        out = serve(decoder, {"a": (PROMPT_A, 8, "tA")}, [], ledger,
                    store)
        key = TLG.seed_ledger_leak(cache=cache, kind="double-release")
        assert ledger.violations[-1]["chain_key"] == key
        assert ledger.violations[-1]["kind"] == "double-release"
        cache.session_store("tA", "a", PROMPT_A + out["a"])
        assert cache.demote_sessions([("tA", "a")]) > 0
        orphan = TLG.seed_ledger_leak(store=store, kind="orphan-host")
        found = [r for r in ledger.audit() if r["kind"] == "host-orphan"]
        assert found and found[0]["chain_key"] == orphan
        faults = [fault[1:3] for fault in recorder.faults]
        assert ("ledger-double-release", key) in faults
        assert ("ledger-host-orphan", orphan) in faults
    finally:
        recorder.close()


def test_device_trend_reads_a_drain():
    t = [0.0]
    ledger = TLG.KVMemoryLedger(name="trend", clock=lambda: t[0])
    ledger.device_delta("tA", 4096, "alloc")
    t[0] = 1.0
    ledger.device_delta("tA", -1024, "release")
    t[0] = 2.0
    ledger.device_delta("tA", -1024, "release")
    assert ledger.device_trend() == -1024.0
    assert ledger.device_bytes("tA") == 2048
    assert ledger.device_trend(window=0.5) is None


# -- the admission gate's byte verdict -----------------------------------------

def verdicts(admission, ledger_module):
    t = [0.0]
    ledger = ledger_module.KVMemoryLedger(name="gate", clock=lambda: t[0])
    gate = admission.AdmissionGate()
    out = [gate.shed_on_bytes("anyone")]              # disarmed
    gate.set_byte_policy(ledger, budget_bytes=4096,
                         tenant_budgets={"flood": 2048},
                         default_estimate=1024)
    ledger.device_delta("tA", 8192, "alloc")
    ledger.device_delta("flood", 1024, "alloc")
    out.append(gate.shed_on_bytes("flood"))           # 2048: at budget
    out.append(gate.shed_on_bytes("flood", estimate_bytes=1025))
    out.append(gate.shed_on_bytes("polite"))          # no balance
    t[0] = 1.0
    ledger.device_delta("tA", -2048, "release")
    t[0] = 2.0
    ledger.device_delta("tA", -2048, "release")
    for remaining in (None, 5.0, 0.1):
        out.append(gate.shed_on_bytes("tA", remaining=remaining))
    gate.set_byte_policy(None)
    out.append(gate.shed_on_bytes("tA"))
    return out


def test_byte_verdicts_match_jax():
    got = verdicts(TA, TLG)
    assert got == verdicts(JA, JLG)
    assert got[0] == (False, None)
    assert got[2] == (True, 2049)
    assert got[5:7] == [(False, 5120), (True, 5120)]
