"""The port's serving-plane fault injection (serving_chaos.py) against
the JAX package's (tests/test_drain_migrate.py's TestChaosDecoder).

A preemption at a stated round drains the decoder and delivers the
partial generation through the request's callback (no evacuation
route), and the resumed continuation equals the never-preempted run; a
pool-growth refusal aborts the admit wave, re-queues and evacuates the
request, and the decoder serves again after disarm and resume; a hung
scan (an injected wall clock) drains an idle decoder at once; unarmed,
the wrapper is transparent.  Tokens, alert kinds, chaos and drain
counters and journey outcomes equal JAX's (tiny preset, f32), each
fault logs one WARNING that a FlightLogHandler puts in the flight
recorder, and the chaos_decoder_events_total family is in the
registry."""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.serving_chaos import ChaosDecoder as JChaos
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe import flight as TF
from aiko_services_tpu_torch.observe.metrics import default_registry
from aiko_services_tpu_torch.serving_chaos import ChaosDecoder as TChaos
from aiko_services_tpu_torch.serving_chaos import ChaosPoolRefusal

from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def oracle(prompt, max_new) -> list:
    out = jax.jit(functools.partial(JL.llama_greedy_decode, config=J_CONFIG,
                                    max_tokens=max_new))(
        weights()[0], prompt=jnp.asarray([prompt], jnp.int32))
    return [int(t) for t in np.asarray(out)[0]]


_SEQ = [0]


def chaos_for(package: str, **chaos_kwargs):
    _SEQ[0] += 1
    name = f"cd{package}{_SEQ[0]}"
    params, model = weights()
    module = JS if package == "jax" else TS
    cache = module.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                 name=name)
    kwargs = {"max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4, "paged_kv": True, "kv_block": 8,
              "prefix_cache": cache, "name": name}
    if package == "torch":
        decoder = TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                       **kwargs)
        chaos = TChaos(decoder, name=name, **chaos_kwargs)
    else:
        decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
        fresh_table_scratch(decoder)
        chaos = JChaos(decoder, name=name, **chaos_kwargs)
    kinds = []
    chaos.on_alert.append(lambda kind, detail: kinds.append(kind))
    return decoder, chaos, kinds


def run(decoder, requests, rounds=400) -> dict:
    done = {}
    for rid, (prompt, max_new) in requests.items():
        assert decoder.submit(rid, prompt, max_new,
                              lambda rid, t: done.update({rid: [
                                  int(x) for x in t]}))
    for _ in range(rounds):
        decoder.pump()
        if len(done) == len(requests):
            break
    assert len(done) == len(requests)
    return done


def summary(decoder, chaos, kinds) -> tuple:
    return (kinds, dict(chaos.stats),
            [d["request_id"] for d in chaos.evacuated],
            {k: decoder.stats[k] for k in ("drain_evacuated",
                                           "drain_checkpoints",
                                           "drain_refused")},
            [journey.outcome for journey in decoder.journeys.journeys()])


def preemption(package: str):
    decoder, chaos, kinds = chaos_for(package)
    chaos.arm_preemption(at_round=3)
    done = {}
    assert decoder.submit("a", PROMPT, 32,
                          lambda rid, t: done.update({rid: [int(x)
                                                            for x in t]}))
    for _ in range(50):
        chaos.pump()
        if decoder.drained:
            break
    partial = done["a"]
    chaos.disarm()
    decoder.resume()
    out = run(decoder, {"a2": (PROMPT + partial, 32 - len(partial))})
    return (partial, out["a2"], decoder.drained) + \
        summary(decoder, chaos, kinds)


def test_preemption_checkpoints_and_resumes_token_for_token():
    recorder = TF.FlightRecorder(name="chaos-decoder")
    handler = TF.FlightLogHandler()
    logging.getLogger("serving.chaos").addHandler(handler)
    try:
        expected = preemption("jax")
        got = preemption("torch")
    finally:
        logging.getLogger("serving.chaos").removeHandler(handler)
        recorder.close()
    assert got == expected
    partial, rest, _, kinds, stats, evacuated, drains, journeys = got
    assert kinds == ["preemption"] and evacuated == ["a"]
    assert stats["preemptions"] == 1 and stats["drains"] == 1
    assert len(partial) < 32 and partial + rest == oracle(PROMPT, 32)
    assert drains["drain_checkpoints"] == 1
    assert journeys[0] == "evacuated"
    assert "chaos_decoder_events_total" in default_registry().snapshot()
    # one WARNING per injected fault, from the port decoder's logger
    faults = [log for log in recorder.logs if "fault at round" in log[3]]
    assert len(faults) == 1 and faults[0][2].startswith("serving.chaos.")


def refusal(package: str):
    decoder, chaos, kinds = chaos_for(package)
    pool = decoder.pool
    held = pool.alloc_blocks(len(pool._free))       # dry the free list
    chaos.arm_alloc_refusal(rounds=50)
    done = {}
    assert decoder.submit("a", PROMPT, 6,
                          lambda rid, t: done.update({rid: [int(x)
                                                            for x in t]}))
    for _ in range(20):
        chaos.pump()
        if decoder.drained:
            break
    prompt = chaos.evacuated[0]["prompt"]
    chaos.disarm()
    pool.release_blocks(held)
    decoder.resume()
    out = run(decoder, {"a2": (PROMPT, 6)})
    return (done, prompt, out["a2"], decoder.drained,
            chaos.stats["alloc_refusals"] >= 1) + \
        summary(decoder, chaos, kinds)


def test_pool_refusal_escalates_and_recovers():
    expected = refusal("jax")
    got = refusal("torch")
    assert got == expected
    done, prompt, out, _, refused, kinds, _, evacuated, *_ = got
    assert refused and kinds == ["pool_refusal"] and evacuated == ["a"]
    assert "a" in done and prompt == PROMPT
    assert out == oracle(PROMPT, 6)


def test_refused_growth_raises_the_injected_fault():
    decoder, chaos, _ = chaos_for("torch")
    pool = decoder.pool
    chaos.arm_alloc_refusal(rounds=5)
    pool.alloc_blocks(len(pool._free))              # from the free list
    with pytest.raises(ChaosPoolRefusal, match="growth refused"):
        pool.alloc_blocks(1)
    chaos.disarm()
    assert pool.alloc_blocks(1)                     # grows again
    with pytest.raises(ValueError, match="paged decoder"):
        TChaos(TS.ContinuousDecoder(weights()[1], T_CONFIG, device="cpu",
                                    max_slots=2)).arm_alloc_refusal(1)


def hung(package: str):
    ticks = [0.0]

    def clock():
        ticks[0] += 5.0
        return ticks[0]

    decoder, chaos, kinds = chaos_for(package, clock=clock)
    chaos.arm_hung_scan(threshold_s=1.0)
    chaos.pump()
    refused = decoder.submit("x", PROMPT, 4, lambda *_: None)
    return (decoder.draining, decoder.drained, refused) + \
        summary(decoder, chaos, kinds)


def test_hung_scan_watchdog_drains():
    expected = hung("jax")
    got = hung("torch")
    assert got == expected
    assert got[:3] == (True, True, False)
    assert got[3] == ["hung_scan"] and got[4]["hung_scans"] == 1


def test_unarmed_chaos_is_transparent():
    results = []
    for package in ("jax", "torch"):
        decoder, chaos, kinds = chaos_for(package)
        done = {}
        assert decoder.submit("a", PROMPT, 6,
                              lambda rid, t: done.update({rid: [
                                  int(x) for x in t]}))
        for _ in range(400):
            chaos.pump()
            if "a" in done:
                break
        results.append((done, chaos.stats["alerts"], decoder.draining,
                        kinds))
    assert results[1] == results[0]
    assert results[1][0]["a"] == oracle(PROMPT, 6)
    assert results[1][1:] == (0, False, [])
