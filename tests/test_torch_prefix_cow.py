"""Copy-on-extend, shared chains, eviction and admission of the port's
prefix-cached paged decoder against the JAX package's (its paged-kernel
decoder, Pallas in interpret mode), on the same weights, tiny preset in
f32: the seq-cap slide-back of tests/test_paged_kv.py:226 and :390 (the
one live writer of a shared block copies it first, and a third hit is
still identical), two slots aliasing one chain, two decoders sharing one
cache and pool, eviction down to zero live blocks, and the admit-wait
estimate's credit for prefix hits (tests/test_prefix_cache.py:436) with
AdmissionGate.watch_decoder and deadline shedding.  Greedy tokens must
be identical, and so must the counters; the estimate's credit is exact
(rel 1e-9: it is one product)."""

import dataclasses
import time

import pytest
import torch

from aiko_services_tpu.ops.admission import AdmissionGate as JGate
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
from aiko_services_tpu_torch.ops.admission import AdmissionGate as TGate

from test_torch_prefix_serving import (PROMPT, T_CONFIG,  # noqa: F401
                                       assert_same_stats, both, oracle, pair,
                                       run, weights)

torch.set_num_threads(1)

LONG = [(i * 7) % 50 + 1 for i in range(95)]       # max_seq 96 less one


def test_seq_cap_slide_back_copies_the_shared_block(weights):
    """A 95-token prompt at max_seq 96: the hit's finishing chunk cannot
    pad forward past the cap and slides back into the cached region;
    the shared block it would write is copied first, so the chain keeps
    its rows and a third hit is still identical to the cold run."""
    decoders = pair(weights, prefill_chunk=16)
    cold = oracle(weights[0], LONG, 1)
    for probe in ("w1", "w2", "w3"):
        jax_out, port_out = both(decoders, {probe: (LONG, 1)})
        assert port_out == jax_out == {probe: cold}, probe
    port, cache = decoders["torch"]
    assert port.stats["prefix_admits"] == 2
    assert port.stats["cow_copies"] >= 1
    assert port.pool.stats["cow_copies"] == port.stats["cow_copies"] == \
        decoders["jax"][0].pool.stats["cow_copies"]
    assert port.stats["cow_copy_bytes"] == \
        port.stats["cow_copies"] * port.pool.block_nbytes
    assert_same_stats(decoders)


def test_slide_back_at_width_two_with_int8_pools(weights):
    decoders = pair(weights, kv_cache_dtype="int8", prefill_chunk=16)
    both(decoders, {"donor": (LONG, 2)})
    jax_out, port_out = both(decoders, {"a": (LONG, 2),
                                        "b": (LONG[:90] + [5, 6, 7], 3)})
    assert port_out == jax_out
    assert decoders["torch"][0].stats["cow_copies"] >= 1
    assert_same_stats(decoders)


def test_two_slots_share_one_chain(weights):
    """Two concurrent hits alias the same pool blocks; each extends into
    its own fresh blocks, and after both retire every chain block is
    back to the cache's one ref."""
    decoders = pair(weights, prefill_chunk=16)
    both(decoders, {"donor": (PROMPT, 10)})
    port, cache = decoders["torch"]
    chain = [node.pool_id for node in cache._nodes.values()]
    jax_out, port_out = both(decoders, {"s1": (PROMPT, 10),
                                        "s2": (PROMPT, 10)})
    assert port_out == jax_out
    assert port_out["s1"] == port_out["s2"] == oracle(weights[0], PROMPT,
                                                      10)
    assert [port.pool.refs(block_id) for block_id in chain] == \
        [1] * len(chain)
    assert port.stats["cow_copies"] == 0
    assert_same_stats(decoders)


def test_eviction_releases_every_pool_block(weights):
    decoders = pair(weights, prefill_chunk=16)
    both(decoders, {"donor": (PROMPT, 10)})
    for decoder, cache in decoders.values():
        assert decoder.pool.used_blocks() == len(cache) > 0
        cache.max_bytes = 1
        cache._evict_to_budget("default")
        assert len(cache) == 0 and decoder.pool.used_blocks() == 0


def test_two_decoders_share_one_cache_and_pool(weights):
    _, model = weights
    cache = TS.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                             name="shared")
    common = dict(max_slots=4, prefill_buckets=(64,), steps_per_sync=4,
                  prefill_chunk=16, paged_kv=True, device="cpu")
    first = TS.ContinuousDecoder(model, T_CONFIG, prefix_cache=cache,
                                 **common)
    second = TS.ContinuousDecoder(model, T_CONFIG, prefix_cache=cache,
                                  **common)
    assert first.pool is second.pool is cache.pool
    run(first, {"donor": (PROMPT, 10)})
    out = run(second, {"probe": (PROMPT, 10)})
    assert out["probe"] == oracle(weights[0], PROMPT, 10)
    assert second.stats["prefix_admits"] == 1
    assert second.stats["prefix_copy_bytes"] == 0
    assert first.pool.used_blocks() == len(cache)
    other = dataclasses.replace(T_CONFIG, num_kv_heads=4)
    with pytest.raises(ValueError, match="already bound"):
        TS.ContinuousDecoder(model, other, prefix_cache=cache, **common)


def test_admit_wait_credits_prefix_hits_and_the_gate_reads_it(weights):
    """The estimate charges a prompt's prefill at the measured per-token
    rate and credits the tokens the cache would hit; the admission gate
    registers it as a wait source."""
    decoders = pair(weights, prefill_chunk=16)
    both(decoders, {"donor": (PROMPT, 10)})
    gates = {"jax": JGate(), "torch": TGate(registry=MetricsRegistry())}
    credits = {}
    for package, (decoder, _) in decoders.items():
        assert decoder._prefill_token_ewma is not None
        decoder._round_ewma = 0.010
        decoder._prefill_token_ewma = 0.001
        cold = decoder.estimated_admit_wait(prompt=[77] * len(PROMPT))
        warm = decoder.estimated_admit_wait(prompt=PROMPT)
        base = decoder.estimated_admit_wait()
        assert cold > warm >= base
        credits[package] = (cold - warm, warm, base)
        gates[package].watch_decoder(decoder)
        assert gates[package].estimated_wait() == pytest.approx(base)
    assert credits["torch"] == pytest.approx(credits["jax"], rel=1e-9)
    assert credits["torch"][0] == pytest.approx(32 * 0.001, rel=1e-9)


def test_deadlines_shed_what_the_estimate_cannot_meet(weights):
    decoders = pair(weights, prefill_chunk=16)
    both(decoders, {"donor": (PROMPT, 4)})
    for decoder, _ in decoders.values():
        decoder._round_ewma = 0.5
        accepted = decoder.submit("late", PROMPT, 4, lambda *_: None,
                                  deadline=time.monotonic() + 0.1)
        assert not accepted and decoder.stats["admission_shed"] == 1
        assert decoder.idle
        done = {}
        assert decoder.submit("ok", PROMPT, 4,
                              lambda rid, t: done.update({rid: t}),
                              deadline=time.monotonic() + 60.0)
        while not decoder.idle:
            decoder.pump()
        assert len(done["ok"]) == 4


def test_attach_pumps_from_an_engine_until_idle(weights):
    """attach() registers one engine timer (idempotent), on_idle fires
    when the last slot retires, detach() removes the timer; the
    occupancy and waste figures read the decoder's counters."""
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    _, model = weights
    engine = EventEngine(VirtualClock())
    decoder = TS.ContinuousDecoder(model, T_CONFIG, max_slots=2,
                                   prefill_buckets=(64,), paged_kv=True,
                                   device="cpu")
    handle = decoder.attach(engine)
    assert decoder.attach(engine) == handle and decoder.attached
    idle_calls, done = [], {}
    decoder.on_idle = lambda: idle_calls.append(engine.clock.now())
    decoder.submit("a", PROMPT[:20], 6, lambda rid, t: done.update({rid: t}))
    while "a" not in done:
        engine.clock.advance(0.002)
        engine.step()
    assert done["a"] == oracle(weights[0], PROMPT[:20], 6)
    assert idle_calls
    assert 0.0 < decoder.mean_occupancy() <= 1.0
    assert 0.0 <= decoder.wasted_fraction() < 1.0
    decoder.detach(engine)
    assert not decoder.attached
    assert decoder.pump not in engine.live_timer_handlers()


def test_harvest_progress_registers_the_written_prompt_blocks(weights):
    """Mid-prefill, harvest_progress registers the complete blocks the
    chunks wrote so far ([0, prefill_pos)) and returns their count; a
    request that holds no slot harvests nothing."""
    decoders = pair(weights, prefill_chunk=16)
    long = (PROMPT * 2)[:80]                 # past the 64-token bucket
    seen = {}
    for package, (decoder, cache) in decoders.items():
        decoder.submit("long", long, 4, lambda *_: None)
        request = decoder._pending[0]
        assert decoder.harvest_progress(request) == 0
        counts = []
        for _ in range(3):
            decoder.pump()
            counts.append((request.prefill_pos,
                           decoder.harvest_progress(request), len(cache)))
        while not decoder.idle:
            decoder.pump()
        seen[package] = counts
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][-1][1] > 0
    assert_same_stats(decoders)
