"""The prefix cache's dense nodes on the port against the JAX package's.

Dense nodes carry their own K/V rows (PrefixKVCache.insert), which a
dense decoder's hit copies into the slot and its harvest slices out of
it.  First the cache bookkeeping, call for call on both packages' dense
caches: the scenarios of tests/test_torch_prefix_cache.py (leaf-first
LRU eviction under a byte budget, tenant budgets, an insert refused when
everything is pinned, sessions and purge) with rows in place of pool
blocks; the records (nodes in LRU order, refs, bytes, sessions,
counters) must be equal, and block_rows must read back the rows
inserted.  Then the dense decoder with a cache against JAX's: full,
partial and missed hits, int8 rows, a hit at the sequence cap, suffix
extends without a prefill_chunk, harvests that evict, speculation with
chunked prefill and mid-stream admits over hits (tests/test_prefix_cache.py
:145-146) and the context a speculative hit seeds
(tests/test_paged_kv.py:377, dense and paged); tokens and counters equal
JAX's, and the warm decoder's tokens equal a cold one's.  Last, the
continuous PE_LlamaAgent at paged false with a prefix cache and sessions,
whose responses must equal JAX's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.observe.metrics import MetricsRegistry as JRegistry
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe.metrics import \
    MetricsRegistry as TRegistry

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
BLOCK = 4
# bytes of one dense block: K and V rows of every layer, f32
BLOCK_BYTES = 2 * J_CONFIG.num_layers * J_CONFIG.num_kv_heads * BLOCK * \
    J_CONFIG.head_dim * 4
TIMINGS = ("prefill_s", "decode_s")


# -- the cache, call for call ---------------------------------------------------

def _cache(package, block_cap=None, tenant_cap=None, name="c"):
    serving, registry = (TS, TRegistry()) if package == "torch" \
        else (JS, JRegistry())
    cache = serving.PrefixKVCache(
        block_tokens=BLOCK,
        max_bytes=None if block_cap is None else block_cap * BLOCK_BYTES,
        tenant_max_bytes=None if tenant_cap is None
        else tenant_cap * BLOCK_BYTES, name=name, registry=registry)
    return cache, registry


def _rows(package, key: str) -> tuple:
    """Seeded per-layer K and V rows of one block, from the key's
    bytes, as the package's tensors."""
    rng = np.random.default_rng(int(key[:8], 16))
    shape = (J_CONFIG.num_kv_heads, BLOCK, J_CONFIG.head_dim)
    make = torch.from_numpy if package == "torch" else jnp.asarray
    return tuple([make(rng.standard_normal(shape).astype(np.float32))
                  for _ in range(J_CONFIG.num_layers)] for _ in range(2))


def _insert_chain(cache, package, tenant, tokens) -> tuple:
    keys = cache.keys_for(tenant, tokens)
    parent, results = "", []
    for key in keys:
        results.append(cache.insert(tenant, parent, key,
                                    *_rows(package, key)))
        if not results[-1]:
            break
        parent = key
    return keys, results


def _state(cache) -> dict:
    return {"nodes": [(key, node.refs, node.parent, sorted(node.children),
                       node.tenant, node.nbytes, node.pool_id)
                      for key, node in cache._nodes.items()],
            "bytes": cache.bytes_used,
            "tenants": dict(cache._tenant_bytes),
            "sessions": cache.sessions(),
            "stats": dict(cache.stats)}


def _eviction_script(package):
    cache, _ = _cache(package, block_cap=6, name="evict")
    log = []
    chain_a, results = _insert_chain(cache, package, "t", list(range(12)))
    log.append((results, _state(cache)))
    log.append((cache.session_store("t", "s1", list(range(12))),
                _state(cache)))
    log.append((_insert_chain(cache, package, "t",
                              [90 + i for i in range(12)])[1],
                _state(cache)))
    # pressure: a third chain evicts B's leaves, never A's pinned blocks
    log.append((_insert_chain(cache, package, "t",
                              [60 + i for i in range(12)])[1],
                _state(cache)))
    assert all(key in cache._nodes for key in chain_a)
    log.append((cache.session_release("t", "s1"), _state(cache)))
    log.append((_insert_chain(cache, package, "t",
                              [30 + i for i in range(12)])[1],
                _state(cache)))
    assert cache.bytes_used <= 6 * BLOCK_BYTES
    return log


def _tenant_script(package):
    cache, _ = _cache(package, tenant_cap=2, name="tenants")
    log = [(_insert_chain(cache, package, "a", list(range(8)))[1],
            _insert_chain(cache, package, "b", list(range(8)))[1],
            _state(cache))]
    log.append((cache.match("a", list(range(8))), _state(cache)))
    log.append((_insert_chain(cache, package, "a",
                              [50 + i for i in range(8)])[1],
                cache.tenant_bytes("a"), cache.tenant_bytes("b"),
                cache.match("b", list(range(8))), _state(cache)))
    return log


def _pinned_script(package):
    cache, _ = _cache(package, block_cap=2, name="pinned")
    log = [(_insert_chain(cache, package, "t", list(range(8)))[1],
            cache.session_store("t", "s", list(range(8))), _state(cache))]
    key = cache.keys_for("t", [70, 71, 72, 73])[0]
    log.append((cache.insert("t", "", key, *_rows(package, key)),
                _state(cache)))
    log.append((cache.match("t", list(range(8))), _state(cache)))
    return log


def _session_script(package):
    cache, _ = _cache(package, block_cap=64, name="sessions")
    log = []
    _insert_chain(cache, package, "t", list(range(16)))
    _insert_chain(cache, package, "u", list(range(16)))
    tokens = list(range(13))
    log.append((cache.acquire("t", tokens, limit=12), _state(cache)))
    cache.release(cache.keys_for("t", tokens[:12]))
    log.append((cache.session_store("t", "s1", list(range(16))),
                cache.session_store("u", "s2", list(range(9))),
                cache.session_tokens("t", "s1"), _state(cache)))
    log.append((cache.demote_sessions([("t", "s1"), ("t", "gone")]),
                _state(cache)))
    cache.session_store("t", "s4", list(range(16)))
    log.append((cache.purge(), _state(cache)))
    assert len(cache) == 0
    return log


@pytest.mark.parametrize("script", [_eviction_script, _tenant_script,
                                    _pinned_script, _session_script])
def test_dense_cache_scripts_agree_call_for_call(script):
    assert script("torch") == script("jax")


def test_block_rows_read_back_the_inserted_rows():
    cache, _ = _cache("torch", name="rows")
    keys, results = _insert_chain(cache, "torch", "t", list(range(8)))
    assert results == [True, True] and not cache.paged
    for key in keys:
        k_rows, v_rows = cache.block_rows(cache._nodes[key])
        want_k, want_v = _rows("torch", key)
        for got, want in zip(k_rows + v_rows, want_k + want_v):
            assert torch.equal(got, want)
    assert cache.bytes_used == 2 * BLOCK_BYTES


def test_dense_and_paged_storage_do_not_mix():
    cache, _ = _cache("torch", name="mix")
    cache.bind((2, 2, 16, "torch.float32", False, BLOCK, 4), paged=False)
    _, model = weights()
    with pytest.raises(ValueError, match="bound by a dense decoder"):
        cache.attach_pool(object())
    paged_cache = TS.PrefixKVCache(block_tokens=8, name="paged")
    TS.ContinuousDecoder(model, T_CONFIG, device="cpu", paged_kv=True,
                         prefix_cache=paged_cache)
    with pytest.raises(ValueError, match="dense decoder cannot bind it"):
        TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                             prefix_cache=paged_cache)


# -- the dense decoder over the cache -------------------------------------------

@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def run(decoder, requests, rounds=400) -> dict:
    done = {}
    for rid, (prompt, max_new) in requests.items():
        decoder.submit(rid, prompt, max_new,
                       lambda rid, t: done.update({rid: [int(x)
                                                         for x in t]}))
    for _ in range(rounds):
        decoder.pump()
        if len(done) == len(requests):
            break
    assert len(done) == len(requests), \
        f"{len(done)}/{len(requests)} completed"
    return done


_SEQ = [0]


def trio(block=8, max_bytes=64 << 20, paged=False, **kwargs):
    """(the JAX dense decoder with a cache, the port's decoder with a
    cache, the port's cold decoder, the two caches)."""
    params, model = weights()
    kwargs.setdefault("max_slots", 4)
    kwargs.setdefault("prefill_buckets", (64,))
    kwargs.setdefault("steps_per_sync", 4)
    _SEQ[0] += 1
    jax_cache = JS.PrefixKVCache(block_tokens=block, max_bytes=max_bytes,
                                 name=f"dj{_SEQ[0]}")
    port_cache = TS.PrefixKVCache(block_tokens=block, max_bytes=max_bytes,
                                  name=f"dt{_SEQ[0]}")
    return (JS.ContinuousDecoder(params, J_CONFIG, prefix_cache=jax_cache,
                                 **kwargs),
            TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                 prefix_cache=port_cache, paged_kv=paged,
                                 **kwargs),
            TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                 paged_kv=paged, **kwargs),
            jax_cache, port_cache)


def check_serving(jax_decoder, port, cold, jax_cache, port_cache, *waves):
    """Serve each wave of requests on all three decoders: the port's
    tokens equal JAX's and the cold run's; the decoders' and the caches'
    counters equal JAX's (the copy counters only for a dense port)."""
    for requests in waves:
        expected = run(jax_decoder, requests)
        assert run(port, requests) == expected
        assert run(cold, requests) == expected
    for key, value in port.stats.items():
        if key in TIMINGS or (port.paged and key in (
                "prefix_copy_bytes", "harvest_copy_bytes")):
            continue
        assert value == jax_decoder.stats[key], key
    assert dict(port_cache.stats) == dict(jax_cache.stats)
    assert port_cache.bytes_used == jax_cache.bytes_used or port.paged
    assert all(node.refs == 0 for node in port_cache._nodes.values())


def test_full_partial_and_missed_hits_match_jax():
    jax_decoder, port, cold, jax_cache, port_cache = trio(prefill_chunk=16)
    probes = {"full": (PROMPT, 10), "part": (PROMPT[:24] + [7, 9, 3], 8),
              "miss": ([9, 4, 2], 6)}
    check_serving(jax_decoder, port, cold, jax_cache, port_cache,
                  {"donor": (PROMPT, 10)}, probes)
    assert port.stats["prefix_admits"] == 2
    assert port.stats["prefix_copy_bytes"] > 0
    assert port.stats["harvest_copy_bytes"] > 0
    assert port_cache.stats["hit_tokens"] == 56
    node = next(iter(port_cache._nodes.values()))
    assert node.pool_id is None and node.k_rows[0].shape == (
        J_CONFIG.num_kv_heads, 8, J_CONFIG.head_dim)


def test_int8_rows_match_jax():
    """A hit on an int8 decoder copies the {"q", "s"} rows (no second
    rounding) and stays token-identical to the cold int8 decoder."""
    jax_decoder, port, cold, jax_cache, port_cache = trio(
        kv_cache_dtype="int8", prefill_chunk=16)
    check_serving(jax_decoder, port, cold, jax_cache, port_cache,
                  {"donor": (PROMPT, 10)},
                  {"full": (PROMPT, 10), "part": (PROMPT[:16] + [1, 2], 8)})
    node = next(iter(port_cache._nodes.values()))
    assert node.k_rows[0]["q"].dtype == torch.int8


def test_a_hit_at_the_sequence_cap_matches_jax():
    prompt = [(i * 3) % 70 + 1 for i in range(95)]
    jax_decoder, port, cold, jax_cache, port_cache = trio(
        prefill_buckets=(16,), max_slots=2, prefill_chunk=16)
    check_serving(jax_decoder, port, cold, jax_cache, port_cache,
                  {"donor": (prompt, 8)}, {"hit": (prompt, 8)})
    assert port.stats["prefix_admits"] == 1


def test_suffix_extends_without_a_prefill_chunk_match_jax():
    jax_decoder, port, cold, jax_cache, port_cache = trio()
    check_serving(jax_decoder, port, cold, jax_cache, port_cache,
                  {"donor": (PROMPT, 10)}, {"full": (PROMPT, 10)})
    assert port.stats["prefix_admits"] == 1


def test_harvests_that_evict_match_jax():
    """A budget of six 8-token blocks: later harvests evict earlier
    chains leaf-first and refuse what cannot fit."""
    budget = 6 * 2 * J_CONFIG.num_layers * J_CONFIG.num_kv_heads * 8 * \
        J_CONFIG.head_dim * 4
    jax_decoder, port, cold, jax_cache, port_cache = trio(
        max_bytes=budget, prefill_chunk=16)
    waves = [{"a": (PROMPT, 6)}, {"b": ([(i * 7) % 40 + 2
                                         for i in range(33)], 6)},
             {"c": (PROMPT, 6), "d": (PROMPT[:20] + [5, 5], 4)}]
    check_serving(jax_decoder, port, cold, jax_cache, port_cache, *waves)
    assert port_cache.stats["evictions"] > 0
    assert port_cache.bytes_used <= budget


def _leaves(node) -> list:
    return [plane for rows in (node.k_rows, node.v_rows) for leaf in rows
            for plane in (leaf.values() if isinstance(leaf, dict)
                          else (leaf,))]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["native", "int8"])
def test_harvested_nodes_own_their_storage(kv_dtype):
    """Each dense node a harvest makes holds storage of its own, of its
    nbytes, so max_bytes and the tenant budgets count what the device
    holds, and evicting a node releases its storage even while its
    siblings from the same harvest stay cached."""
    import gc
    _, model = weights()
    cache = TS.PrefixKVCache(block_tokens=8, name="own")
    decoder = TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                   max_slots=2, prefill_buckets=(64,),
                                   kv_cache_dtype=kv_dtype,
                                   prefix_cache=cache)
    run(decoder, {"donor": (PROMPT, 10)})
    count = len(cache)              # prompt and generated blocks
    assert count >= len(PROMPT) // 8
    leaves = [_leaves(node) for node in cache._nodes.values()]
    assert [sum(leaf.untyped_storage().nbytes() for leaf in planes)
            for planes in leaves] == \
        [node.nbytes for node in cache._nodes.values()]
    assert len({leaf.untyped_storage().data_ptr() for planes in leaves
                for leaf in planes}) == sum(map(len, leaves))
    del leaves
    before = cache.bytes_used
    tensors, nbytes = _evict_a_leaf(cache)
    gc.collect()
    assert all(ref() is None for ref in tensors)
    assert len(cache) == count - 1
    assert cache.bytes_used == before - nbytes


def _evict_a_leaf(cache) -> tuple:
    """Evict the chain's leaf; weak references to its tensors, and its
    nbytes (no strong reference outlives the call)."""
    import weakref
    node = next(node for node in cache._nodes.values() if not node.children)
    tensors = [weakref.ref(leaf) for leaf in _leaves(node)]
    cache._evict(node)
    return tensors, node.nbytes


@pytest.mark.parametrize("extra", [{"speculate_k": 2},
                                   {"speculate_k": 2,
                                    "kv_cache_dtype": "int8"}],
                         ids=["native", "int8"])
def test_speculation_over_hits_with_midstream_admits(extra):
    """tests/test_prefix_cache.py:145-146: speculative decoding x chunked
    prefill x mid-stream admits over prefix hits, warm against cold and
    against JAX."""
    params, model = weights()
    kwargs = dict(max_slots=4, prefill_buckets=(64,), steps_per_sync=4,
                  prefill_chunk=16, **extra)

    def staged(decoder):
        done = {}

        def keep(rid, tokens):
            done[rid] = [int(t) for t in tokens]

        decoder.submit("donor", PROMPT, 10, keep)
        while "donor" not in done:
            decoder.pump()
        # a long-running request decodes while cached admits join
        decoder.submit("bg", [3, 1, 4, 1, 5, 9], 16, keep)
        for _ in range(2):
            decoder.pump()
        for rid, (prompt, max_new) in {
                "full": (PROMPT, 10), "part": (PROMPT[:24] + [7, 9], 8),
                "loop": ([7, 8, 9] * 4, 12)}.items():
            decoder.submit(rid, prompt, max_new, keep)
        for _ in range(400):
            decoder.pump()
            if len(done) == 5:
                break
        assert len(done) == 5
        return done

    jax_cache = JS.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                 name=f"sj{len(extra)}")
    port_cache = TS.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                  name=f"st{len(extra)}")
    jax_decoder = JS.ContinuousDecoder(params, J_CONFIG,
                                       prefix_cache=jax_cache, **kwargs)
    warm = TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                prefix_cache=port_cache, **kwargs)
    cold = TS.ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    expected = staged(jax_decoder)
    assert staged(warm) == expected == staged(cold)
    assert warm.stats["prefix_admits"] >= 2
    for key in ("prefix_admits", "spec_proposed", "spec_accepted",
                "prefix_copy_bytes", "harvest_copy_bytes", "steps"):
        assert warm.stats[key] == jax_decoder.stats[key], key
    assert all(n.refs == 0 for n in port_cache._nodes.values())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_speculative_hit_seeds_the_context(paged):
    """tests/test_paged_kv.py:377: a hit writes the cached prompt tokens
    into the drafter's context row (the one device write a paged hit
    makes), so the drafts, the accepts and the tokens equal the JAX
    dense decoder's."""
    jax_decoder, port, cold, jax_cache, port_cache = trio(
        paged=paged, speculate_k=2, prefill_chunk=16)
    check_serving(jax_decoder, port, cold, jax_cache, port_cache,
                  {"donor": (PROMPT, 10)}, {"full": (PROMPT, 10)})
    assert port.stats["prefix_admits"] == 1
    slot_context = port._context[0, :32].tolist()
    assert slot_context == PROMPT[:32]
    if paged:
        assert port.stats["prefix_copy_bytes"] == 0
        assert port.pool.used_blocks() == len(port_cache)


def test_the_continuous_agent_with_dense_prefix_nodes_answers_like_jax(
        monkeypatch):
    """PE_LlamaAgent in continuous mode at paged false, the JAX
    element's default, with a prefix cache of 8-token blocks and
    sessions: every turn re-submits the history and turns 2-3 copy
    their cached rows in."""
    import test_torch_agent as agent_tests
    jax_params = JL.llama_init(jax.random.PRNGKey(0),
                               JL.LLAMA_PRESETS["tiny"])

    def bridged(generator, config, device=None):
        return bridge.params_from_numpy(
            jax.tree.map(np.asarray, jax_params), config, device="cpu")
    monkeypatch.setattr(TL, "llama_init", bridged)
    parameters = {**agent_tests.CONTINUOUS, "paged": False,
                  "sessions": True, "session_lease": 5.0}
    port, agent, *_ = agent_tests._converse("torch", parameters,
                                            agent_tests.TEXTS)
    expected, jax_agent, *_ = agent_tests._converse("jax", parameters,
                                                    agent_tests.TEXTS)
    assert port == expected
    decoder = agent.decoder
    assert not decoder.paged and not agent.prefix_cache.paged
    assert decoder.stats["prefix_admits"] >= 4
    assert decoder.stats["prefix_copy_bytes"] > 0
    for key in ("prefix_admits", "tokens_prefill", "prefix_copy_bytes",
                "harvest_copy_bytes", "completed"):
        assert decoder.stats[key] == jax_agent.decoder.stats[key], key
    assert agent.prefix_cache.stats["hit_tokens"] == \
        jax_agent.prefix_cache.stats["hit_tokens"]
