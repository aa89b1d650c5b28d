"""The port's host KV tier (serving_tiered.py: HostBlockStore,
AsyncPromoter) and the prefix cache's tiered surface against the JAX
package's.

Store scripts (per-tenant and global budgets, LRU eviction, oversize
refusal, promotion pops) run call for call on both packages with the
same block rows, the port's in host tensors.  Then paged decoders (tiny
preset, f32) with a host store attached: the async prefetch lands
before the admit, promote_for stages inline, a resident chain is a
no-op kick, the staging bounds defer and count the same blocks as JAX,
all-pinned device pressure demotes the oldest session instead of
refusing, and both tiers drain to zero after a zero-budget demotion;
tokens, cache, store and promoter counters equal JAX's."""

import dataclasses
import functools
import time

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.serving_tiered import HostBlockStore as JStore
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe.ledger import assert_ledger_clean
from aiko_services_tpu_torch.serving_tiered import HostBlockStore as TStore

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
PROMPT41 = PROMPT + [5]
REQUESTS = {"a": (PROMPT, 10), "b": (PROMPT[:17] + [3, 4], 8)}
# host-tier counters that are byte sums or event counts, equal by design
STORE_KEYS = ("demoted", "promoted", "evicted", "refused", "demote_bytes",
              "promote_bytes")


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


# -- store scripts -----------------------------------------------------------

def rows(seed: int, package: str, int8: bool = False):
    rng = np.random.default_rng(seed)
    if int8:
        leaf = {"q": rng.integers(-127, 128, (2, 4, 3)).astype(np.int8),
                "s": rng.random((2, 4)).astype(np.float32)}
    else:
        leaf = rng.standard_normal((2, 4, 3)).astype(np.float32)
    layers = [leaf, leaf]
    if package == "torch":
        layers = [{k: torch.from_numpy(v) for k, v in layer.items()}
                  if int8 else torch.from_numpy(layer) for layer in layers]
    return layers


def store_script(package: str, int8: bool):
    block = 128
    store = (JStore if package == "jax" else TStore)(
        max_bytes=6 * block, tenant_max_bytes=3 * block,
        name=f"script{package}{int8}")
    trace = []
    for i in range(5):
        trace.append(store.put_from_device(
            "t1", f"k{i - 1}" if i else "", f"k{i}", rows(i, package, int8),
            rows(i + 9, package, int8), block))
    for i in range(4):
        trace.append(store.put_from_device(
            "t2", "", f"x{i}", rows(20 + i, package, int8),
            rows(30 + i, package, int8), block))
    trace.append(store.put_from_device("t1", "", "big", rows(0, package),
                                       rows(0, package), 7 * block))
    trace.append(store.put_from_device("t2", "", "x3", rows(0, package),
                                       rows(0, package), block))   # touch
    trace.append([n.key for n in store.chain_nodes(["k2", "k3", "k9",
                                                    "k4"])])
    trace.append(store.pop_promoted(["k2", "nope", "x3"]))
    trace.append((sorted(store._nodes), store.bytes_used,
                  store.tenant_bytes("t1"), store.tenant_bytes("t2"),
                  {k: store.stats[k] for k in STORE_KEYS}))
    return trace, store


@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
def test_store_scripts_match_jax(int8):
    expected, jax_store = store_script("jax", int8)
    got, store = store_script("torch", int8)
    assert got == expected
    # the host rows are the rows put, as copies (JAX: np.asarray)
    node = store.get("k4")
    want = jax_store.get("k4")
    for got_leaf, want_leaf in zip(node.k_rows, want.k_rows):
        if int8:
            for plane in ("q", "s"):
                assert np.array_equal(got_leaf[plane].numpy(),
                                      want_leaf[plane])
        else:
            assert np.array_equal(got_leaf.numpy(), want_leaf)
    assert node.ready is None                 # no copy to wait for here


# -- the tiered paged decoder ---------------------------------------------------

_SEQ = [0]


def tiered(package: str, host_mb=64, cache_bytes=64 << 20, **kwargs):
    _SEQ[0] += 1
    name = f"ttk{package}{_SEQ[0]}"
    params, model = weights()
    module, store_type = (JS, JStore) if package == "jax" else (TS, TStore)
    cache = module.PrefixKVCache(block_tokens=8, max_bytes=cache_bytes,
                                 name=name)
    store = store_type(max_bytes=host_mb << 20, name=f"{name}h")
    cache.attach_host_store(store)
    extra = {} if package == "jax" else {"device": "cpu"}
    decoder = module.ContinuousDecoder(
        params if package == "jax" else model,
        J_CONFIG if package == "jax" else T_CONFIG, paged_kv=True,
        kv_block=8, prefix_cache=cache, max_slots=4,
        prefill_buckets=(64,), steps_per_sync=4, name=name, **kwargs,
        **extra)
    return decoder, cache, store


def run(decoder, requests, rounds=400):
    done = {}
    for rid, (prompt, max_new) in requests.items():
        decoder.submit(rid, prompt, max_new,
                       lambda rid, t: done.update({rid: [int(x)
                                                         for x in t]}))
    for _ in range(rounds):
        decoder.pump()
        if len(done) == len(requests):
            break
    assert len(done) == len(requests), f"{len(done)}/{len(requests)}"
    return done


def demote_all(cache, out, requests):
    pairs = []
    for rid, (prompt, _) in requests.items():
        _, hit = cache.session_store("default", rid, prompt + out[rid])
        assert hit > 0
        pairs.append(("default", rid))
    return cache.demote_sessions(pairs)


def counters(cache, store) -> dict:
    return {"cache": {k: cache.stats[k] for k in (
                "demoted", "promoted", "evictions", "hit_tokens",
                "session_released")},
            "store": {k: store.stats[k] for k in STORE_KEYS},
            "promoter": dict(cache.promoter.stats)}


def wait_ready(cache, seconds: float = 10.0) -> None:
    deadline = time.monotonic() + seconds
    while not cache.promotions_ready and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cache.promotions_ready, "staging never finished"


def prefetch_cycle(package: str):
    decoder, cache, store = tiered(package)
    out1 = run(decoder, {"a": (PROMPT, 10)})
    full = PROMPT + out1["a"]
    demoted = demote_all(cache, out1, {"a": (PROMPT, 10)})
    kicked = cache.prefetch("default", full)
    assert cache.prefetch("default", full) == 0      # in flight: dedup
    wait_ready(cache)
    landed = cache.poll_promotions()
    _, hit = cache.match("default", full)
    out2 = run(decoder, {"a2": (PROMPT, 10)})
    return (out1, out2, demoted, kicked, landed, hit,
            counters(cache, store))


def test_prefetch_lands_before_the_admit():
    expected = prefetch_cycle("jax")
    got = prefetch_cycle("torch")
    assert got == expected
    out1, out2, _, kicked, landed, hit, stats = got
    assert out2["a2"] == out1["a"]
    assert kicked == landed == hit > 0
    assert stats["promoter"]["installs_async"] > 0


def inline_cycle(package: str):
    decoder, cache, store = tiered(package)
    out1 = run(decoder, {"a": (PROMPT41, 8)})
    full = PROMPT41 + out1["a"]
    demoted = demote_all(cache, out1, {"a": (PROMPT41, 8)})
    resident = (len(cache), decoder.pool.used_blocks(), len(store),
                store.bytes_used == 6 * decoder.pool.block_nbytes)
    promoted = cache.promote_for("default", full)
    after = (len(store), store.bytes_used, cache.match("default", full)[1])
    noop = cache.prefetch("default", full)           # resident: no kick
    out2 = run(decoder, {"a2": (PROMPT41, 8)})
    # a zero host budget: every put refuses, both tiers empty
    cache.session_store("default", "a", full)
    store.max_bytes = 0
    cache.demote_sessions([("default", "a")])
    purged = cache.purge()
    return (out1, out2, demoted, resident, promoted, after, noop, purged,
            counters(cache, store)), (decoder, cache, store)


def test_promote_for_inline_and_both_tiers_drain():
    expected, _ = inline_cycle("jax")
    got, (decoder, cache, store) = inline_cycle("torch")
    assert got == expected
    out1, out2, demoted, resident, promoted, after, noop, *_ = got
    assert out2["a2"] == out1["a"]
    assert resident == (0, 0, 6, True) and promoted == 48
    assert after == (0, 0, 48) and noop == 0
    assert store.stats["refused"] >= 6
    assert_ledger_clean(cache=cache)


def pressure_cycle(package: str):
    decoder, cache, store = tiered(package)
    out1 = run(decoder, {"a": (PROMPT, 10)})
    _, hit = cache.session_store("default", "sa", PROMPT + out1["a"])
    cache.max_bytes = 4 * decoder.pool.block_nbytes
    other = [(i * 7) % 50 + 1 for i in range(24)]
    out_c = run(decoder, {"c": (other, 6)})
    tokens = cache.session_tokens("default", "sa")
    cache.max_bytes = 64 << 20
    out2 = run(decoder, {"a2": (PROMPT, 10)})
    return (out1, out_c, hit, tokens, out2, counters(cache, store))


def test_all_pinned_pressure_demotes_the_oldest_session():
    expected = pressure_cycle("jax")
    got = pressure_cycle("torch")
    assert got == expected
    out1, _, hit, tokens, out2, stats = got
    assert hit == 48 and tokens == 0 and out2["a2"] == out1["a"]
    assert stats["cache"]["demoted"] > 0


def bounds_cycle(package: str, batch_cap: int, inflight_cap: int):
    decoder, cache, store = tiered(package)
    out = run(decoder, REQUESTS)
    demote_all(cache, out, REQUESTS)
    promoter = cache.promoter
    promoter.max_batch_blocks = batch_cap
    promoter.max_inflight = inflight_cap
    history = PROMPT + out["a"]
    before = promoter._deferred.value
    staged = cache.prefetch("default", history)
    again = cache.prefetch("default", history)
    deferred = promoter._deferred.value - before
    if staged:
        wait_ready(cache)
    hits = []
    for _ in range(5):
        cache.promote_for("default", history)
        hits.append(cache.match("default", history)[1])
        if hits[-1] == 48:
            break
    promoter.max_inflight = 4
    out2 = run(decoder, {"a_rev": (PROMPT, 10)})
    return (staged, again, deferred, hits, out2["a_rev"] == out["a"],
            counters(cache, store))


@pytest.mark.parametrize("batch_cap,inflight_cap", [(2, 4), (16, 0)],
                         ids=["batch_cap", "inflight_cap"])
def test_staging_bounds_defer_and_count_like_jax(batch_cap, inflight_cap):
    expected = bounds_cycle("jax", batch_cap, inflight_cap)
    got = bounds_cycle("torch", batch_cap, inflight_cap)
    assert got == expected
    staged, again, deferred, hits, same, _ = got
    assert same and hits[-1] == 48 and again == 0
    # the in-flight cap defers both kicks whole
    assert (staged, deferred) == ((16, 4) if batch_cap == 2 else (0, 12))


def test_host_tier_needs_a_paged_cache():
    cache = TS.PrefixKVCache(block_tokens=8, name="dense_tier")
    cache.bind((2, 2, 16, "torch.float32", False, 8, 4), paged=False)
    with pytest.raises(ValueError, match="dense"):
        cache.attach_host_store(TStore(name="dense_tier_h"))
    decoder, cache, store = tiered("torch")
    with pytest.raises(ValueError, match="already has host store"):
        cache.attach_host_store(TStore(name="other"))
    assert cache.tiered and cache.host_store is store
    assert cache.promoter.store is store
    cache.promoter.stop()
