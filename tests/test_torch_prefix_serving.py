"""The port's paged ContinuousDecoder with a prefix cache against the JAX
package's, on the same weights: the JAX decoder runs paged_kv=True with
its decode attention latched to the Pallas paged kernel (interpret mode
on the CPU, as tests/test_paged_kv.py latches it), the port's runs the
kernel's plain version.  The hit matrix of tests/test_prefix_cache.py:93-
225 and the paged cases of tests/test_paged_kv.py: full, partial and
missed hits, chunked and mid-stream, int8 pools, the in-flight dedup
window, tenants, a harvest under a byte budget.  Greedy tokens must be
identical (tiny preset, f32), and so must prefix_admits, tokens_prefill,
the cache's hit_tokens and cow_copies; a few runs are also held against
llama_greedy_decode.  Copy-on-extend, shared chains, eviction and the
admission estimate are in tests/test_torch_prefix_cow.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL

from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
# the counters that must agree: the decoder's and the cache's
DECODER_STATS = ("prefix_admits", "tokens_prefill", "cow_copies",
                 "prefills", "prefill_chunks", "dedup_deferred",
                 "dedup_shared", "completed")
CACHE_STATS = ("hit_tokens", "miss_tokens", "hits", "misses", "inserts",
               "evictions", "insert_refused")
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


def run(decoder, requests, midstream=None, rounds=400, tenant=None):
    """Drive requests to completion; `midstream` requests are submitted
    after the second pump round."""
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    for request_id, (prompt, max_new) in requests.items():
        decoder.submit(request_id, prompt, max_new, keep, tenant=tenant)
    total = len(requests) + len(midstream or {})
    for i in range(rounds):
        decoder.pump()
        if i == 1 and midstream:
            for request_id, (prompt, max_new) in midstream.items():
                decoder.submit(request_id, prompt, max_new, keep,
                               tenant=tenant)
            midstream = None
        if len(done) == total:
            break
    assert len(done) == total, f"{len(done)}/{total} completed"
    return done


def pair(weights, block=8, cache_kwargs=None, **kwargs):
    """{"jax": (decoder, cache), "torch": (decoder, cache)}: the JAX
    paged-kernel decoder and the port's, each with its own prefix cache
    of `block`-token blocks."""
    params, model = weights
    kwargs = {"max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4, "paged_kv": True, **kwargs}
    _SEQ[0] += 1
    out = {}
    for package, serving in (("jax", JS), ("torch", TS)):
        cache = serving.PrefixKVCache(**{
            "block_tokens": block, "max_bytes": 64 << 20,
            "name": f"ps{_SEQ[0]}{package}", **(cache_kwargs or {})})
        if package == "jax":
            before = JS.ATTENTION_IMPL
            JS.ATTENTION_IMPL = "paged_kernel"
            try:
                decoder = JS.ContinuousDecoder(params, J_CONFIG,
                                               prefix_cache=cache, **kwargs)
            finally:
                JS.ATTENTION_IMPL = before
            assert decoder.paged_kernel
            # the JAX decoder's shared table-row buffer races its own
            # dispatch when an admit and a chunk extend share a round
            # (ROADMAP.md Queue 3 items 1 and 7)
            fresh_table_scratch(decoder)
        else:
            decoder = TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                           prefix_cache=cache, **kwargs)
        out[package] = (decoder, cache)
    return out


def both(decoders, requests, midstream=None, tenant=None):
    """The same requests through both decoders: (JAX tokens, port
    tokens)."""
    return tuple(run(decoders[package][0], requests, midstream,
                     tenant=tenant) for package in ("jax", "torch"))


def assert_same_stats(decoders):
    (jax_decoder, jax_cache), (port, port_cache) = \
        decoders["jax"], decoders["torch"]
    for key in DECODER_STATS:
        assert port.stats[key] == jax_decoder.stats[key], key
    for key in CACHE_STATS:
        assert port_cache.stats[key] == jax_cache.stats[key], key
    assert port.pool.used_blocks() == jax_decoder.pool.used_blocks()
    assert len(port_cache) == len(jax_cache)
    assert port.pool.used_blocks() == len(port_cache)     # idle: cache only
    assert all(node.refs == 0 for node in port_cache._nodes.values())


def test_full_partial_and_missed_hits(weights):
    """The donor harvests its chain; a full hit (4 blocks, capped at
    len - 1), a partial one (3 blocks) and a miss prefill only what the
    cache does not hold."""
    decoders = pair(weights, prefill_chunk=16)
    donor = {"donor": (PROMPT, 10)}
    probes = {"full": (PROMPT, 10), "part": (PROMPT[:24] + [7, 9, 3], 8),
              "miss": ([9, 4, 2], 6)}
    jax_donor, port_donor = both(decoders, donor)
    assert port_donor == jax_donor
    jax_out, port_out = both(decoders, probes)
    assert port_out == jax_out
    assert port_out["full"] == oracle(weights[0], PROMPT, 10)
    port, cache = decoders["torch"]
    assert port.stats["prefix_admits"] == 2
    assert cache.stats["hit_tokens"] == 32 + 24
    assert_same_stats(decoders)


def test_int8_pools(weights):
    decoders = pair(weights, kv_cache_dtype="int8", prefill_chunk=16)
    donor = {"donor": (PROMPT, 10)}
    probes = {"full": (PROMPT, 10), "part": (PROMPT[:16] + [1, 2], 8)}
    jax_donor, port_donor = both(decoders, donor)
    assert port_donor == jax_donor
    jax_out, port_out = both(decoders, probes)
    assert port_out == jax_out
    assert decoders["torch"][0].stats["prefix_admits"] == 2
    assert_same_stats(decoders)


def test_chunked_midstream_hits_beside_a_decoding_slot(weights):
    """A long-running request decodes while cached admits join and their
    suffixes stream in chunks."""
    decoders = pair(weights, prefill_chunk=16)
    both(decoders, {"donor": (PROMPT, 10)})
    requests = {"bg": ([3, 1, 4, 1, 5, 9], 16)}
    midstream = {"full": (PROMPT, 10), "part": (PROMPT[:24] + [7, 9], 8),
                 "loop": ([7, 8, 9] * 4, 12),
                 "long": ((PROMPT * 2)[:70], 6)}
    jax_out, port_out = both(decoders, requests, midstream)
    assert port_out == jax_out
    assert port_out["full"] == oracle(weights[0], PROMPT, 10)
    assert decoders["torch"][0].stats["prefix_admits"] >= 2
    assert_same_stats(decoders)


def test_suffix_extends_without_a_prefill_chunk(weights):
    """Without prefill_chunk a hit's suffix runs as one pow2-sized
    extend."""
    decoders = pair(weights)
    both(decoders, {"donor": (PROMPT, 10)})
    jax_out, port_out = both(decoders, {"full": (PROMPT, 10),
                                        "part": (PROMPT[:20], 5)})
    assert port_out == jax_out
    assert decoders["torch"][0].stats["prefix_admits"] == 2
    assert_same_stats(decoders)


def test_dedup_window_shares_one_prefill(weights):
    """Identical prompts submitted together: the first prefills, the
    others wait for its prompt blocks (harvested at its first token) and
    admit through the cache."""
    decoders = pair(weights, prefill_chunk=16)
    requests = {f"d{i}": (PROMPT[:30], 6) for i in range(3)}
    jax_out, port_out = both(decoders, requests)
    assert port_out == jax_out
    port = decoders["torch"][0]
    assert port.stats["dedup_deferred"] == 2
    assert port.stats["dedup_shared"] == 2
    assert port.stats["prefix_admits"] == 2
    assert_same_stats(decoders)


def test_tenants_never_share_blocks(weights):
    decoders = pair(weights, prefill_chunk=16)
    both(decoders, {"donor": (PROMPT, 6)}, tenant="a")
    jax_out, port_out = both(decoders, {"other": (PROMPT, 6)}, tenant="b")
    assert port_out == jax_out
    port, cache = decoders["torch"]
    assert port.stats["prefix_admits"] == 0
    assert cache.tenant_bytes("a") == cache.tenant_bytes("b") > 0
    jax_out, port_out = both(decoders, {"same": (PROMPT, 6)}, tenant="a")
    assert port_out == jax_out and port.stats["prefix_admits"] == 1
    assert_same_stats(decoders)


def test_harvest_under_a_byte_budget(weights):
    """A tiny byte budget: eviction and refused inserts while serving,
    tokens still identical and equal to the dense greedy decode."""
    decoders = pair(weights, block=8, prefill_chunk=16,
                    cache_kwargs={"max_bytes": 6 * 4096})
    rng = np.random.default_rng(3)
    for wave in range(3):
        requests = {
            f"w{wave}_{i}": (rng.integers(
                1, J_CONFIG.vocab, size=int(rng.integers(20, 45))
            ).tolist(), 6)
            for i in range(3)}
        jax_out, port_out = both(decoders, requests)
        assert port_out == jax_out
        for cache in (decoders["jax"][1], decoders["torch"][1]):
            assert cache.bytes_used <= 6 * 4096
    rid, (prompt, max_new) = next(iter(requests.items()))
    assert port_out[rid] == oracle(weights[0], prompt, max_new)
    assert decoders["torch"][1].stats["evictions"] > 0
    assert_same_stats(decoders)
