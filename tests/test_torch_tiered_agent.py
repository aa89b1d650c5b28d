"""The tiered paged decoder and PE_LlamaAgent(host_kv_mb) on the port
against the JAX package's.

Demote -> promote parity matrix (tests/test_tiered_kv.py's): serve,
pin every finished sequence under a session handle, demote the whole
forest to the host tier, serve the same prompts again; the revived
tokens must equal the first run's and JAX's, and the tier counters
(demoted, promoted, installs, the store's bytes) must equal JAX's, for
native pools with a mid-stream admit, int8 pools, chunked prefill,
speculation, and the JAX decoder latched to its Pallas kernel
(interpret mode; the port runs the kernel's plain version everywhere).
Then the agent element with sessions and a host tier, where a two-block
prefix cache budget forces every conversation's chain to the host
between turns: responses frame by frame, demotions and promotions equal
JAX's."""

import dataclasses
import functools

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
from aiko_services_tpu_torch.ops import paged_attention as TPA
from aiko_services_tpu_torch.serving_tiered import HostBlockStore as TStore

from test_torch_agent import (CONTINUOUS, TEXTS, _converse,  # noqa: F401
                              jax_params, same_weights)
from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
REQUESTS = {"a": (PROMPT, 10), "b": (PROMPT[:17] + [3, 4], 8)}
MIDSTREAM = {"mid": (PROMPT[:9] + [7], 6)}
LONG = {"long": ((PROMPT * 3)[:80], 8)} | REQUESTS


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


_SEQ = [0]


def tiered(package: str, kernel: bool = False, **kwargs):
    _SEQ[0] += 1
    name = f"tta{package}{_SEQ[0]}"
    params, model = weights()
    module, store_type = (JS, JStore) if package == "jax" else (TS, TStore)
    cache = module.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                 name=name)
    store = store_type(max_bytes=64 << 20, name=f"{name}h")
    cache.attach_host_store(store)
    kwargs = {"paged_kv": True, "kv_block": 8, "prefix_cache": cache,
              "max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4, "name": name, **kwargs}
    if package == "torch":
        return TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                    **kwargs), cache, store
    before = JS.ATTENTION_IMPL
    if kernel:
        JS.ATTENTION_IMPL = "paged_kernel"
    try:
        decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    fresh_table_scratch(decoder)
    return decoder, cache, store


def run(decoder, requests, midstream=None, rounds=400):
    done = {}

    def keep(rid, tokens):
        done[rid] = [int(t) for t in tokens]

    for rid, (prompt, max_new) in requests.items():
        decoder.submit(rid, prompt, max_new, keep)
    total = len(requests) + len(midstream or {})
    for i in range(rounds):
        decoder.pump()
        if i == 1 and midstream:
            for rid, (prompt, max_new) in midstream.items():
                decoder.submit(rid, prompt, max_new, keep)
            midstream = None
        if len(done) == total:
            break
    assert len(done) == total, f"{len(done)}/{total}"
    return done


def rekey(requests, tag):
    return {rid + tag: spec for rid, spec in requests.items()} \
        if requests else None


def cycle(package: str, requests, midstream=None, **kwargs):
    decoder, cache, store = tiered(package, **kwargs)
    out1 = run(decoder, requests, midstream)
    specs = dict(requests) | dict(midstream or {})
    pairs = []
    for rid, (prompt, _) in specs.items():
        _, hit = cache.session_store("default", rid, prompt + out1[rid])
        assert hit > 0
        pairs.append(("default", rid))
    demoted = cache.demote_sessions(pairs)
    after = (len(cache), decoder.pool.used_blocks(), len(store),
             store.bytes_used)
    out2 = run(decoder, rekey(requests, "2"), rekey(midstream, "2"))
    stats = ({k: cache.stats[k] for k in ("demoted", "promoted",
                                          "hit_tokens")},
             {k: store.stats[k] for k in ("demoted", "promoted",
                                          "demote_bytes", "promote_bytes")},
             {k: cache.promoter.stats[k] for k in ("installs", "staged")},
             {k: decoder.stats[k] for k in ("prefix_admits", "completed",
                                            "tokens_prefill")})
    return (out1, out2, demoted, after, stats), (decoder, cache, store)


@pytest.mark.parametrize("case", [
    {"midstream": MIDSTREAM},
    {"kv_cache_dtype": "int8"},
    {"requests": LONG, "prefill_chunk": 16},
    {"speculate_k": 2},
    {"kernel": True},
], ids=["native_midstream", "int8", "chunked", "speculative",
        "paged_kernel"])
def test_demote_promote_cycles_match_jax(case):
    case = dict(case)
    requests = case.pop("requests", REQUESTS)
    midstream = case.pop("midstream", None)
    kernel = case.pop("kernel", False)
    expected, _ = cycle("jax", requests, midstream, kernel=kernel, **case)
    launches = dict(TPA.launches)
    got, (decoder, cache, store) = cycle("torch", requests, midstream,
                                         **case)
    assert TPA.launches == launches           # no kernel on the CPU
    assert got == expected
    out1, out2, demoted, after, stats = got
    for rid in dict(requests) | dict(midstream or {}):
        assert out2[rid + "2"] == out1[rid], rid
    assert demoted > 0 and after[:2] == (0, 0) and after[2] > 0
    assert stats[0]["promoted"] > 0 and stats[2]["installs"] > 0
    cache.purge(demote=False)
    assert_ledger_clean(pool=decoder.pool)


# -- the agent element with a host tier ---------------------------------------

@pytest.mark.parametrize("extra,settle", [
    ({"prefix_cache_mb": 2 * 2048 / (1 << 20)}, 0.0),
    ({"session_idle": 0.2}, 0.5),
], ids=["lru_pressure", "idle_wheel"])
def test_agent_with_a_host_tier_answers_like_jax(same_weights, extra,
                                                 settle):
    """lru_pressure: a two-block cache budget demotes each finished
    turn's chain as the next stream's harvest lands; idle_wheel: the
    session table's idle sweep demotes the pinned chains once the last
    turns have been idle 0.2 s of the virtual clock."""
    parameters = {**CONTINUOUS, "sessions": True, "session_lease": 30.0,
                  "host_kv_mb": 1, **extra}
    port, agent, *_ = _converse("torch", parameters, TEXTS, settle=settle)
    expected, jax_agent, *_ = _converse("jax", parameters, TEXTS,
                                        settle=settle)
    assert port == expected
    cache, jax_cache = agent.prefix_cache, jax_agent.prefix_cache
    assert cache.tiered and cache.host_store.max_bytes == 1 << 20
    for key in ("demoted", "promoted", "hit_tokens", "session_handles"):
        assert cache.stats[key] == jax_cache.stats[key], key
    assert cache.stats["demoted"] > 0
    for key in ("prefix_admits", "tokens_prefill", "completed"):
        assert agent.decoder.stats[key] == jax_agent.decoder.stats[key], key
    assert cache.host_store.bytes_used == jax_cache.host_store.bytes_used
