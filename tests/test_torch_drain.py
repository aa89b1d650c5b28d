"""The port decoder's graceful drain against the JAX package's
(tests/test_drain_migrate.py's TestDrain and TestDrainCheckpointParity).

Drain refuses new admits, evacuates queued requests as resubmittable
descriptors, lets live slots finish (no deadline) or checkpoints them at
the first round boundary past the deadline, harvesting each live chain
into the prefix cache; on_complete fires once, `drained` and `draining`
follow JAX's, and resume reopens admission.  A checkpointed request
resumed from prompt + generated (a prefix hit plus an extend) must
continue token for token as the never-drained run (tiny preset, f32) and
as JAX's resumed run, with equal drain counters and journey outcomes:
native pools, two streams, int8 (against an int8 run), a drain in the
middle of a chunked prefill, speculation, the dense cache, and the JAX
decoder latched to its Pallas kernel (interpret mode)."""

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
from aiko_services_tpu_torch.observe.ledger import assert_ledger_clean

from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
PROMPT41 = PROMPT + [5]
DRAIN_STATS = ("drain_refused", "drain_evacuated", "drain_checkpoints",
               "prefix_admits", "tokens_prefill", "prefills", "completed")


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


@functools.cache
def _oracle_fn(max_new: int):
    return jax.jit(functools.partial(JL.llama_greedy_decode,
                                     config=J_CONFIG, max_tokens=max_new))


def oracle(prompt, max_new) -> list:
    out = _oracle_fn(max_new)(weights()[0],
                              prompt=jnp.asarray([prompt], jnp.int32))
    return [int(t) for t in np.asarray(out)[0]]


_SEQ = [0]


def decoder_for(package: str, paged: bool = True, kernel: bool = False,
                **kwargs):
    """One decoder and its prefix cache (block 8)."""
    _SEQ[0] += 1
    name = f"dr{package}{_SEQ[0]}"
    params, model = weights()
    module = JS if package == "jax" else TS
    cache = module.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                 name=name)
    kwargs = {"max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4, "paged_kv": paged, "kv_block": 8,
              "prefix_cache": cache, "name": name, **kwargs}
    if package == "torch":
        return TS.ContinuousDecoder(model, T_CONFIG, device="cpu",
                                    **kwargs), cache
    before = JS.ATTENTION_IMPL
    if kernel:
        JS.ATTENTION_IMPL = "paged_kernel"
    try:
        decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    if paged:
        fresh_table_scratch(decoder)
    return decoder, cache


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
    assert len(done) == len(requests), f"{len(done)}/{len(requests)}"
    return done


def live_generated(decoder, rid):
    for request in decoder._slots:
        if request is not None and request.request_id == rid:
            return len(request.generated or [])
    return None


def outcomes(decoder) -> list:
    return [journey.outcome for journey in decoder.journeys.journeys()]


# -- admission and evacuation ---------------------------------------------------

def refuse_cycle(package: str):
    decoder, _ = decoder_for(package, max_slots=1)
    done = {}

    def keep(rid, tokens):
        done[rid] = [int(t) for t in tokens]

    assert decoder.submit("a", PROMPT, 6, keep)
    assert decoder.submit("b", PROMPT[:17] + [3, 4], 4, keep)
    decoder.pump()
    decoder.pump()
    evacuated = decoder.drain()
    state = (decoder.draining, decoder.drained)
    refused = decoder.submit("c", PROMPT, 4, keep)
    for _ in range(400):
        decoder.pump()
        if decoder.drained:
            break
    rearm = decoder.drain()
    decoder.resume()
    out = run(decoder, {"c2": (PROMPT, 4)})
    descriptors = [{k: v for k, v in d.items() if k != "callback"}
                   for d in evacuated]
    return (descriptors, state, refused, decoder.drained, rearm, done,
            out, {k: decoder.stats[k] for k in DRAIN_STATS},
            outcomes(decoder))


def test_drain_refuses_admits_and_evacuates_pending():
    expected = refuse_cycle("jax")
    got = refuse_cycle("torch")
    assert got == expected
    descriptors, state, refused, drained, rearm, done, out, stats, _ = got
    assert [d["request_id"] for d in descriptors] == ["b"]
    assert descriptors[0]["prompt"] == PROMPT[:17] + [3, 4]
    assert descriptors[0]["max_new_tokens"] == 4
    assert state == (True, False) and refused is False
    assert rearm == [] and stats["drain_checkpoints"] == 0
    assert done["a"] == oracle(PROMPT, 6) and out["c2"] == oracle(PROMPT, 4)


def test_idle_drain_completes_at_once():
    decoder, _ = decoder_for("torch")
    flag = []
    assert decoder.drain(on_complete=flag.append) == []
    assert decoder.drained and flag == [decoder]
    decoder.pump()                                  # no second callback
    assert flag == [decoder]


def test_all_pinned_drain_purges_to_zero_blocks():
    decoder, cache = decoder_for("torch")
    requests = {"s1": (PROMPT41, 8), "s2": (PROMPT[:17] + [3, 4], 6)}
    out = run(decoder, requests)
    for sid, (prompt, _) in requests.items():
        assert cache.session_store("default", sid, prompt + out[sid])[1] > 0
    assert decoder.drain() == [] and decoder.drained
    assert sorted(cache.sessions()) == [("default", "s1"),
                                        ("default", "s2")]
    assert cache.purge(demote=False) > 0 and cache.sessions() == []
    assert_ledger_clean(cache=cache)


# -- checkpoint and resume -------------------------------------------------------

def checkpoint_cycle(package: str, max_new=16, mid_prefill=False,
                     **kwargs):
    decoder, cache = decoder_for(package, **kwargs)
    done = {}
    assert decoder.submit("a", PROMPT, max_new,
                          lambda rid, t: done.update({rid: t}))
    if mid_prefill:
        decoder.pump()                 # the first prefill chunk in flight
    else:
        for _ in range(400):
            decoder.pump()
            generated = live_generated(decoder, "a")
            if generated is not None and generated >= 1:
                break
    assert "a" not in done
    evacuated, completed = {}, []
    decoder.drain(deadline=0.0,
                  on_evacuate=lambda d: evacuated.setdefault(
                      d["request_id"], d),
                  on_complete=lambda d: completed.append(1))
    for _ in range(10):
        if decoder.drained:
            break
        decoder.pump()
    assert decoder.drained and completed == [1]
    assert decoder.active_count == 0 and "a" not in done
    partial = [int(t) for t in evacuated["a"]["generated"]]
    context = PROMPT + partial
    hit = cache.match("default", context)[1]
    decoder.resume()
    out = run(decoder, {"a2": (context, max_new - len(partial))})
    return (partial, out["a2"], hit,
            {k: decoder.stats[k] for k in DRAIN_STATS}, outcomes(decoder))


@pytest.mark.parametrize("case", [
    {},
    {"kv_cache_dtype": "int8"},
    {"mid_prefill": True, "prefill_chunk": 16},
    {"max_new": 24, "speculate_k": 2},
    {"paged": False},
    {"kernel": True},
], ids=["native", "int8", "mid_prefill_chunked", "speculative", "dense",
        "paged_kernel"])
def test_checkpoint_resumes_token_for_token(case):
    case = dict(case)
    kernel = case.pop("kernel", False)
    expected = checkpoint_cycle("jax", kernel=kernel, **case)
    got = checkpoint_cycle("torch", **case)
    assert got == expected
    partial, rest, hit, stats, journey_outcomes = got
    max_new = case.get("max_new", 16)
    assert len(partial) < max_new
    if case.get("kv_cache_dtype") == "int8":
        # int8 KV rounds: held against an undrained int8 run
        reference, _ = decoder_for("torch", kv_cache_dtype="int8")
        gold = run(reference, {"g": (PROMPT, max_new)})["g"]
    else:
        gold = oracle(PROMPT, max_new)
    assert partial + rest == gold
    assert stats["drain_checkpoints"] == 1
    if not case.get("mid_prefill"):
        # every complete block of the written context was harvested
        assert hit >= (len(PROMPT) + len(partial) - 1) // 8 * 8
    assert journey_outcomes[0] == "evacuated"


def two_stream_cycle(package: str):
    decoder, _ = decoder_for(package)
    specs = {"a": (PROMPT, 16), "b": (PROMPT[:17] + [3, 4], 16)}
    done = {}
    for rid, (prompt, max_new) in specs.items():
        assert decoder.submit(rid, prompt, max_new,
                              lambda rid, t: done.update({rid: t}))
    for _ in range(400):
        decoder.pump()
        counts = [live_generated(decoder, rid) for rid in specs]
        if all(g is not None and g >= 1 for g in counts):
            break
    evacuated = {}
    decoder.drain(deadline=0.0, on_evacuate=lambda d: evacuated.setdefault(
        d["request_id"], d))
    for _ in range(10):
        if decoder.drained:
            break
        decoder.pump()
    decoder.resume()
    resumed = {}
    for rid, (prompt, max_new) in specs.items():
        partial = [int(t) for t in evacuated[rid]["generated"]]
        out = run(decoder, {rid + "2": (prompt + partial,
                                        max_new - len(partial))})
        resumed[rid] = partial + out[rid + "2"]
    return resumed, sorted(evacuated), decoder.stats["drain_checkpoints"]


def test_two_streams_checkpoint_together():
    expected = two_stream_cycle("jax")
    got = two_stream_cycle("torch")
    assert got == expected
    resumed, evacuated, checkpoints = got
    assert evacuated == ["a", "b"] and checkpoints == 2
    assert resumed["a"] == oracle(PROMPT, 16)
    assert resumed["b"] == oracle(PROMPT[:17] + [3, 4], 16)
