"""The sharded decoder's timed decisions against the JAX package's
unsharded decoder: weight_quant on a model axis, drain, deadline sheds
(submit's and an AdmissionGate watching the decoder) and the host KV tier
under LRU pressure.

The port's ContinuousDecoder runs on gloo CPU ranks (tests/torch_spmd.py,
rank bodies in tests/torch_spmd_cases.py `tp_ops`), each on its own
shards of the same JAX-seeded weights, over {model: 2}, {model: 4} and
{data: 2, model: 2}; JAX's decoder runs once, unsharded, on the full
weights.  On a mesh every decision that reads a clock or a thread's
timing rides the decoder's round note and rank 0 decides, so each
scenario runs twice on the ranks: in lockstep (every rank handed each
request and call at the same round), which must equal JAX's run; and
staggered, each rank handed the requests and calls at its own rounds and
its clock (serving.time.monotonic) offset by its own amount, where every
rank must plan every round alike (plan digests) and agree on every
decision, and the decisions that do not depend on the round (tokens,
shed sets, tier counts) must still equal JAX's.

Tolerance, f32: tokens equal JAX's, or split only where JAX's plain
forward puts the top-2 logits within 1e-4 (the row-parallel sums add
the ranks' partials in another order); each rank's int8 weights and
scales are its slice of JAX's quantize_linear of the whole weight, bit
for bit; shed sets, evacuated and checkpointed descriptors, and the
tier's demoted, promoted, evicted and hit counts equal JAX's exactly."""

import dataclasses
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import layers as JLayers
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.ops.admission import AdmissionGate as JGate
from aiko_services_tpu.serving_tiered import HostBlockStore as JStore

import torch_spmd_cases as cases
from test_torch_paged_chunked import fresh_table_scratch
from test_torch_tp_serving import BASE, FIELDS, J_CONFIG, jax_params
from torch_spmd import run_ranks

torch.set_num_threads(1)

PROMPTS = {"r0": [5, 9, 23, 7], "r1": [40, 2],
           "r2": [17, 3, 3, 8, 100, 61, 9], "r3": [11, 12, 13]}
MAX_NEW = 8
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4},
              "data2_model2": {"data": 2, "model": 2}}
TIER = {"base": {"max_slots": 2, "prefill_buckets": (64,),
                 "steps_per_sync": 4},
        "prompt": [(i * 13) % 50 + 1 for i in range(40)],
        "other": [(i * 7) % 50 + 1 for i in range(24)], "max_new": 6}
TIE_GAP = 1e-4
DRAINS = (0.0, None)


# -- JAX's unsharded decoder ------------------------------------------------

def _jax_decoder(**kwargs):
    params, _ = jax_params()
    decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    if decoder.paged:
        fresh_table_scratch(decoder)
    return decoder


def _serve(decoder, requests, done, refused=None, deadlines=None):
    """JAX: submit in order (a refused submit is a shed) and pump until
    answered."""
    for rid, (prompt, max_new) in requests.items():
        deadline = None if not deadlines or rid not in deadlines else \
            time.monotonic() + deadlines[rid]
        accepted = decoder.submit(
            rid, prompt, max_new,
            lambda r, t: done.update({r: [int(x) for x in t]}),
            deadline=deadline)
        if not accepted:
            refused[rid] = "shed"
    for _ in range(400):
        if all(rid in done or rid in (refused or {}) for rid in requests):
            return
        decoder.pump()
    raise AssertionError("JAX decoder did not answer")


def jax_weight_quant():
    done = {}
    _serve(_jax_decoder(weight_quant=True, **BASE),
           {rid: (p, MAX_NEW) for rid, p in PROMPTS.items()}, done)
    return {"tokens": done}


def jax_drain(deadline):
    decoder = _jax_decoder(**BASE)
    done, checkpointed = {}, []
    for rid, prompt in PROMPTS.items():
        decoder.submit(rid, prompt, MAX_NEW,
                       lambda r, t: done.update({r: [int(x) for x in t]}))
    for _ in range(2):
        decoder.pump()
    evacuated = decoder.drain(deadline=deadline,
                              on_evacuate=checkpointed.append)
    for _ in range(200):
        if decoder.drained:
            break
        decoder.pump()
    drained = decoder.drained
    decoder.resume()
    _serve(decoder, {"after": (PROMPTS["r0"], MAX_NEW)}, done)
    return {"tokens": done,
            "evacuated": [cases._descriptor(e) for e in evacuated],
            "checkpointed": [cases._descriptor(e) for e in checkpointed],
            "stats": {key: decoder.stats[key] for key in (
                "drain_evacuated", "drain_checkpoints", "drain_refused",
                "completed")},
            "drained": drained, "draining": decoder.draining}


def jax_deadlines():
    decoder = _jax_decoder(**BASE)
    gate = JGate()
    gate.watch_decoder(decoder)
    done, refused = {}, {}
    _serve(decoder, {"warm": (PROMPTS["r0"], MAX_NEW)}, done)
    remaining = {f"{rid}_late": -1.0 for rid in PROMPTS} | \
        {f"{rid}_ok": 1e9 for rid in PROMPTS}
    gated = sorted(remaining)[::2]
    gate_shed = sorted(rid for rid in gated
                       if gate.shed_early(remaining[rid])[0])
    requests = {rid: (PROMPTS[rid.rsplit("_", 1)[0]], MAX_NEW)
                for rid in remaining if rid not in gate_shed}
    _serve(decoder, requests, done, refused, deadlines=remaining)
    return {"tokens": done, "shed": sorted(gate_shed + list(refused)),
            "stats": {key: decoder.stats[key] for key in (
                "admission_shed", "completed")}}


def jax_tier():
    cache = JS.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                             name="jtier")
    store = JStore(max_bytes=64 << 20, name="jtierh")
    cache.attach_host_store(store)
    decoder = _jax_decoder(paged_kv=True, kv_block=8, prefix_cache=cache,
                           **TIER["base"])
    done = {}
    max_new = TIER["max_new"]
    _serve(decoder, {"a": (TIER["prompt"], max_new)}, done)
    cache.max_bytes = 3 * decoder.pool.block_nbytes
    _serve(decoder, {"c": (TIER["other"], max_new)}, done)
    cache.max_bytes = 64 << 20
    _serve(decoder, {"a2": (TIER["prompt"], max_new)}, done)
    return {"tokens": done,
            "cache": {key: cache.stats[key] for key in (
                "demoted", "promoted", "evictions", "hit_tokens")},
            "store": {key: store.stats[key] for key in (
                "demoted", "promoted", "evicted", "refused")}}


@pytest.fixture(scope="module")
def reference():
    """JAX's unsharded runs, and its plain serve of every prompt (what a
    request generates whatever round it runs in)."""
    out = {"weight_quant": jax_weight_quant(), "deadlines": jax_deadlines(),
           "tier": jax_tier()}
    for deadline in DRAINS:
        out[("drain", deadline)] = jax_drain(deadline)
    plain = {}
    _serve(_jax_decoder(**BASE),
           {rid: (p, MAX_NEW) for rid, p in PROMPTS.items()}, plain)
    out["plain"] = plain
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """geometry → [each rank's tp_ops result] (two spawns: two ranks,
    then four)."""
    _, flat = jax_params()
    out = {}
    for world, names in ((2, ("model2",)), (4, ("model4", "data2_model2"))):
        results = run_ranks(
            cases.tp_ops, world, tmp_path_factory.mktemp(f"ops{world}"),
            {name: GEOMETRIES[name] for name in names}, flat, FIELDS, BASE,
            PROMPTS, MAX_NEW, TIER, timeout=300.0)
        for name in names:
            out[name] = [rank[name] for rank in results]
    return out


# -- checks ----------------------------------------------------------------

@functools.cache
def top2_gap(prompt: tuple, tokens: tuple) -> float:
    params, _ = jax_params()
    logits = np.asarray(JL.llama_forward(
        params, J_CONFIG, jnp.asarray([list(prompt + tokens)],
                                      jnp.int32)))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def assert_tokens(prompt, got, want, prefix: bool = False) -> None:
    """got == want, or (prefix) got a prefix of want, or a split where
    JAX's top-2 gap is a tie."""
    if (got == want[:len(got)]) if prefix else (got == want):
        return
    split = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
    assert split < min(len(got), len(want)), (got, want)
    gap = top2_gap(tuple(prompt), tuple(want[:split]))
    assert gap < TIE_GAP, (got, want, gap)


def prompt_of(rid: str) -> list:
    if rid in ("a", "a2"):
        return TIER["prompt"]
    if rid == "c":
        return TIER["other"]
    base = rid.rsplit("_", 1)[0]
    return PROMPTS["r0" if base in ("after", "warm") else base]


def assert_all_tokens(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for rid, tokens in want.items():
        assert_tokens(prompt_of(rid), got[rid], tokens)


def assert_lockstep(results: list) -> None:
    """Every rank planned every round alike."""
    plans = [result["plans"] for result in results]
    assert plans[0] and all(p == plans[0] for p in plans)


def scenario(ranks, geometry, key):
    return [rank[key] for rank in ranks[geometry]]


STAGGERED = [False, True]
STAGGER_IDS = ["lockstep", "staggered_skewed"]


@pytest.mark.parametrize("staggered", STAGGERED, ids=STAGGER_IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_weight_quant_on_a_model_axis_serves_jax_tokens(
        ranks, reference, geometry, staggered):
    results = scenario(ranks, geometry, ("weight_quant", staggered))
    assert_lockstep(results)
    for result in results:
        assert_all_tokens(result["tokens"],
                          reference["weight_quant"]["tokens"])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_each_rank_holds_its_slice_of_jax_int8_weights(ranks, geometry):
    """The row-parallel o and down take their scales over the whole
    input axis (a max over the model group): each rank's w8 is its row
    slice of JAX's quantize_linear of the whole weight and its s the
    whole s; the column-parallel q keeps its own max, its w8 and s the
    column slice."""
    params, _ = jax_params()
    layer = params["layers"][0]
    n = GEOMETRIES[geometry]["model"]
    whole = {name: JLayers.quantize_linear(leaf) for name, leaf in (
        ("o", layer["attn"]["o"]), ("q", layer["attn"]["q"]),
        ("down", layer["down"]))}
    for rank in ranks[geometry]:
        m = rank["model_rank"]
        leaves = rank[("weight_quant", False)]["leaves"]
        for name, quantized in whole.items():
            w8 = np.asarray(quantized["w8"])
            s = np.asarray(quantized["s"])
            if name == "q":
                cols = w8.shape[1] // n
                want_w8 = w8[:, m * cols:(m + 1) * cols]
                want_s = s[m * cols:(m + 1) * cols]
            else:
                rows = w8.shape[0] // n
                want_w8 = w8[m * rows:(m + 1) * rows]
                want_s = s
            assert np.array_equal(leaves[name]["w8"], want_w8), name
            assert np.array_equal(leaves[name]["s"], want_s), name


@pytest.mark.parametrize("deadline", DRAINS, ids=["checkpoint", "finish"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_drain_at_a_fixed_round_matches_jax(ranks, reference, geometry,
                                            deadline):
    """Drain after the second round, with a deadline that checkpoints
    the live slots at once, or none (they finish): queued requests
    evacuate, checkpointed ones evacuate with what they generated, and
    after resume a new request is served; everything equals JAX's."""
    want = reference[("drain", deadline)]
    results = scenario(ranks, geometry, ("drain", deadline, False))
    assert_lockstep(results)
    for result in results:
        assert_all_tokens(result["tokens"], want["tokens"])
        for kind in ("evacuated", "checkpointed"):
            got = result[kind]
            assert [e[:2] + e[3:] for e in got] == \
                [e[:2] + e[3:] for e in want[kind]], kind
            for entry, expected in zip(got, want[kind]):
                assert_tokens(entry[1], entry[2], expected[2])
        assert result["stats"] == want["stats"]
        assert result["drained"] and not result["draining"]
    assert want["stats"]["drain_evacuated"] == 4 - (deadline is None) * 2
    assert want["stats"]["drain_checkpoints"] == (2 if deadline == 0.0
                                                  else 0)


@pytest.mark.parametrize("deadline", DRAINS, ids=["checkpoint", "finish"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_drain_called_at_other_rounds_on_skewed_clocks(ranks, reference,
                                                       geometry, deadline):
    """Each rank handed the requests and the drain at its own rounds,
    its clock skewed: the drain begins where every rank holds it, and
    every rank evacuates and checkpoints the same requests with the same
    partial generations; what completes or evacuates is JAX's tokens (a
    prefix of them for a partial generation)."""
    results = scenario(ranks, geometry, ("drain", deadline, True))
    assert_lockstep(results)
    plain = reference["plain"]
    first = results[0]
    for result in results:
        assert result["evacuated"] == first["evacuated"]
        assert result["checkpointed"] == first["checkpointed"]
        assert result["stats"] == first["stats"]
        assert result["drained"] and not result["draining"]
        for rid, tokens in result["tokens"].items():
            assert_tokens(prompt_of(rid), tokens,
                          plain["r0" if rid == "after" else rid],
                          prefix=rid in {e[0] for e in
                                         result["checkpointed"]})
        for entry in result["evacuated"] + result["checkpointed"]:
            assert_tokens(entry[1], entry[2], plain[entry[0]], prefix=True)
    assert first["stats"]["drain_evacuated"] + \
        first["stats"]["completed"] - 1 == len(PROMPTS)


@pytest.mark.parametrize("staggered", STAGGERED, ids=STAGGER_IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_deadline_sheds_and_watch_decoder_verdicts_match_jax(
        ranks, reference, geometry, staggered):
    """Decisive deadlines (passed, or 1e9 s away), half through a gate
    watching the decoder and half straight to submit: JAX's gate and
    submit shed the passed ones at once; on the mesh the gate sheds
    nothing early and rank 0's verdict sheds them at the note, through
    on_refused.  The shed sets and tokens equal JAX's, and every rank's
    gate reads the same agreed estimate."""
    want = reference["deadlines"]
    results = scenario(ranks, geometry, ("deadlines", staggered))
    assert_lockstep(results)
    for result in results:
        assert result["shed"] == want["shed"]
        assert all(why == "shed" for why in result["refused"].values())
        assert_all_tokens(result["tokens"], want["tokens"])
        # every shed is the decoder's on the mesh
        assert result["stats"] == {"admission_shed": len(want["shed"]),
                                   "completed": want["stats"]["completed"]}
        assert result["gate_wait"] is not None
        assert result["gate_wait"] == results[0]["gate_wait"]
    assert want["shed"] == sorted(f"{rid}_late" for rid in PROMPTS)


@pytest.mark.parametrize("staggered", STAGGERED, ids=STAGGER_IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_host_tier_under_lru_pressure_matches_jax(ranks, reference,
                                                  geometry, staggered):
    """A three-block device budget demotes the first conversation's
    chain as another request's harvest lands; the conversation again
    promotes it.  Tokens, hit tokens and the demoted, promoted and
    evicted counts equal JAX's; each rank's host store holds its KV
    heads of each block."""
    want = reference["tier"]
    results = scenario(ranks, geometry, ("tier", staggered))
    assert_lockstep(results)
    n = GEOMETRIES[geometry]["model"]
    for result in results:
        assert_all_tokens(result["tokens"], want["tokens"])
        assert result["cache"] == want["cache"]
        assert result["store"] == want["store"]
        assert result["host_heads"][1] == J_CONFIG.num_kv_heads // n
    assert want["cache"]["demoted"] > 0 and want["cache"]["promoted"] > 0
    assert want["cache"]["hit_tokens"] > 0
