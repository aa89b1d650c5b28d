"""The port's dense ContinuousDecoder (paged_kv=False, the JAX default)
against the JAX package's on the same weights.

Both decoders run the dense slot cache in the block KV write (JAX's
default); the port's is plain PyTorch, as the JAX one is einsums outside
Pallas.  The cases are those of tests/test_serving.py that need nothing
left unported: one request, concurrent requests, a staggered admit, slot
reuse with more requests than slots, an EOS retire, the larger bucket, a
randomized soak (seeded scheduling, budgets and EOS), chunked prefill
(longer than a chunk, shorter than one, mixed with decoding slots under a
prefill budget, a prompt at the sequence cap), int8 KV through
multi-chunk prefill, and EOS as the first token.  Tokens (tiny preset,
f32) and every decoder counter but the two timings must be equal; the
int8 cache's bytes must be those of the JAX int8 cache, under 0.6 of the
native cache's."""

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
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.ops import paged_attention as TPA
from aiko_services_tpu_torch.serving import ContinuousDecoder

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
# decoder counters that are wall-clock seconds
TIMINGS = ("prefill_s", "decode_s")


@functools.cache
def weights(seed: int = 0):
    """(JAX params, the port's Llama) of the tiny preset from
    PRNGKey(seed)."""
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(seed))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


@functools.cache
def _oracle_fn(max_new: int, eos_token):
    return jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=max_new,
        eos_token=eos_token))


def oracle(params, prompt, max_new, eos_token=None) -> list:
    """JAX's whole-batch greedy decode, cut at EOS as the decoder cuts
    it."""
    out = _oracle_fn(max_new, eos_token)(
        params, prompt=jnp.asarray([prompt], jnp.int32))
    tokens = [int(t) for t in np.asarray(out)[0]]
    if eos_token is not None and eos_token in tokens:
        tokens = tokens[:tokens.index(eos_token)]
    return tokens


def drive(decoder, schedule: dict, rounds: int = 400) -> dict:
    """Run `decoder` until every request of `schedule` ({round: [(id,
    prompt, max_new)]}, submitted just before that round's pump)
    completed; returns {id: tokens}."""
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    total = sum(len(requests) for requests in schedule.values())
    last = max(schedule)
    for i in range(rounds):
        for request_id, prompt, max_new in schedule.get(i, ()):
            decoder.submit(request_id, prompt, max_new, keep)
        decoder.pump()
        if len(done) == total and i >= last:
            break
    assert len(done) == total, f"{len(done)}/{total} completed"
    return done


def both(schedule: dict, seed: int = 0, **kwargs) -> tuple:
    """(JAX decoder's tokens, the port decoder's tokens, the JAX decoder,
    the port decoder) over one schedule, both dense at `kwargs`; the
    counters of the two must be equal and no kernel launches."""
    params, model = weights(seed)
    jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    port = ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    assert not port.paged and port.pool is None
    launches = dict(TPA.launches)
    expected = drive(jax_decoder, schedule)
    result = drive(port, schedule)
    assert TPA.launches == launches
    assert_same_stats(jax_decoder, port)
    assert port.idle
    return expected, result, jax_decoder, port


def assert_same_stats(jax_decoder, port) -> None:
    for key, value in port.stats.items():
        if key not in TIMINGS:
            assert value == jax_decoder.stats[key], key


def _soak_schedule() -> tuple:
    """tests/test_serving.py:380's soak: 40 requests of seeded prompts
    (3, 8 or 13 tokens) and budgets (4, 9 or 19), 0-3 submitted a round;
    returns (schedule, {id: (prompt, max_new)})."""
    rng = np.random.default_rng(7)
    requests = {}
    for i in range(40):
        prompt = rng.integers(1, J_CONFIG.vocab,
                              size=(3, 8, 13)[int(rng.integers(0, 3))])
        requests[f"s{i}"] = (prompt.tolist(),
                             (4, 9, 19)[int(rng.integers(0, 3))])
    pending, schedule, round_index = list(requests.items()), {}, 0
    while pending:
        for _ in range(int(rng.integers(0, 4))):
            if pending:
                rid, (prompt, max_new) = pending.pop(0)
                schedule.setdefault(round_index, []).append(
                    (rid, prompt, max_new))
        round_index += 1
    return schedule, requests


LONG_40 = [(i * 13) % 50 + 1 for i in range(40)]


def _case_single():
    schedule = {0: [("r0", [5, 9, 23, 7], 12)]}
    kwargs = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4)
    return schedule, kwargs, {"r0": ([5, 9, 23, 7], 12)}


def _case_concurrent():
    prompts = {f"r{i}": [i + 3, (i * 7) % 50 + 1, 11] for i in range(4)}
    schedule = {0: [(rid, prompt, 10) for rid, prompt in prompts.items()]}
    kwargs = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4)
    return schedule, kwargs, {rid: (p, 10) for rid, p in prompts.items()}


def _case_staggered():
    # "late" joins after three rounds, while "early" is mid-flight
    schedule = {0: [("early", [4, 19, 2, 31], 16)],
                3: [("late", [8, 8, 40], 16)]}
    kwargs = dict(max_slots=2, prefill_buckets=(16,), steps_per_sync=2)
    return schedule, kwargs, {"early": ([4, 19, 2, 31], 16),
                              "late": ([8, 8, 40], 16)}


def _case_slot_reuse():
    prompts = {f"r{i}": [i + 1, 2 * i + 5] for i in range(6)}
    schedule = {0: [(rid, prompt, 8) for rid, prompt in prompts.items()]}
    kwargs = dict(max_slots=2, prefill_buckets=(16,), steps_per_sync=4)
    return schedule, kwargs, {rid: (p, 8) for rid, p in prompts.items()}


def _case_long_prompt():
    prompt = [(3 * i) % 40 + 1 for i in range(20)]          # > bucket 8
    kwargs = dict(max_slots=2, prefill_buckets=(8, 32), steps_per_sync=2)
    return {0: [("long", prompt, 8)]}, kwargs, {"long": (prompt, 8)}


def _case_chunked():
    # 40 tokens at chunk 16: [0, 16) [16, 32), the final slides to [24, 40)
    kwargs = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4,
                  prefill_chunk=16)
    return {0: [("long", LONG_40, 10)]}, kwargs, {"long": (LONG_40, 10)}


def _case_chunked_short():
    prompt = [(i * 7) % 40 + 2 for i in range(20)]          # 8 < 20 < 32
    kwargs = dict(max_slots=4, prefill_buckets=(8,), steps_per_sync=4,
                  prefill_chunk=32)
    return {0: [("mid", prompt, 8)]}, kwargs, {"mid": (prompt, 8)}


def _case_chunked_mixed():
    prompts = {"s0": [3, 9, 4], "s1": [8, 2, 44, 6],
               "long0": [(i * 11) % 60 + 1 for i in range(40)],
               "long1": [(i * 5) % 30 + 7 for i in range(33)]}
    budgets = {rid: 12 if rid.startswith("s") else 8 for rid in prompts}
    schedule = {0: [(rid, prompts[rid], 12) for rid in ("s0", "s1")],
                1: [(rid, prompts[rid], 8) for rid in ("long0", "long1")]}
    kwargs = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4,
                  prefill_chunk=16, prefill_budget=16)
    return schedule, kwargs, {rid: (prompts[rid], budgets[rid])
                              for rid in prompts}


def _case_chunked_seq_cap():
    prompt = [(i * 3) % 70 + 1 for i in range(95)]          # max_seq - 1
    kwargs = dict(max_slots=2, prefill_buckets=(16,), steps_per_sync=4,
                  prefill_chunk=32)
    return {0: [("cap", prompt, 8)]}, kwargs, {"cap": (prompt, 1)}


def _case_int8_multichunk():
    requests = {"short": ([5, 9, 23, 7], 10),
                "mid": ([(i * 7) % 40 + 2 for i in range(14)], 8),
                "long": (LONG_40, 8)}
    schedule = {0: [(rid, p, n) for rid, (p, n) in requests.items()]}
    kwargs = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4,
                  prefill_chunk=16, kv_cache_dtype="int8")
    return schedule, kwargs, None


CASES = {"single": _case_single, "concurrent": _case_concurrent,
         "staggered": _case_staggered, "slot_reuse": _case_slot_reuse,
         "long_prompt": _case_long_prompt, "chunked": _case_chunked,
         "chunked_short": _case_chunked_short,
         "chunked_mixed": _case_chunked_mixed,
         "chunked_seq_cap": _case_chunked_seq_cap,
         "int8_multichunk": _case_int8_multichunk}


@pytest.mark.parametrize("case", list(CASES))
def test_dense_decoder_matches_jax(case):
    schedule, kwargs, oracles = CASES[case]()
    expected, result, jax_decoder, port = both(schedule, **kwargs)
    assert result == expected
    params, _ = weights()
    for rid, (prompt, max_new) in (oracles or {}).items():
        assert result[rid] == oracle(params, prompt, max_new), rid
    if case == "chunked":
        assert port.stats["prefill_chunks"] == 3
        assert port.stats["chunk_admits"] == 1
    elif case == "chunked_short":
        assert port.stats["prefill_chunks"] == 1
    elif case == "chunked_mixed":
        assert port.stats["round_prefill_tokens_max"] <= 16 + 16
    elif case == "chunked_seq_cap":
        assert len(result["cap"]) == 1          # the cap leaves room for one
    elif case == "int8_multichunk":
        # int8 rounding sits far below this model's argmax margins: the
        # native cache gives the same tokens
        native = {key: value for key, value in kwargs.items()
                  if key != "kv_cache_dtype"}
        assert drive(ContinuousDecoder(weights()[1], T_CONFIG,
                                       device="cpu", **native),
                     schedule) == result
        assert port.kv_int8 and isinstance(port._k[0], dict)
        assert port.stats["prefill_chunks"] >= 3
        assert port.stats["tokens_prefill"] == sum(
            len(prompt) for (_, prompt, _) in schedule[0])


def test_eos_retires_a_request_inside_a_round():
    params, _ = weights()
    prompt = [5, 9, 23, 7]
    full = oracle(params, prompt, 12)
    eos = full[5]                                # fires at step 5
    expected, result, _, port = both(
        {0: [("r0", prompt, 12)]}, max_slots=2, prefill_buckets=(16,),
        steps_per_sync=3, eos_token=eos)
    assert result == expected == {"r0": full[:full.index(eos)]}


def test_eos_as_the_first_token_counts_no_decode_tokens():
    params, _ = weights()
    prompt = [5, 9, 23, 7]
    first = oracle(params, prompt, 1)[0]
    expected, result, _, port = both(
        {0: [("r0", prompt, 8)]}, max_slots=2, prefill_buckets=(16,),
        steps_per_sync=4, eos_token=first)
    assert result == expected == {"r0": []}
    assert port.stats["tokens_decode"] == 0
    assert port.stats["completed"] == 1


def test_randomized_soak_matches_jax():
    """Seeded scheduling randomness (admission timing, budgets, EOS 17)
    over 40 requests on 6 slots, the cache resizing in 32-token steps."""
    schedule, requests = _soak_schedule()
    expected, result, _, port = both(
        schedule, seed=11, max_slots=6, prefill_buckets=(8, 16),
        steps_per_sync=8, eos_token=17, t_block=32)
    assert result == expected
    assert len(result) == len(requests)
    assert port.wasted_fraction() < 0.5


def test_int8_cache_bytes_match_jax_and_halve():
    params, model = weights()
    kwargs = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4)
    for dtype in (None, "int8"):
        port = ContinuousDecoder(model, T_CONFIG, device="cpu",
                                 kv_cache_dtype=dtype, **kwargs)
        jax_decoder = JS.ContinuousDecoder(params, J_CONFIG,
                                           kv_cache_dtype=dtype, **kwargs)
        assert port.kv_cache_bytes() == jax_decoder.kv_cache_bytes()
    full = ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    assert port.kv_cache_bytes() < 0.6 * full.kv_cache_bytes()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousDecoder(model, T_CONFIG, device="cpu",
                          kv_cache_dtype="int4", **kwargs)


def test_the_cache_extent_follows_the_workload():
    """_fit_caches grows the time axis in t_block steps for a long
    context and shrinks it back once only short ones remain, as JAX's
    does, with the tokens unchanged."""
    schedule = {0: [("long", LONG_40, 40)], 2: [("short", [3, 5], 60)]}
    expected, result, jax_decoder, port = both(
        schedule, max_slots=2, prefill_buckets=(64,), steps_per_sync=4,
        t_block=16)
    assert result == expected
    assert port._k[0].shape[2] == port._cache_t == jax_decoder._cache_t
