"""Self-speculative decoding on the port's dense decoder against the JAX
package's, on the same weights (tiny preset, f32).

For speculate_k in {1, 2, 4} and speculate_ngram in {1, 2, 3} the port's
speculative tokens must equal the port's non-speculative run and JAX's
speculative decoder, and spec_proposed / spec_accepted (and the step
counters) must equal JAX's.  The traffic is that of
tests/test_serving.py:756 and :782: a repetitive prompt the prompt-lookup
drafter accepts from, unstructured prompts whose drafts are rejected,
admits while others are mid-flight, and an EOS that lands inside a verify
block (its later tokens must not be delivered).  The compositions of
tests/test_serving.py:818 and tests/test_paged_kv.py:146 (int8 KV,
chunked prefill, mid-stream admits) run at k = 2.  The paged decoder runs
the same matrix in tests/test_torch_speculative_paged.py."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.ops import paged_attention as TPA
from aiko_services_tpu_torch.serving import ContinuousDecoder

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
# tests/test_serving.py:756 and :782: drafts accepted ("loop") and
# rejected ("plain", "tiny"), two more admitted after the third round
FIRST = {"plain": ([5, 9, 23, 7], 16), "tiny": ([40, 2], 16),
         "loop": ([7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8], 16)}
LATER = {"late": ([8, 8, 40], 12), "loop2": ([3, 4, 3, 4, 3, 4, 3], 10)}
MATRIX = [(k, ngram) for k in (1, 2, 4) for ngram in (1, 2, 3)]
# counters the two packages must agree on (timings and the paged-only
# copy counters aside)
SPEC_STATS = ("steps", "rounds", "completed", "prefills", "useful_steps",
              "wasted_steps", "tokens_decode", "tokens_prefill",
              "spec_proposed", "spec_accepted", "accepted_per_step",
              "prefill_chunks", "chunk_admits")


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def drive(decoder, first, later=None, at: int = 3,
          rounds: int = 400) -> dict:
    """Submit `first`, pump, submit `later` after `at` rounds, pump until
    every request completed; returns {id: tokens}."""
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    for rid, (prompt, max_new) in first.items():
        decoder.submit(rid, prompt, max_new, keep)
    total = len(first) + len(later or {})
    for i in range(rounds):
        if i == at and later:
            for rid, (prompt, max_new) in later.items():
                decoder.submit(rid, prompt, max_new, keep)
            later = None
        decoder.pump()
        if len(done) == total:
            break
    assert len(done) == total, f"{len(done)}/{total} completed"
    return done


def eos_inside_blocks(decoder) -> list:
    """Record, for every speculative round the decoder delivers, the
    (step, slot, position) of each emitted EOS past a block's first
    position: an EOS inside a verify block.  Wraps _deliver_spec."""
    found = []
    deliver = decoder._deliver_spec

    def recording(emitted, emit_mask, occupied, num_steps):
        hits = np.argwhere(emit_mask & (emitted == decoder.eos_token))
        found.extend(tuple(int(i) for i in hit) for hit in hits
                     if hit[2] > 0)
        return deliver(emitted, emit_mask, occupied, num_steps)

    decoder._deliver_spec = recording
    return found


# the EOS of the matrix traffic: the token "plain" emits at its 14th
# step without speculation (after 64, which the drafter proposes it
# behind).  At these (k, ngram) pairs a verify block accepts drafts up to
# it, so the EOS lands inside the block and the block's later tokens must
# not be delivered
EOS = 236
EOS_INSIDE = set(MATRIX) - {(1, 2), (2, 1)}


KWARGS = dict(max_slots=4, prefill_buckets=(16,), steps_per_sync=4)


@functools.cache
def reference(k: int, ngram: int, **extra) -> tuple:
    """(JAX speculative tokens, the JAX decoder's counters, the port's
    non-speculative tokens) of the matrix traffic with EOS."""
    params, model = weights()
    kwargs = {**KWARGS, "eos_token": EOS, **extra}
    jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, speculate_k=k,
                                       speculate_ngram=ngram, **kwargs)
    expected = drive(jax_decoder, FIRST, LATER)
    base = drive(ContinuousDecoder(model, T_CONFIG, device="cpu",
                                   **kwargs), FIRST, LATER)
    return expected, dict(jax_decoder.stats), base


def check_against_jax(paged: bool, k: int, ngram: int) -> ContinuousDecoder:
    expected, jax_stats, base = reference(k, ngram)
    _, model = weights()
    port = ContinuousDecoder(model, T_CONFIG, device="cpu",
                             speculate_k=k, speculate_ngram=ngram,
                             paged_kv=paged, kv_block=8,
                             eos_token=EOS, **KWARGS)
    inside = eos_inside_blocks(port)
    launches = dict(TPA.launches)
    result = drive(port, FIRST, LATER)
    assert TPA.launches == launches                   # no kernel on the CPU
    assert result == base == expected
    for key in SPEC_STATS:
        assert port.stats[key] == jax_stats[key], key
    assert port.stats["spec_proposed"] == k * port.stats["useful_steps"]
    assert 0.0 < port.accept_rate() < 1.0
    assert bool(inside) == ((k, ngram) in EOS_INSIDE), inside
    if paged:
        assert port.pool.used_blocks() == 0
    assert port.idle
    return port


@pytest.mark.parametrize("k,ngram", MATRIX)
def test_dense_speculation_matches_jax(k, ngram):
    check_against_jax(False, k, ngram)


def test_int8_chunked_speculation_matches_jax():
    """tests/test_serving.py:818: the verify reading an int8 cache (the
    scales folded) with quantized side merges, through chunked prefill,
    equals the non-speculative int8 decoder and JAX's."""
    params, model = weights()
    requests = {"loop": ([7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8], 12),
                "long": (PROMPT, 8)}
    kwargs = dict(KWARGS, prefill_chunk=16, kv_cache_dtype="int8")
    expected = drive(JS.ContinuousDecoder(params, J_CONFIG, speculate_k=2,
                                          **kwargs), requests)
    base = drive(ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs),
                 requests)
    port = ContinuousDecoder(model, T_CONFIG, device="cpu", speculate_k=2,
                             **kwargs)
    assert drive(port, requests) == base == expected
    assert port.stats["prefill_chunks"] >= 3 and port.stats["spec_accepted"]


def test_int8_chunked_midstream_speculation_matches_jax():
    """tests/test_paged_kv.py:146: k = 2, int8 KV, chunks of 16 (a
    70-token prompt past the bucket of 64) and an admit after the second
    round."""
    params, model = weights()
    first = {"a": (PROMPT, 10), "b": (PROMPT[:17] + [3, 4], 8),
             "long": ((PROMPT * 3)[:70], 8)}
    later = {"mid": (PROMPT[:9] + [7], 6)}
    kwargs = dict(max_slots=4, prefill_buckets=(64,), steps_per_sync=4,
                  prefill_chunk=16, kv_cache_dtype="int8")
    jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, speculate_k=2,
                                       **kwargs)
    expected = drive(jax_decoder, first, later, at=2)
    port = ContinuousDecoder(model, T_CONFIG, device="cpu", speculate_k=2,
                             **kwargs)
    assert drive(port, first, later, at=2) == expected
    for key in SPEC_STATS:
        assert port.stats[key] == jax_decoder.stats[key], key
    assert port.stats["prefill_chunks"] == 5


def test_speculation_options_are_checked():
    _, model = weights()
    with pytest.raises(ValueError, match="speculate_k must be >= 0"):
        ContinuousDecoder(model, T_CONFIG, device="cpu", speculate_k=-1)
    with pytest.raises(ValueError, match="speculate_ngram must be >= 1"):
        ContinuousDecoder(model, T_CONFIG, device="cpu", speculate_k=2,
                          speculate_ngram=0)
    decoder = ContinuousDecoder(model, T_CONFIG, device="cpu",
                                speculate_k=3, **KWARGS)
    assert decoder.accept_rate() == 0.0
    assert tuple(decoder._context.shape) == (4, J_CONFIG.max_seq_len)
    # no headroom past max_seq: the speculative merge drops what lies out
    # of range
    decoder._fit_caches(10 ** 6)
    assert decoder._cache_t == J_CONFIG.max_seq_len
    assert ContinuousDecoder(model, T_CONFIG, device="cpu",
                             **KWARGS)._context is None
