"""The port's paged ContinuousDecoder with int8 KV pools and chunked
prefill against the JAX package's, on the same weights.

The JAX decoder runs paged_kv=True with its decode attention latched to
the Pallas paged kernel (interpret mode on the CPU, latched as
tests/test_paged_kv.py latches it), the port's runs the kernel's plain
version.  Greedy tokens must be identical (tiny preset, f32) for int8
pools, native chunked prefill (chunk 16, an 80-token prompt), int8 with
chunked prefill and a mid-stream admit, and a prefill_budget that
rations chunks and admits; afterwards the pool holds no live block and
no kernel launched.  Int8 output differs from the native pool's by
design (the stored K/V are rounded), so int8 is held against int8."""

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
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
REQUESTS = {"a": (PROMPT, 10), "b": (PROMPT[:17] + [3, 4], 8)}
LONG = {"long": ((PROMPT * 3)[:80], 8)} | REQUESTS
MIDSTREAM = {"mid": (PROMPT[:9] + [7], 6)}


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def run(decoder, requests, midstream=None, rounds=400):
    """Drive requests to completion; `midstream` requests are submitted
    after the second pump round."""
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    for request_id, (prompt, max_new) in requests.items():
        decoder.submit(request_id, prompt, max_new, keep)
    total = len(requests) + len(midstream or {})
    for i in range(rounds):
        decoder.pump()
        if i == 1 and midstream:
            for request_id, (prompt, max_new) in midstream.items():
                decoder.submit(request_id, prompt, max_new, keep)
            midstream = None
        if len(done) == total:
            break
    assert len(done) == total, f"{len(done)}/{total} completed"
    return done


def fresh_table_scratch(jax_decoder) -> None:
    """Give each of the JAX decoder's admit and extend groups its own
    host table-row buffer.  The JAX decoder stages every group's table
    rows in one reused numpy buffer (_tables_scratch) and hands a view of
    it to jnp.array; on the CPU the dispatched program can still read
    that buffer after the host has written the next group's rows into
    it, so an admit and an extend dispatched in one round sometimes
    write K/V into each other's blocks (ROADMAP.md Queue 3).  The port
    copies the rows when it makes the device tensor."""
    for name in ("_admit_group", "_extend_group"):
        group = getattr(jax_decoder, name)

        def fresh(*args, _group=group, **kwargs):
            jax_decoder._tables_scratch = np.zeros_like(
                jax_decoder._tables_np)
            return _group(*args, **kwargs)

        setattr(jax_decoder, name, fresh)


def both(weights, requests, midstream=None, **kwargs):
    """(JAX paged-kernel decoder's tokens, the port decoder's tokens,
    the JAX decoder, the port decoder), each decoder's pool audited
    empty and no kernel launched on the CPU."""
    params, model = weights
    kwargs = {"max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4, "paged_kv": True, "kv_block": 8,
              **kwargs}
    before = JS.ATTENTION_IMPL
    JS.ATTENTION_IMPL = "paged_kernel"
    try:
        jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    assert jax_decoder.paged_kernel
    fresh_table_scratch(jax_decoder)
    port = ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    launches = dict(TPA.launches)
    expected = run(jax_decoder, requests, midstream)
    result = run(port, requests, midstream)
    assert TPA.launches == launches                   # no kernel on the CPU
    assert port.pool.used_blocks() == 0               # drain audit
    assert port.idle
    return expected, result, jax_decoder, port


def test_int8_tokens_match_jax(weights):
    expected, result, _, port = both(weights, REQUESTS,
                                     kv_cache_dtype="int8")
    assert result == expected
    assert port.kv_int8 and isinstance(port.pool.k_pools[0], dict)
    assert port.stats["prefill_chunks"] == 0


def test_chunked_prefill_tokens_match_jax(weights):
    expected, result, jax_decoder, port = both(weights, LONG,
                                               prefill_chunk=16)
    assert result == expected
    # 80 tokens in chunks of 16: five extends, the last not sliding back
    for key in ("prefill_chunks", "chunk_admits", "prefills",
                "tokens_prefill", "round_prefill_tokens_max"):
        assert port.stats[key] == jax_decoder.stats[key], key
    assert port.stats["prefill_chunks"] == 5
    assert port.stats["chunk_admits"] == 1


def test_int8_chunked_with_a_midstream_admit_tokens_match_jax(weights):
    # the extend dequantizes the pool in the kernel (fold_scales=False)
    # and stores the chunk quantized; a 70-token prompt's final chunk
    # slides back over written positions
    long = {"long": ((PROMPT * 3)[:70], 8)} | REQUESTS
    midstream = {"late": ((PROMPT * 2)[5:76], 5)} | MIDSTREAM
    expected, result, jax_decoder, port = both(
        weights, long, midstream, kv_cache_dtype="int8", prefill_chunk=16)
    assert result == expected
    assert port.stats["chunk_admits"] == 2
    assert port.stats["prefill_chunks"] == \
        jax_decoder.stats["prefill_chunks"] == 10


def test_prefill_budget_rations_chunks_and_admits(weights):
    """Budget 32 with chunks of 16: a bucketed admit (bucket 64) waits
    behind spent budget, FIFO, and chunk rows past the budget wait a
    round; the first admit and the first chunk row of a round always go
    (64 + 16 tokens)."""
    requests = {"l1": ((PROMPT * 3)[:80], 4), "l2": ((PROMPT * 3)[7:77], 4),
                "s1": (PROMPT[:20], 6), "s2": (PROMPT[3:30], 3)}
    expected, result, jax_decoder, port = both(
        weights, requests, prefill_chunk=16, prefill_budget=32)
    assert result == expected
    for key in ("prefill_chunks", "rounds", "round_prefill_tokens_max"):
        assert port.stats[key] == jax_decoder.stats[key], key
    assert port.stats["round_prefill_tokens_max"] == 64 + 16
    # an admit and an extend share these rounds: the two requests they
    # serve also match the dense-cache greedy decode (native f32 paged
    # decoding is exact against it)
    params, _ = weights
    for rid in ("s2", "l2"):
        prompt, max_new = requests[rid]
        oracle = jax.jit(functools.partial(
            JL.llama_greedy_decode, config=J_CONFIG, max_tokens=max_new))(
            params, prompt=jnp.asarray([prompt], jnp.int32))
        assert result[rid] == [int(t) for t in np.asarray(oracle)[0]], rid


def test_chunked_options_are_checked(weights):
    _, model = weights
    with pytest.raises(ValueError, match="prefill_chunk must be in"):
        ContinuousDecoder(model, T_CONFIG, paged_kv=True, device="cpu",
                          prefill_chunk=200, max_seq=96)
    with pytest.raises(ValueError, match="kv_cache_dtype must be"):
        ContinuousDecoder(model, T_CONFIG, paged_kv=True, device="cpu",
                          kv_cache_dtype="fp8")
    # int8 pools, chunked prefill and int8 weights compose
    # (tests/test_torch_decoder_variants.py holds their tokens against JAX)
    quantized = ContinuousDecoder(model, T_CONFIG, paged_kv=True,
                                  device="cpu", kv_cache_dtype="int8",
                                  prefill_chunk=16, weight_quant=True)
    assert quantized.weight_quant and quantized.kv_int8
    assert quantized.params["lm_head"]["w8"].dtype == torch.int8
    # speculation composes with int8 pools and chunked prefill
    # (tests/test_torch_speculative_paged.py holds its tokens against JAX)
    spec = ContinuousDecoder(model, T_CONFIG, paged_kv=True, device="cpu",
                             kv_cache_dtype="int8", prefill_chunk=16,
                             speculate_k=2)
    assert spec.speculate_k == 2 and spec._context is not None
    decoder = ContinuousDecoder(model, T_CONFIG, paged_kv=True,
                                device="cpu", prefill_chunk=16,
                                prefill_buckets=(16,), max_seq=96)
    decoder.submit("r", list(range(1, 120)), 2, lambda *_: None)
    assert len(decoder._pending[0].prompt) == 95      # max_seq - 1, tail


def test_host_arrays_go_to_the_device_in_one_copy():
    from aiko_services_tpu_torch.serving import _to_device
    tokens = np.arange(15, dtype=np.int32).reshape(3, 5)
    valid = np.array([True, False, True])
    tables = np.array([[4, 0], [7, 9]], np.int32)
    out = _to_device(torch.device("cpu"), tokens, valid, [2, 5, 6], tables)
    assert [t.dtype for t in out] == [torch.int32, torch.bool, torch.int32,
                                      torch.int32]
    for got, want in zip(out, (tokens, valid, [2, 5, 6], tables)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the copy is taken at the call: later writes to the host array
    # (reused scratch) do not reach it
    tables[0, 0] = 99
    assert int(out[3][0, 0]) == 4
