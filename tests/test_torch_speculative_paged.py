"""Self-speculative decoding on the port's paged decoder (the paged
kernel's plain version at W = 1 + k query rows a slot) against the JAX
package's, on the same weights (tiny preset, f32).

The matrix of tests/test_torch_speculative.py (speculate_k in {1, 2, 4},
speculate_ngram in {1, 2, 3}, accepted and rejected drafts, mid-stream
admits, an EOS inside a verify block) against JAX's speculative decoder
and the port's non-speculative run; then the paged compositions of
tests/test_paged_kv.py:146-158 and :193-222 against the JAX paged decoder
with its attention latched to the Pallas kernel (interpret mode, as
tests/test_paged_kv.py latches it): k = 2 and k = 4, block sizes 8, 32
and 64, int8 pools with chunked prefill and a mid-stream admit.  The
pool must hold no block afterwards."""

import pytest

import aiko_services_tpu.serving as JS
from aiko_services_tpu_torch.ops import paged_attention as TPA
from aiko_services_tpu_torch.serving import ContinuousDecoder

from test_torch_paged_chunked import fresh_table_scratch
from test_torch_speculative import (J_CONFIG, MATRIX, PROMPT, SPEC_STATS,
                                    T_CONFIG, check_against_jax, drive,
                                    weights)

FIRST = {"a": (PROMPT, 10), "b": (PROMPT[:17] + [3, 4], 8)}
LATER = {"mid": (PROMPT[:9] + [7], 6)}
# past the bucket of 64: chunked at prefill_chunk 16, the final chunk
# sliding back
LONG = {"long": ((PROMPT * 3)[:70], 8)}


@pytest.mark.parametrize("k,ngram", MATRIX)
def test_paged_speculation_matches_jax(k, ngram):
    check_against_jax(True, k, ngram)


def against_jax_kernel(block: int, later=None, first=FIRST, **kwargs):
    """(JAX paged-kernel decoder, the port's paged decoder) after both
    served `first` (and `later` after the second round)."""
    params, model = weights()
    kwargs = {"max_slots": 4, "prefill_buckets": (64,), "steps_per_sync": 4,
              "paged_kv": True, "kv_block": block, **kwargs}
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
    expected = drive(jax_decoder, first, later, at=2)
    assert drive(port, first, later, at=2) == expected
    assert TPA.launches == launches
    for key in SPEC_STATS:
        assert port.stats[key] == jax_decoder.stats[key], key
    assert port.pool.used_blocks() == 0
    return jax_decoder, port


@pytest.mark.parametrize("k,block", [(2, 8), (4, 8), (2, 32), (2, 64)])
def test_the_widened_verify_matches_the_jax_kernel(k, block):
    _, port = against_jax_kernel(block, LATER, speculate_k=k)
    assert port.stats["spec_proposed"] == k * port.stats["useful_steps"]


def test_int8_chunked_midstream_matches_the_jax_kernel():
    _, port = against_jax_kernel(8, LATER, FIRST | LONG, speculate_k=2,
                                 kv_cache_dtype="int8", prefill_chunk=16)
    assert port.kv_int8 and port.stats["prefill_chunks"] == 5


def test_no_table_headroom_with_speculation():
    """The speculative merge drops positions past the table instead of
    clamping them, so tables and the extent stop at max_seq."""
    _, model = weights()
    spec = ContinuousDecoder(model, T_CONFIG, device="cpu", paged_kv=True,
                             kv_block=8, speculate_k=2, steps_per_sync=4)
    plain = ContinuousDecoder(model, T_CONFIG, device="cpu", paged_kv=True,
                              kv_block=8, steps_per_sync=4)
    assert spec._table_blocks == J_CONFIG.max_seq_len // 8
    assert plain._table_blocks == (J_CONFIG.max_seq_len + 4) // 8 + 1
    spec._fit_caches(10 ** 6)
    plain._fit_caches(10 ** 6)
    assert spec._cache_t == J_CONFIG.max_seq_len
    assert plain._cache_t == J_CONFIG.max_seq_len + 4
