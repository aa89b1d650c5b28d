"""The port's paged ContinuousDecoder against the JAX package's, on the
same weights: the JAX decoder runs paged_kv=True with its decode
attention latched to the Pallas paged kernel (interpret mode on the CPU,
latched as tests/test_paged_kv.py latches it), the port's runs the
kernel's plain version.  Greedy tokens must be identical (tiny preset,
f32) over mid-stream admits, block sizes 8 and 16, an EOS retire inside a
round, admit pad rows and more requests than slots; afterwards the pool
holds no live block."""

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


def both(weights, requests, midstream=None, **kwargs):
    """(JAX paged-kernel decoder's tokens, the port decoder's tokens,
    the port decoder)."""
    params, model = weights
    kwargs = {"max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4, "paged_kv": True, **kwargs}
    before = JS.ATTENTION_IMPL
    JS.ATTENTION_IMPL = "paged_kernel"
    try:
        jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    assert jax_decoder.paged_kernel
    port = ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    return (run(jax_decoder, requests, midstream),
            run(port, requests, midstream), port)


@pytest.mark.parametrize("block", [8, 16])
def test_tokens_match_jax_with_a_midstream_admit(weights, block):
    launches = dict(TPA.launches)
    expected, result, port = both(weights, REQUESTS, MIDSTREAM,
                                  kv_block=block)
    assert result == expected
    params, _ = weights
    oracle = jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=10))(
        params, prompt=jnp.asarray([PROMPT], jnp.int32))
    assert result["a"] == [int(t) for t in np.asarray(oracle)[0]]
    assert port.pool.used_blocks() == 0               # drain audit
    assert TPA.launches == launches                   # no kernel on the CPU
    assert port.stats["completed"] == 3 and port.idle


def test_eos_retire_inside_a_round(weights):
    # a slot retiring mid-round (EOS) must release its blocks and not
    # corrupt its neighbours' tables
    requests = {"a": (PROMPT, 30), "b": (PROMPT[:11], 30)}
    expected, result, port = both(weights, requests, eos_token=3,
                                  kv_block=8)
    assert result == expected
    assert port.pool.used_blocks() == 0


def test_pad_rows_and_more_requests_than_slots(weights):
    """Three first admits fill a width-4 group (one pad row), then five
    more requests queue behind four slots."""
    first = {"a": (PROMPT[:30], 7), "b": (PROMPT[:5], 12),
             "c": (PROMPT[3:20], 3)}
    later = {f"m{i}": (PROMPT[i:i + 8 + 3 * i], 4 + i) for i in range(5)}
    expected, result, port = both(weights, first, later, kv_block=8)
    assert result == expected
    assert port.pool.used_blocks() == 0
    assert port.stats["prefills"] == 8
