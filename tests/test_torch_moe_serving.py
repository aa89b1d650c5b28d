"""tiny_moe (the MoE Llama: 4 experts) served by the port's
ContinuousDecoder against the JAX package's, on the same weights, f32.

Capacity drops make a token depend on which rows share its FFN call, so
the two packages must hand every FFN call the same rows in the same
order: the decode step over all slots (idle ones included), the admits'
padded buckets, chunk extends and the speculative verify's S x (1 + k)
rows.  Greedy tokens are equal with no drops (top_k == num_experts: the
capacity covers every assignment) and with drops (top 2 of 4: drops
asserted), on the dense slot cache (paged_kv=False) and on the paged
pool against the JAX decoder with its attention latched to the Pallas
kernel (interpret mode, as tests/test_torch_speculative_paged.py
latches it), with a mid-stream admit, a chunked prompt, and once with
speculate_k 2.  No kernel launches on the CPU; the pool ends empty."""

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
from aiko_services_tpu_torch.models import moe as TM
from aiko_services_tpu_torch.ops import paged_attention as TPA
from aiko_services_tpu_torch.serving import ContinuousDecoder

from test_torch_paged_chunked import fresh_table_scratch
from test_torch_speculative import FIRST, LATER, PROMPT, drive

torch.set_num_threads(1)

LONG = {"long": ((PROMPT * 2)[:40], 6)}


@functools.lru_cache(maxsize=None)
def weights(top_k: int):
    jconfig = dataclasses.replace(JL.LLAMA_PRESETS["tiny_moe"],
                                  max_seq_len=96, top_k=top_k)
    config = TL.LlamaConfig(**{field.name: getattr(jconfig, field.name)
                               for field in dataclasses.fields(jconfig)})
    params = jax.jit(functools.partial(JL.llama_init, config=jconfig))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     config, device="cpu")
    return jconfig, config, params, model


def serve_both(top_k: int, paged: bool, first=FIRST, **kwargs):
    """(JAX tokens, port tokens, dropped assignments in the port's run,
    the port decoder)."""
    jconfig, config, params, model = weights(top_k)
    kwargs = {"max_slots": 4, "prefill_buckets": (16,), "steps_per_sync": 4,
              "paged_kv": paged, "kv_block": 8, **kwargs}
    before = JS.ATTENTION_IMPL
    if paged:
        JS.ATTENTION_IMPL = "paged_kernel"
    try:
        jax_decoder = JS.ContinuousDecoder(params, jconfig, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    if paged:
        assert jax_decoder.paged_kernel
        fresh_table_scratch(jax_decoder)
    expected = drive(jax_decoder, first, LATER)
    port = ContinuousDecoder(model, config, device="cpu", **kwargs)
    launches = dict(TPA.launches)
    TM.drop_counts = []
    try:
        got = drive(port, first, LATER)
        drops = sum(int(count) for count in TM.drop_counts)
    finally:
        TM.drop_counts = None
    assert TPA.launches == launches
    if paged:
        assert port.pool.used_blocks() == 0
    return expected, got, drops, port


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("top_k", [4, 2], ids=["no_drops", "drops"])
def test_tiny_moe_tokens_match_jax(top_k, paged):
    expected, got, drops, _ = serve_both(top_k, paged)
    assert got == expected
    assert (drops == 0) if top_k == 4 else (drops > 0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tiny_moe_chunked_prompt_matches_jax(paged):
    expected, got, drops, port = serve_both(
        2, paged, FIRST | LONG, prefill_chunk=8)
    assert got == expected and drops > 0
    assert port.stats["prefill_chunks"] > 0


def test_tiny_moe_speculative_matches_jax():
    expected, got, drops, port = serve_both(2, True, speculate_k=2)
    assert got == expected and drops > 0
    assert port.stats["spec_proposed"] > 0


@pytest.mark.parametrize("mode", ["batched", "continuous"])
def test_agent_serves_tiny_moe_like_jax(monkeypatch, mode):
    """PE_LlamaAgent at preset tiny_moe on both packages (the port
    element's llama_init returns the JAX element's PRNGKey(0) tree), in
    batched mode and continuous on the paged pool with a prefix cache:
    responses equal frame by frame."""
    from test_torch_agent import CONTINUOUS, TEXTS, _converse

    params = JL.llama_init(jax.random.PRNGKey(0),
                           JL.LLAMA_PRESETS["tiny_moe"])

    def bridged(generator, config, device=None):
        assert config.num_experts == 4
        return bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                        config, device="cpu")
    monkeypatch.setattr(TL, "llama_init", bridged)
    parameters = {"preset": "tiny_moe", **(
        CONTINUOUS if mode == "continuous" else
        {"mode": "batched", "max_batch": 4, "max_wait": 0.01})}
    port, *_ = _converse("torch", parameters, TEXTS)
    expected, *_ = _converse("jax", parameters, TEXTS)
    assert port == expected
