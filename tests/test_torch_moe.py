"""The port's mixture-of-experts FFN (models/moe.py) against the JAX
package's, on the same weights, and the MoE Llama layer's tree.

moe_forward at N = 3 x 7 token rows and at N = 40 rows of which 24 are
zero rows: equal router logits, so the stable top-k must pick experts 0
and 1 (as jax.lax.top_k does), and expert 0 and 1's queues overflow
their capacity (drops occur: asserted).  f32 outputs within 1e-6 x the
largest reference magnitude, bf16 outputs within one bf16 rounding
(2^-8) of the largest, aux_loss within 1e-6.  The MoE preset's
parameter tree (router without bias, w_in [E, D, F], w_out [E, F, D])
loads strictly from a JAX tree; tiny_moe's prefill logits equal JAX's
within 1e-5.  The decoders serve it in tests/test_torch_moe_serving.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.models import moe as JM
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.models import moe as TM

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 ** -8)}


@functools.lru_cache(maxsize=None)
def pair(dtype: str, num_experts: int = 4, top_k: int = 2):
    jdtype, tdtype, _ = DTYPES[dtype]
    config = JM.MoeConfig(dim=32, ffn_dim=64, num_experts=num_experts,
                          top_k=top_k, dtype=jdtype)
    params = jax.jit(functools.partial(JM.moe_init, config=config))(
        jax.random.PRNGKey(0))
    port = TM.MoeConfig(dim=32, ffn_dim=64, num_experts=num_experts,
                        top_k=top_k, dtype=tdtype)
    model = TM.MoE(port, device="cpu")
    bridge._overlay(model, bridge.flatten_tree(params), strict=True)
    return config, params, port, model


def rows(shape, zero_rows=0, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    x.reshape(-1, shape[-1])[:zero_rows] = 0.0
    return x


def run_both(dtype, x, num_experts=4, top_k=2):
    config, params, port, model = pair(dtype, num_experts, top_k)
    want_y, want_aux = jax.jit(lambda p, v: JM.moe_forward(p, config, v))(
        params, jnp.asarray(x).astype(config.dtype))
    TM.drop_counts = []
    try:
        got_y, got_aux = TM.moe_forward(model, port, torch.from_numpy(x).to(
            port.dtype))
        drops = sum(int(count) for count in TM.drop_counts)
    finally:
        TM.drop_counts = None
    assert got_y.dtype == port.dtype and got_aux.dtype == torch.float32
    return (np.asarray(want_y, np.float32), float(want_aux),
            got_y.float().numpy(), float(got_aux), drops)


def jax_drops(dtype, x):
    """Assignments past capacity in the JAX routing (its own arithmetic,
    recomputed on the host)."""
    config, params, _, _ = pair(dtype)
    tokens = jnp.asarray(x.reshape(-1, x.shape[-1]), jnp.float32)
    probs = jax.nn.softmax(tokens @ params["router"]["w"].astype(
        jnp.float32), axis=-1)
    _, experts = jax.lax.top_k(probs, config.top_k)
    n = tokens.shape[0]
    capacity = max(1, int(config.capacity_factor * n * config.top_k /
                          config.num_experts))
    counts = np.bincount(np.asarray(experts).reshape(-1),
                         minlength=config.num_experts)
    return int(np.maximum(counts - capacity, 0).sum()), np.asarray(experts)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,zero_rows", [((3, 7, 32), 0),
                                             ((2, 20, 32), 24)])
def test_moe_forward_matches_jax(dtype, shape, zero_rows):
    x = rows(shape, zero_rows)
    want_y, want_aux, got_y, got_aux, drops = run_both(dtype, x)
    tol = DTYPES[dtype][2]
    assert np.max(np.abs(got_y - want_y)) <= tol * np.max(np.abs(want_y))
    assert abs(got_aux - want_aux) <= 1e-6
    expected_drops, experts = jax_drops(dtype, x)
    assert drops == expected_drops
    if zero_rows:
        # equal logits: experts 0 and 1, in that order, as JAX picks
        assert (experts[:zero_rows] == [0, 1]).all()
        assert drops > 0
        # a dropped assignment contributes nothing: the last zero rows
        # overflow both queues and come out exactly 0
        assert np.all(got_y.reshape(-1, shape[-1])[:zero_rows] == 0.0)


def test_no_drops_when_every_expert_is_chosen():
    x = rows((2, 20, 32), 24)
    want_y, _, got_y, _, drops = run_both("float32", x, top_k=4)
    assert drops == 0
    assert np.max(np.abs(got_y - want_y)) <= 1e-6 * np.max(np.abs(want_y))


def test_tiny_moe_tree_and_prefill_logits_match_jax():
    jconfig = dataclasses.replace(JL.LLAMA_PRESETS["tiny_moe"],
                                  max_seq_len=64)
    config = TL.LlamaConfig(**{field.name: getattr(jconfig, field.name)
                               for field in dataclasses.fields(jconfig)})
    assert TL.LLAMA_PRESETS["tiny_moe"] == TL.LlamaConfig(**{
        field.name: getattr(JL.LLAMA_PRESETS["tiny_moe"], field.name)
        for field in dataclasses.fields(jconfig)})
    params = jax.jit(functools.partial(JL.llama_init, config=jconfig))(
        jax.random.PRNGKey(0))
    flat = bridge.flatten_tree(params)
    assert "layers/1/moe/w_in" in flat and "layers/1/gate/w" not in flat
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     config, device="cpu")
    assert tuple(model.layers[0].moe.w_out.shape) == (4, 128, 64)
    assert "b" not in model.layers[0].moe.router
    tokens = np.random.default_rng(1).integers(1, 256, (2, 24)).astype(
        np.int32)
    want = np.asarray(jax.jit(lambda p, t: JL.llama_forward(p, jconfig, t))(
        params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = TL.llama_forward(model, config,
                               torch.from_numpy(tokens)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_moe_init_draws_the_expert_tree():
    model = TL.llama_init(torch.Generator().manual_seed(0),
                          TL.LLAMA_PRESETS["tiny_moe"], device="cpu")
    moe = model.layers[0].moe
    assert tuple(moe.w_in.shape) == (4, 64, 128)
    assert abs(float(moe.w_in.std()) - 64 ** -0.5) < 0.01
    assert abs(float(moe.w_out.std()) - 128 ** -0.5) < 0.01
    assert not hasattr(model.layers[0], "gate")
