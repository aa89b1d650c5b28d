"""The port's sequence-parallel prefill against the JAX package's.

llama_forward_sp on four gloo ranks (one spawn, tests/torch_spmd.py) over
{seq: 4} and {data: 2, seq: 2}, Llama-tiny (JAX's seeded weights through
the bridge, f32), tokens [2, 64] from a seeded numpy generator (the
shape of tests/test_serving.py's SP test): each rank holds 16 (or 32)
tokens with RoPE offset by its place on the ring and attends through
ring_attention_sharded, causal.  The gathered logits equal JAX's
llama_forward_sp on four virtual CPU devices and the port's plain
llama_forward within 2e-4 (JAX's own limit for its SP test: the online
softmax sums blocks in another order), and the greedy next token at
every position agrees."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL

import torch_spmd_cases as cases
from torch_spmd import run_ranks

torch.set_num_threads(1)
J_CONFIG = JL.LLAMA_PRESETS["tiny"]
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
TOKENS = np.random.default_rng(0).integers(
    1, J_CONFIG.vocab, (2, 64)).astype(np.int32)
TOL = dict(rtol=2e-4, atol=2e-4)


@functools.cache
def _params():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(3))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    return params, flat


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, flat = _params()
    return run_ranks(cases.llama_sp, 4, tmp_path_factory.mktemp("sp"), flat,
                     FIELDS, TOKENS)


@pytest.mark.parametrize("axes", [{"seq": 4}, {"data": 2, "seq": 2}],
                         ids=["seq4", "data2_seq2"])
def test_sp_prefill_matches_jax_and_the_plain_forward(ranks, axes):
    params, flat = _params()
    mesh = JP.create_mesh(axes, devices=jax.devices()[:4])
    want = np.asarray(jax.jit(lambda p, t: JL.llama_forward_sp(
        p, J_CONFIG, t, mesh))(params, jnp.asarray(TOKENS)))
    model = bridge.params_from_numpy(flat, TL.LlamaConfig(**FIELDS),
                                     device="cpu")
    with torch.no_grad():
        plain = TL.llama_forward(model, model.config,
                                 torch.from_numpy(TOKENS)).numpy()
    for result in ranks:
        got = result[tuple(axes)]
        assert got.shape == (2, 64, J_CONFIG.vocab)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, plain, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), plain.argmax(-1))


def test_sp_prefill_on_a_mesh_of_one_is_the_plain_forward():
    _, flat = _params()
    from aiko_services_tpu_torch.parallel import create_mesh
    model = bridge.params_from_numpy(flat, TL.LlamaConfig(**FIELDS),
                                     device="cpu")
    tokens = torch.from_numpy(TOKENS)
    with torch.no_grad():
        got = TL.llama_forward_sp(model, model.config, tokens,
                                  create_mesh({"seq": 1}, device="cpu"))
        plain = TL.llama_forward(model, model.config, tokens)
    np.testing.assert_allclose(got.to_local().numpy(), plain.numpy(), **TOL)
