"""Meshes and sharding rules on the port against the JAX package.

MeshSpec, best_mesh_shape, the rules table and named_sharding's spec
cleaning are held against JAX's in one process; the placements of
Whisper-tiny's and Llama-tiny's parameters (and the tiny MoE's experts)
on {data: 2, model: 2} run on four gloo ranks (tests/torch_spmd.py, one
spawn for the file) and are held against the NamedSharding specs JAX's
shard_pytree gives on its virtual CPU devices (tests/conftest.py), leaf
for leaf: the port's
spec is the mesh axis sharding each tensor dimension, JAX's PartitionSpec
padded with None to the leaf's rank.  The same ranks check the
ComputeRuntime's placement on that mesh (sharded parameters equal to the
unsharded ones when gathered; the runtime's own placement giving each
rank its shards as plain tensors, the DTensors' local tensors; a
placement without axes replicating; programs registered and run on the
mesh), the fabric report, resharding and the collective byte
estimates."""

import functools

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.models import moe as JM
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu_torch import parallel as TP
from aiko_services_tpu_torch.parallel import sharding as TS

import torch_spmd_cases as cases
from torch_spmd import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(cases.placements, 4,
                     tmp_path_factory.mktemp("mesh_sharding"))


def _jax_specs(params, axes, mesh_axes):
    """{dotted leaf path: the PartitionSpec JAX's shard_pytree gives the
    leaf (its named_sharding, or replicated), padded with None}.  The
    specs are taken from the shardings without placing the arrays: JAX
    refuses an uneven split (Whisper's 51,865-row vocabulary over two),
    where DTensor splits it unevenly."""
    mesh = JP.create_mesh(mesh_axes, devices=jax.devices()[:4])

    def spec(leaf, leaf_axes):
        sharding = JP.replicated(mesh) if leaf_axes is None else \
            JP.named_sharding(mesh, *leaf_axes)
        spec = tuple(sharding.spec)
        return spec + (None,) * (np.ndim(leaf) - len(spec))
    specs = jax.tree.map(spec, params, axes, is_leaf=lambda x: x is None)
    return {".".join(str(getattr(key, "key", getattr(key, "idx", key)))
                     for key in path): value
            for path, value in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, tuple))}


def test_mesh_spec_resolve_and_its_errors_match_jax():
    for axes, count in (({"data": -1, "model": 2}, 8),
                        ({"data": 1, "model": 4}, 4), ({"seq": 1}, 1),
                        ({"data": 2, "seq": 1, "model": 2}, 4)):
        assert TP.MeshSpec(axes).resolve(count) == \
            JP.MeshSpec(axes).resolve(count)
    for axes, count in (({"data": 3, "model": 2}, 8),
                        ({"data": -1, "model": -1}, 8),
                        ({"data": -1, "model": 3}, 8),
                        ({"model": 2}, 1)):
        with pytest.raises(ValueError) as port_error:
            TP.MeshSpec(axes).resolve(count)
        with pytest.raises(ValueError) as jax_error:
            JP.MeshSpec(axes).resolve(count)
        assert str(port_error.value) == str(jax_error.value)


def test_best_mesh_shape_and_the_rules_table_match_jax():
    assert TP.best_mesh_shape(8, model_parallel=4) == \
        JP.best_mesh_shape(8, model_parallel=4)
    with pytest.raises(ValueError):
        TP.best_mesh_shape(8, model_parallel=3)
    assert TP.DEFAULT_RULES.rules == JP.DEFAULT_RULES.rules
    assert (TP.AXIS_DATA, TP.AXIS_MODEL, TP.AXIS_SEQUENCE, TP.AXIS_EXPERT,
            TP.AXIS_STAGE) == (JP.AXIS_DATA, JP.AXIS_MODEL,
                               JP.AXIS_SEQUENCE, JP.AXIS_EXPERT,
                               JP.AXIS_STAGE)
    overridden = TP.DEFAULT_RULES.with_overrides(embed="model")
    assert overridden.spec("batch", "embed") == tuple(
        JP.DEFAULT_RULES.with_overrides(embed="model").spec("batch",
                                                            "embed"))
    assert TP.DEFAULT_RULES.rules["embed"] is None


def test_the_cpu_is_eight_logical_devices_as_in_the_jax_tests():
    assert len(TP.devices("cpu")) == len(jax.devices()) == 8
    assert TP.stage_device_groups(TP.devices("cpu"), 2) == \
        [[torch.device("cpu")] * 4] * 2


def test_a_mesh_of_one_places_plain_tensors_on_its_device():
    mesh = TP.single_device_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
    config = JL.LLAMA_PRESETS["tiny"]
    from aiko_services_tpu_torch.models import llama as TL
    model = TL.llama_init(torch.Generator().manual_seed(0),
                          TL.LlamaConfig(**vars(config)), device="cpu")
    TP.shard_pytree(model, TL.llama_axes(model.config), mesh)
    assert all(type(p.data) is torch.Tensor for p in model.parameters())
    x = torch.ones(4, 4)
    assert TP.constrain(x, mesh, "batch", "embed") is x
    assert config.num_layers == 2


def test_named_sharding_cleans_axes_the_mesh_lacks(ranks):
    mesh = JP.create_mesh({"data": 2, "model": 2},
                          devices=jax.devices()[:4])
    want = [tuple(JP.named_sharding(mesh, *axes).spec)
            for axes in (("batch", "embed"),
                         ("batch", "sequence", "heads"))]
    for result in ranks:
        assert result["named"] == want == [("data", None),
                                           ("data", None, "model")]


def test_whisper_tiny_placements_match_jax(ranks):
    config = JW.WHISPER_PRESETS["tiny"]
    params = jax.eval_shape(functools.partial(JW.whisper_init,
                                              config=config),
                            jax.random.PRNGKey(0))
    want = _jax_specs(params, JW.whisper_axes(config),
                      {"data": 2, "model": 2})
    for result in ranks:
        got = {name: spec for name, (spec, _) in result["whisper"].items()}
        assert got == want
    # the q projection's output (heads) and the vocabulary are split
    # over the model axis: each rank holds half
    spec, local = ranks[0]["whisper"]["enc_blocks.0.attn.q.w"]
    assert spec == (None, "model") and local == (384, 192)
    spec, local = ranks[0]["whisper"]["tok_embed.table"]
    assert spec == ("model", None) and local == (51865 // 2 + 1, 384)


def test_llama_tiny_placements_match_jax_and_gather_back(ranks):
    config = JL.LLAMA_PRESETS["tiny"]
    params = JL.llama_init(jax.random.PRNGKey(3), config)
    want = _jax_specs(params, JL.llama_axes(config),
                      {"data": 2, "model": 2})
    for result in ranks:
        got = {name: spec for name, (spec, _) in result["llama"].items()}
        assert got == want
        assert result["llama_gathered_equal"]
    assert ranks[0]["llama"]["layers.0.gate.w"][0] == (None, "model")
    assert ranks[0]["llama"]["layers.0.down.w"][0] == ("model", None)


def test_moe_experts_split_over_the_expert_axis(ranks):
    config = JL.LLAMA_PRESETS["tiny_moe"].moe_config()
    params = JM.moe_init(jax.random.PRNGKey(0), config)
    want = _jax_specs(params, JM.moe_axes(), {"data": 2, "expert": 2})
    for result in ranks:
        got = {name: spec for name, (spec, _) in result["moe"].items()}
        assert got == want
        assert result["moe"]["w_in"][1][0] == config.num_experts // 2
        assert result["moe_max_err"] < 1e-5


def test_compute_runtime_places_on_its_mesh_and_refuses_serving(ranks):
    """Sharded serving is ported: the runtime on a mesh of four places
    each rank's shards, replicates an axis-free tree and serves its
    programs (the name keeps the test's history: it asserted the
    refusal before)."""
    for rank, result in enumerate(ranks):
        assert result["llama_local_equal"]
        assert result["served"] == [True, True, True]
        assert result["share"] == ({"data": 2, "model": 2}, 4, "cpu")


def test_fabric_reshard_and_collective_bytes_match_jax(ranks):
    mesh = JP.create_mesh({"data": 2, "model": 2},
                          devices=jax.devices()[:4])
    from aiko_services_tpu.parallel.collectives import (
        collective_bytes, mesh_fabric_report)
    x = np.ones((8, 16), np.float32).astype(jax.numpy.bfloat16)
    want = [collective_bytes(x, "model", mesh, op)
            for op in ("all_gather", "reduce_scatter", "psum",
                       "ppermute")]
    for result in ranks:
        assert result["fabric"] == mesh_fabric_report(mesh)
        assert result["resharded"] == ("data", "model")
        assert result["bytes"] == want == [256, 128, 256, 256]
    with pytest.raises(ValueError):
        TS.placements(type("M", (), {"mesh_dim_names": ("model",)})(),
                      ("model", "model"))
