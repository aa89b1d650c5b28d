"""PE_LlamaAgent in batched mode, its default, on gloo ranks over
{model: 2}, {model: 4} and {data: 2, model: 2}, against the JAX
package's unsharded batched agent.

Each rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`agent_batched`) runs its own pipeline, engine and ComputeRuntime over
the mesh and serves its shards of the JAX-seeded weights in f32 through
llama_greedy_decode, whose row-parallel sums pair up across the ranks
only when every rank runs the same batch.  The runtime agrees each batch
cut (ops/batching.py, compute.py): rank 0 decides by its clock which
items, named by stream and per-stream sequence, form the next batch, and
every rank runs the items of that cut that every rank holds.  The
conversation runs in lockstep, then staggered (each rank posts each next
turn 3 * rank engine steps late, its engine clock 250 s a rank apart),
then in sync mode (each frame's item run at once, as off a mesh).
Llama-tiny's two KV heads do not divide over four ranks, so the preset
here has 8 heads and 4 KV heads (tests/test_torch_tp_serving.py).

Tolerance, f32: every response equals the JAX agent's frame by frame;
every rank runs the same batches in the same order."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL

import torch_spmd_cases as cases
from test_torch_agent import _converse
from torch_spmd import run_ranks

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], num_heads=8,
                               num_kv_heads=4)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
PARAMETERS = {"mode": "batched", "max_batch": 4, "max_wait": 0.01}
TEXTS = {f"s{i}": [f"question {i} about stream {i}", "more", "and why"]
         for i in range(3)}
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4},
              "data2_model2": {"data": 2, "model": 2}}
DRIVES = [False, True]
IDS = ["lockstep", "staggered_skewed"]


@functools.cache
def jax_tree():
    return JL.llama_init(jax.random.PRNGKey(0), J_CONFIG)


@pytest.fixture(scope="module")
def reference():
    """The JAX agent's batched responses on one device."""
    saved = JL.LLAMA_PRESETS["tiny"]
    JL.LLAMA_PRESETS["tiny"] = J_CONFIG
    try:
        responses, *_ = _converse("jax", PARAMETERS, TEXTS)
    finally:
        JL.LLAMA_PRESETS["tiny"] = saved
    return responses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_tree())}
    out = {}
    for world, names in ((2, ("model2",)), (4, ("model4", "data2_model2"))):
        results = run_ranks(
            cases.agent_batched, world,
            tmp_path_factory.mktemp(f"batched{world}"),
            {name: GEOMETRIES[name] for name in names}, flat, FIELDS,
            PARAMETERS, TEXTS, timeout=240.0)
        for name in names:
            out[name] = [{staggered: rank[(name, staggered)]
                          for staggered in DRIVES + ["sync"]}
                         for rank in results]
    return out


@pytest.mark.parametrize("staggered", DRIVES, ids=IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_batched_agent_on_a_mesh_answers_like_jax(ranks, reference,
                                                  geometry, staggered):
    for rank in ranks[geometry]:
        run = rank[staggered]
        assert run["agreed"]
        assert run["responses"] == reference
        assert all(len(tokens) == 6 for tokens in run["responses"].values())


@pytest.mark.parametrize("staggered", DRIVES, ids=IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_every_rank_runs_the_same_batches(ranks, geometry, staggered):
    """One batch sequence on every rank, covering every turn once; the
    lockstep drive batches the three streams' turns together."""
    runs = [rank[staggered] for rank in ranks[geometry]]
    batches = runs[0]["batches"]
    assert sum(len(batch) for batch in batches) == \
        sum(len(turns) for turns in TEXTS.values())
    for run in runs:
        assert run["batches"] == batches
    if not staggered:
        assert max(len(batch) for batch in batches) == len(TEXTS)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sync_mode_on_a_mesh_answers_like_jax(ranks, reference, geometry):
    """mode sync runs each frame's item at once (a forced drain, no cut
    to agree): every rank answers as the JAX batched agent, one batch a
    turn."""
    for rank in ranks[geometry]:
        run = rank["sync"]
        assert run["responses"] == reference
        assert [len(batch) for batch in run["batches"]] == \
            [1] * sum(len(turns) for turns in TEXTS.values())


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_each_rank_serves_its_vocab_shard(ranks, geometry):
    shards = GEOMETRIES[geometry]["model"]
    for rank in ranks[geometry]:
        assert rank[False]["vocab_shard"][1] == J_CONFIG.vocab // shards
