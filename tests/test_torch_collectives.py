"""The port's collectives over four gloo ranks against the JAX package's
inside shard_map on four virtual CPU devices.

Rank (device) r holds x[r] of a seeded [4, 4, 8] f32 array; each
collective's per-rank result must equal JAX's per-device result exactly
for the data movers (all_gather, ppermute_ring, axis_index, axis_size)
and within 1e-6 for the reductions (f32 sums in other orders).  Over the
{data: 2, model: 2} mesh, psum over model and ppermute_ring over data
check that a collective stays inside its axis.  One spawn of four ranks
serves the file (tests/torch_spmd.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.parallel import collectives as JC

import torch_spmd_cases as cases
from torch_spmd import run_ranks

X = np.random.default_rng(0).standard_normal((4, 4, 8)).astype(np.float32)
Y = np.random.default_rng(1).standard_normal((4, 3, 2)).astype(np.float32)
EXACT = ("all_gather", "all_gather_axis1", "all_gather_stacked", "ring",
         "ring_reverse", "index", "size", "pmax", "data_ring")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(cases.collectives, 4,
                     tmp_path_factory.mktemp("collectives"), X, Y)


def _per_device(body, mesh, spec, data):
    """body(local) on each device of a 1-D or 2-D shard_map; returns the
    per-device results stacked on axis 0 (device order)."""
    fn = JC.shard_map(lambda x: body(x[0])[None], mesh=mesh,
                      in_specs=(spec,), out_specs=spec)
    out = jax.jit(fn)(data)
    return np.asarray(out)


@pytest.fixture(scope="module")
def reference():
    mesh = JP.create_mesh({"x": 4}, devices=jax.devices()[:4])
    spec = P("x")
    bodies = {
        "psum": lambda x: JC.psum(x, "x"),
        "pmean": lambda x: JC.pmean(x, "x"),
        "pmax": lambda x: JC.pmax(x, "x"),
        "all_gather": lambda x: JC.all_gather(x, "x"),
        "all_gather_axis1": lambda x: JC.all_gather(x, "x", axis=1),
        "all_gather_stacked": lambda x: JC.all_gather(x, "x", tiled=False),
        "reduce_scatter": lambda x: JC.reduce_scatter(x, "x"),
        "reduce_scatter_axis1": lambda x: JC.reduce_scatter(x, "x", axis=1),
        "ring": lambda x: JC.ppermute_ring(x, "x", 4),
        "ring_reverse": lambda x: JC.ppermute_ring(x, "x", 4, reverse=True),
        "index": lambda x: JC.axis_index("x") + jnp.zeros((), jnp.int32),
        "size": lambda x: JC.axis_size("x") + jnp.zeros((), jnp.int32),
    }
    out = {name: _per_device(body, mesh, spec, X)
           for name, body in bodies.items()}
    grid = JP.create_mesh({"data": 2, "model": 2},
                          devices=jax.devices()[:4])
    y = Y.reshape(2, 2, 3, 2)
    spec2 = P("data", "model")

    def two_d(body):
        fn = JC.shard_map(lambda v: body(v[0, 0])[None, None], mesh=grid,
                          in_specs=(spec2,), out_specs=spec2)
        return np.asarray(jax.jit(fn)(y)).reshape(4, *Y.shape[1:])
    out["model_psum"] = two_d(lambda v: JC.psum(v, "model"))
    out["data_ring"] = two_d(lambda v: JC.ppermute_ring(v, "data", 2))
    return out


@pytest.mark.parametrize("name", [
    "psum", "pmean", "pmax", "all_gather", "all_gather_axis1",
    "all_gather_stacked", "reduce_scatter", "reduce_scatter_axis1", "ring",
    "ring_reverse", "index", "size", "model_psum", "data_ring"])
def test_collective_matches_shard_map(ranks, reference, name):
    for rank, result in enumerate(ranks):
        got, want = result[name], reference[name][rank]
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        if name in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ring_neighbours_match_jax():
    from aiko_services_tpu_torch.parallel import ring_neighbours
    for n in (1, 2, 4):
        for reverse in (False, True):
            assert ring_neighbours(n, reverse) == \
                JC.ring_neighbours(n, reverse)
