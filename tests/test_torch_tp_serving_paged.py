"""Tensor-parallel serving on the port's paged pool against the JAX
package's TP-sharded paged decoder: tests/test_torch_tp_serving.py's
drive (gloo ranks over {model: 2}, {model: 4}, {data: 2, model: 2}; JAX's
decoder over {data: 2, model: 4}; the same tolerance and tie rule) with
paged_kv, native and int8 pools (blocks of 8 positions).  Each rank's
BlockPool holds its KV heads, and the round programs launch the paged
kernel's plain version (the CPU) at the rank's head counts."""

import pytest

import test_torch_tp_serving as tp

VARIANTS = {"paged": {"paged_kv": True, "kv_block": 8},
            "paged_int8": {"paged_kv": True, "kv_block": 8,
                           "kv_cache_dtype": "int8"}}


@pytest.fixture(scope="module")
def reference():
    return tp.jax_tp_tokens(VARIANTS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tp.port_ranks(VARIANTS, tmp_path_factory)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("geometry", list(tp.GEOMETRIES))
def test_tp_ranks_serve_jax_tokens_from_the_pool(ranks, reference, geometry,
                                                 variant):
    tp.check_serving(ranks, reference, geometry, variant)


@pytest.mark.parametrize("geometry", list(tp.GEOMETRIES))
def test_tp_paged_ranks_plan_every_round_alike(ranks, geometry):
    """Block tables and free counts are in the digests: every rank
    allocated the same blocks in every round."""
    tp.check_lockstep(ranks, geometry, VARIANTS)


@pytest.mark.parametrize("geometry", list(tp.GEOMETRIES))
def test_tp_paged_ranks_agree_on_requests_submitted_at_other_rounds(
        ranks, reference, geometry):
    """Blocks are allocated, and the pool shrinks, at the same rounds on
    every rank when each was handed the requests at its own rounds."""
    tp.check_staggered(ranks, reference, geometry, VARIANTS)
