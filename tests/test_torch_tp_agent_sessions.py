"""PE_LlamaAgent with sessions and a host KV tier on four gloo ranks of
{data: 2, model: 2} against the JAX package's agent.

Each rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`agent_sessions`) runs its own pipeline, engine and ComputeRuntime over
the mesh, serving its shards of the tiny preset's JAX-seeded weights in
f32; the agent's decoder agrees its timed decisions in its round note.
The conversation (two streams, three turns each) runs with a two-block
device budget, so every finished turn's chain demotes to the host tier
as the next stream's harvest lands (tests/test_torch_tiered_agent.py's
lru_pressure case).  Then each rank's clock is settled past the session
lease: the proposed expiries make round notes on the idle decoders, which
apply rank 0's on every rank; and one more stream's frame is served.  The drive runs in lockstep and then
staggered (each rank posts each next turn at its own engine step, with
its engine and serving clocks offset by its own amount).

Tolerance, f32: every response equals the JAX agent's frame by frame
(tests/test_torch_agent.py's drive, one process); every rank plans every
round alike (plan digests), demotes, promotes, hits and releases the
same blocks and sessions, its hits and session releases JAX's; the byte
budgets are the model's over the KV heads' divisor, as JAX counts
them."""

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL

import torch_spmd_cases as cases
from test_torch_agent import CONTINUOUS, TEXTS, _converse
from torch_spmd import run_ranks

torch.set_num_threads(1)

LEASE = 30.0
PARAMETERS = {**CONTINUOUS, "sessions": True, "session_lease": LEASE,
              "host_kv_mb": 1, "prefix_cache_mb": 2 * 2048 / (1 << 20)}
MESH = {"data": 2, "model": 2}
SETTLE = LEASE + 1.0


@pytest.fixture(scope="module")
def reference():
    """The JAX agent's responses, and its counters after the lease
    settles and one more stream's frame is served."""
    responses, agent, pipeline, engine = _converse(
        "jax", PARAMETERS, TEXTS, settle=SETTLE)
    sessions_after_settle = len(agent._session_table)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s9", lease_time=0)
    pipeline.post("process_frame", "s9", {"text": "one more"})
    for _ in range(20000):
        if done:
            break
        engine.clock.advance(0.002)
        engine.step()
    responses[("s9", 0)] = [int(t) for t in done[0].swag["response_tokens"]]
    cache = agent.prefix_cache
    return {"responses": responses,
            "cache": {key: cache.stats[key] for key in (
                "demoted", "promoted", "hit_tokens", "session_handles",
                "session_released")},
            "sessions": (sessions_after_settle,
                         len(agent._session_table))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                JL.llama_init(jax.random.PRNGKey(0),
                              JL.LLAMA_PRESETS["tiny"]))}
    return run_ranks(cases.agent_sessions, 4,
                     tmp_path_factory.mktemp("agent4"), MESH, flat,
                     PARAMETERS, TEXTS, SETTLE, timeout=300.0)


STAGGERED = [False, True]
IDS = ["lockstep", "staggered_skewed"]


@pytest.mark.parametrize("staggered", STAGGERED, ids=IDS)
def test_four_ranks_answer_like_the_jax_agent(ranks, reference, staggered):
    for rank in ranks:
        assert rank[staggered]["responses"] == reference["responses"]


@pytest.mark.parametrize("staggered", STAGGERED, ids=IDS)
def test_every_rank_plans_and_demotes_alike(ranks, reference, staggered):
    """One plan digest sequence, and the same tier traffic, hits and
    session releases, on every rank; the conversation's chains demoted,
    and its demotions, hits, promotions and session handles are JAX's:
    the ranks kick a host-resident chain's promotion at the note that
    agrees its arrival and land it at the next one, before its admit, as
    JAX's agent lands the promotion its session touch kicked before the
    admit round (the landing demotes other blocks to make room)."""
    runs = [rank[staggered] for rank in ranks]
    assert runs[0]["plans"]
    for run in runs:
        assert run["plans"] == runs[0]["plans"]
        assert run["cache"] == runs[0]["cache"]
        for key in ("demoted", "promoted", "hit_tokens", "session_handles",
                    "session_released"):
            assert run["cache"][key] == reference["cache"][key], key
    assert runs[0]["cache"]["demoted"] > 0
    assert runs[0]["cache"]["hit_tokens"] > 0


@pytest.mark.parametrize("staggered", STAGGERED, ids=IDS)
def test_lease_expiries_ride_rank_0s_note(ranks, reference, staggered):
    """The leases lapse by rank 0's clock while the decoder is idle: the
    pending expiries make a round note, which releases both sessions'
    pins on every rank, as JAX's table released them at the lapse.  No
    session is left after the settle, and one (the new stream's) after
    its frame; the same handles and releases."""
    for rank in ranks:
        run = rank[staggered]
        assert reference["sessions"] == (0, 1)
        assert run["sessions"] == reference["sessions"]
        for key in ("session_handles", "session_released"):
            assert run["cache"][key] == reference["cache"][key], key


def test_budgets_are_the_models_bytes_over_the_kv_heads(ranks):
    """host_kv_mb and prefix_cache_mb count the model's KV bytes (JAX's
    accounting): each rank holds one of the two KV heads, so its budgets
    are half."""
    for rank in ranks:
        run = rank[False]
        assert run["host_max"] == (1 << 20) // 2
        assert run["cache_max"] == int(PARAMETERS["prefix_cache_mb"] *
                                       (1 << 20)) // 2
