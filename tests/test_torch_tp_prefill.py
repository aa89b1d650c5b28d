"""A prefill side sharded over a mesh: PrefillRuntime and SessionMigrator
on a decoder and prefix cache whose ranks each hold their KV heads, over
{model: 2}, {model: 4} and {data: 2, model: 2} gloo ranks, against the
same side unsharded and the JAX package's greedy tokens.

Each rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`sharded_prefill`) runs a PrefillRuntime over its shards of the same
JAX-seeded weights (a dense decoder, prefix blocks of 8 tokens, chunks of
16, so long prompts stream chunk by chunk).  Rank 0's runtime is the
side's address: rank 0 alone also hosts the decode side (an unsharded
decoder whose PrefillClient sends each prompt there), hands each request
to the other ranks, and posts every envelope; the other ranks send it
their KV heads of each shipped block, which it joins into whole blocks.
Then a session whose chain the prefill side cached is pinned on every
rank and migrated by the sharded cache's SessionMigrator (rank 0
sending) to a fresh unsharded destination on rank 0.  Rank 0 repeats
both drives with the prefill side unsharded.

Tolerance, f32: every shipped block is byte-equal to the ranks' own KV
heads of it joined in model order (the lead's gather loses nothing),
and equal to the unsharded prefill side's block: layer 0 byte for byte
(no row-parallel sum precedes its K and V), every layer within 1e-5
(the o and down projections' sums over the model axis add the ranks'
partials in another order than one product does: measured 1.2e-6, so
whole-model bytes cannot match; envelope boundaries may fall at other
rounds, so blocks are compared by request and index).  The decode
side's responses equal JAX's llama_greedy_decode and the unsharded
side's; the migrated chain at the destination is byte-equal to the
source ranks' KV heads joined and within 1e-5 of the unsharded
source's; every rank computes every request and settles the
migration, and only rank 0 sends."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aiko_services_tpu.models import llama as JL

import torch_spmd_cases as cases
from torch_spmd import run_ranks

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], num_heads=8,
                               num_kv_heads=4)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4},
              "data2_model2": {"data": 2, "model": 2}}
PROMPTS = {"a": [(i * 7) % 200 + 3 for i in range(40)],
           "b": [(i * 11) % 190 + 5 for i in range(21)],
           "c": [(i * 5) % 180 + 1 for i in range(17)]}
MAX_NEW = 5
SESSION = PROMPTS["a"][:33]


@functools.cache
def jax_tree():
    return JL.llama_init(jax.random.PRNGKey(0), J_CONFIG)


def oracle(prompt):
    out = jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=MAX_NEW))(
        jax_tree(), prompt=jnp.asarray([prompt], jnp.int32))
    return [int(t) for t in np.asarray(out)[0]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_tree())}
    out = {}
    for world, names in ((2, ("model2",)), (4, ("model4", "data2_model2"))):
        results = run_ranks(
            cases.sharded_prefill, world,
            tmp_path_factory.mktemp(f"prefill{world}"),
            {name: GEOMETRIES[name] for name in names}, flat, FIELDS,
            PROMPTS, MAX_NEW, SESSION, timeout=300.0)
        for name in names:
            out[name] = [rank[name] for rank in results]
        out[f"unsharded{world}"] = results[0]["unsharded"]
    return out


def _unsharded(ranks, geometry):
    return ranks["unsharded2" if geometry == "model2" else "unsharded4"]


def _shipped(run) -> dict:
    """{(request, block index): [per layer (k, v) bytes]} of every block
    a run's envelopes carried."""
    out = {}
    for tokens, start, blocks, _ in \
            run["ships"][:run["prefill_envelopes"]]:
        rid = next(rid for rid, prompt in PROMPTS.items()
                   if prompt[:len(tokens)] == tokens)
        for index, block in enumerate(blocks):
            out[(rid, start + index)] = block
    return out


def _joined(group, rows_of):
    """Whole-block bytes: each rank of the lead's model group's rows
    (rows_of(rank) -> [per block [per layer (k, v)]]), in model order,
    joined along the head axis (bytes, the rows [H/n, B, D] being
    contiguous)."""
    parts = [rows_of(rank) for rank in group]
    return [[(b"".join(part[j][layer][0] for part in parts),
              b"".join(part[j][layer][1] for part in parts))
             for layer in range(len(parts[0][j]))]
            for j in range(len(parts[0]))]


def _lead_group(ranks, geometry):
    group = [rank for rank in ranks[geometry]
             if rank["model_index"] is not None]
    return sorted(group, key=lambda rank: rank["model_index"])


def _close(got, want):
    """(the largest |difference| of two blocks' f32 values, given as
    per layer (k, v) bytes, and whether layer 0 is byte-equal)."""
    worst = 0.0
    for (k, v), (k_want, v_want) in zip(got, want):
        for a, b in ((k, k_want), (v, v_want)):
            worst = max(worst, float(np.abs(
                np.frombuffer(a, np.float32) -
                np.frombuffer(b, np.float32)).max()))
    return worst, got[0] == want[0]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_lead_ships_whole_blocks_of_every_rank_s_kv_heads(
        ranks, geometry):
    """Each shipped block is, byte for byte, the ranks' own cached KV
    heads of it joined in model order, under the unsharded side's
    layout; only the lead encodes."""
    lead = ranks[geometry][0]
    shipped = _shipped(lead)
    assert lead["prefill_envelopes"] > len(PROMPTS)  # chunks stream
    group = _lead_group(ranks, geometry)
    assert len(group) == {"model2": 2, "model4": 4,
                          "data2_model2": 2}[geometry]
    for rid in PROMPTS:
        whole = _joined(group, lambda rank: rank["own_rows"][rid])
        assert whole
        for index, block in enumerate(whole):
            assert shipped[(rid, index)] == block
    for rank in ranks[geometry][1:]:
        assert rank["ships"] == []
    assert {ship[3] for ship in lead["ships"]} == \
        {ship[3] for ship in _unsharded(ranks, geometry)["ships"]}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_sharded_side_ships_the_unsharded_side_s_blocks(ranks,
                                                            geometry):
    """The same blocks as the unsharded prefill side: layer 0 byte for
    byte (no row-parallel sum precedes its K and V), every layer within
    1e-5 in f32 (the o and down projections' sums add the ranks'
    partials in another order: measured 1.2e-6)."""
    got = _shipped(ranks[geometry][0])
    want = _shipped(_unsharded(ranks, geometry))
    assert got.keys() == want.keys()
    for key, block in got.items():
        worst, first_equal = _close(block, want[key])
        assert first_equal and worst < 1e-5, (key, worst)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_decode_side_answers_with_jax_s_tokens(ranks, geometry):
    lead = ranks[geometry][0]
    assert lead["finished"]
    assert lead["responses"] == {rid: oracle(prompt)
                                 for rid, prompt in PROMPTS.items()}
    assert lead["client"]["transfers"] == len(PROMPTS)
    assert lead["client"]["installs"] == len(PROMPTS)
    assert lead["client"]["local_fallbacks"] == 0
    assert lead["responses"] == _unsharded(ranks, geometry)["responses"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_every_rank_computes_every_request_and_only_the_lead_posts(
        ranks, geometry):
    for index, rank in enumerate(ranks[geometry]):
        assert rank["finished"]
        stats = rank["prefill"]
        assert stats["requests"] == stats["computed"] == len(PROMPTS)
        assert stats["refused"] == 0
        assert stats["chunks_shipped"] == \
            ranks[geometry][0]["prefill"]["chunks_shipped"] > 0
        if index == 0:
            assert stats["envelopes"] == rank["prefill_envelopes"]
        else:
            assert stats["envelopes"] == 0


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_a_sharded_cache_migrates_a_session_as_whole_blocks(ranks,
                                                            geometry):
    """The session's chain lands at the unsharded destination as whole
    blocks, byte for byte the source ranks' KV heads joined, and as the
    unsharded source's within the shipped blocks' tolerance; every rank
    settles the migration (the lead's done leg), drops its pin and
    record, and only the lead offers."""
    want = _unsharded(ranks, geometry)
    assert want["landed"] == 1 and want["migrated_rows"]
    for index, rank in enumerate(ranks[geometry]):
        assert rank["migrated"] and not rank["pinned"]
        assert rank["source"]["migrated"] == 1
        assert rank["source"]["shipped_blocks"] == \
            want["source"]["shipped_blocks"] > 0
        assert rank["offers"] == (1 if index == 0 else 0)
    lead = ranks[geometry][0]
    assert lead["landed"] == 1 and lead["kv_tokens"] == want["kv_tokens"]
    group = _lead_group(ranks, geometry)
    assert lead["migrated_rows"] == _joined(
        group, lambda rank: rank["session_rows"])
    assert len(lead["migrated_rows"]) == len(want["migrated_rows"])
    for got, expected in zip(lead["migrated_rows"], want["migrated_rows"]):
        worst, first_equal = _close(got, expected)
        assert first_equal and worst < 1e-5, worst
