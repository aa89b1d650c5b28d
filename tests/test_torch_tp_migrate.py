"""A session migration destination sharded over a mesh: SessionMigrator
on a paged decoder's prefix cache whose ranks each hold their KV heads,
over {model: 2}, {model: 4} and {data: 2, model: 2} gloo ranks, against
the JAX package's unsharded destination.

Each rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`sharded_destination`) builds the destination on its shards of the same
JAX-seeded weights (f32, blocks of 8, chunks of 2 blocks).  The source
is unsharded on rank 0 alone, or sharded over the same mesh: it serves
two turns of two sessions, pins their histories and migrates them; the
destination's lead (rank 0) receives every envelope and hands it to the
other ranks, and each rank's decoder's round note applies the offer,
each chunk's install of the rank's KV heads and the landing in the same
round on every rank.  Then turn 3 of each session on the destination.
Also: the other ranks' links polled late (staggered), a destination
whose host tier holds the chains (promoted at the offer), a destination
table at its session budget (shed) and a source that never ships after
the ack (the destination's transfer expires).

The JAX reference runs the same two turns on a JAX side (a dense
decoder, JAX's default, a prefix cache of 8-token blocks), migrates to
an unsharded JAX destination and serves turn 3 there.

Tolerance, f32: turns 1 and 2 equal JAX's tokens; turn 3's tokens equal
JAX's destination's, a split counted a tie only where JAX's top-2 logit
gap at the first differing token is under 1e-4 (the row-parallel sums
add the ranks' partials in another order than one product does, ~1e-6);
each rank's installed KV heads are byte-equal to its slice of the
shipped whole blocks (an install copies bytes: nothing to tolerate)."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu import process as JPR
from aiko_services_tpu import serving as JS
from aiko_services_tpu import serving_disagg as JD
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.state import sessions as JSS
from aiko_services_tpu.transport import memory as JM

import torch_spmd_cases as cases
from torch_spmd import run_ranks

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], num_heads=8,
                               num_kv_heads=4)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4},
              "data2_model2": {"data": 2, "model": 2}}
ALL = tuple(GEOMETRIES)
CASES = {"plain": ALL, "sharded": ALL, "staggered": ALL,
         "tiered": ("model2",), "shed": ("model2",),
         "expiry": ("model2",)}
LANDING = ("plain", "sharded", "staggered", "tiered")
SESSIONS = ("s0", "s1")
TURNS = ([(i * 7) % 200 + 3 for i in range(20)],
         [(i * 11) % 190 + 5 for i in range(13)])
EXTRA = ([5, 9, 2], [7, 7])
MAX_NEW = 4
TIE = 1e-4
HEAD_DIM = J_CONFIG.dim // J_CONFIG.num_heads


@functools.cache
def jax_tree():
    return JL.llama_init(jax.random.PRNGKey(0), J_CONFIG)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world, names in ((2, ("model2",)), (4, ("model4", "data2_model2"))):
        results = run_ranks(
            cases.sharded_destination, world,
            tmp_path_factory.mktemp(f"migrate{world}"),
            {name: GEOMETRIES[name] for name in names}, _flat(jax_tree()),
            FIELDS, SESSIONS, TURNS, EXTRA, MAX_NEW,
            {case: tuple(name for name in geometries if name in names)
             for case, geometries in CASES.items()}, timeout=300.0)
        for key in results[0]:
            out[key] = [rank[key] for rank in results]
    return out


class _JaxSide:
    """One JAX serving side: a dense decoder, a prefix cache of 8-token
    blocks, a session table and a migrator, pumping flat-out."""

    def __init__(self, engine, broker, name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return JM.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain,
                client_id=name)
        self.rt = JPR.ProcessRuntime(name=name, engine=engine,
                                     transport_factory=factory).initialize()
        self.cache = JS.PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                                      name=name)
        self.decoder = JS.ContinuousDecoder(
            jax_tree(), J_CONFIG, prefix_cache=self.cache, max_slots=2,
            prefill_buckets=(64,), steps_per_sync=4, name=name)
        self.table = JSS.SessionTable(
            SimpleNamespace(runtime=self.rt, topic_path=self.rt.topic_path),
            num_shards=1)
        self.mig = JD.SessionMigrator(self.rt, self.cache, table=self.table,
                                      name=name, chunk_blocks=2,
                                      transfer_timeout=30.0)
        self.engine = engine
        engine.add_flatout_handler(self.decoder.pump)

    def turns(self, prompts) -> dict:
        done = {}
        for rid, prompt in prompts.items():
            assert self.decoder.submit(rid, prompt, MAX_NEW,
                                       lambda r, t: done.update({r: t}))
        assert self.engine.run_until(lambda: len(done) == len(prompts),
                                     timeout=120.0)
        return {rid: [int(t) for t in tokens]
                for rid, tokens in done.items()}

    def stop(self):
        self.mig.stop()
        self.table.stop()
        self.engine.remove_flatout_handler(self.decoder.pump)
        self.rt.terminate()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's two turns, migration and turn 3 at an
    unsharded destination, and the top-2 logit gaps of turn 3."""
    engine, broker = JE.EventEngine(), JM.MemoryBroker()
    a = _JaxSide(engine, broker, "tpm_a")
    b = _JaxSide(engine, broker, "tpm_b")
    try:
        first = a.turns(dict(zip(SESSIONS, TURNS)))
        second = a.turns({sid: TURNS[i] + first[sid] + EXTRA[i]
                          for i, sid in enumerate(SESSIONS)})
        histories = {sid: TURNS[i] + first[sid] + EXTRA[i] + second[sid]
                     for i, sid in enumerate(SESSIONS)}
        for sid, history in histories.items():
            leaf, kv_tokens = a.cache.session_store("default", sid, history)
            assert a.table.create("default", sid, {
                "history": history, "kv": leaf or "",
                "kv_tokens": kv_tokens})
        done = []
        assert a.mig.migrate(b.mig.topic, on_done=done.append) == 2
        assert engine.run_until(lambda: bool(done), timeout=60.0)
        prompts = {sid: history + EXTRA[i]
                   for i, (sid, history) in enumerate(histories.items())}
        third = b.turns(prompts)
        dest = {name: b.mig.stats[name] for name in (
            "received", "installed_blocks", "landed", "refused", "expired",
            "dropped_chunks", "corrupt")}
    finally:
        a.stop()
        b.stop()
    gaps = {}
    for sid, prompt in prompts.items():
        logits = np.asarray(JL.llama_forward(
            jax_tree(), J_CONFIG,
            jnp.asarray([prompt + third[sid]], jnp.int32)))[0]
        top = np.sort(logits[len(prompt) - 1:-1], axis=-1)
        gaps[sid] = (top[:, -1] - top[:, -2]).tolist()
    return {"first": first, "second": second, "histories": histories,
            "third": third, "gaps": gaps, "dest": dest}


def _runs(ranks, case):
    return [(name, ranks[(name, case)]) for name in CASES[case]]


def _equal_or_tie(got, want, gaps) -> bool:
    """Equal tokens, or a split at a JAX top-2 gap under TIE."""
    if got == want:
        return True
    split = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    return gaps[split] < TIE


@pytest.mark.parametrize("case", ["plain", "sharded"])
def test_the_source_turns_are_jax_s(ranks, reference, case):
    for _, run in _runs(ranks, case):
        turns = run[0]["turns"]
        assert turns["first"] == reference["first"]
        assert turns["second"] == reference["second"]
        assert run[0]["histories"] == reference["histories"]


@pytest.mark.parametrize("case", LANDING)
def test_turn_three_at_a_sharded_destination_gives_jax_s_tokens(
        ranks, reference, case):
    for name, run in _runs(ranks, case):
        for rank in run:
            assert rank["migrated"], (name, case)
            for sid, tokens in rank["third"].items():
                assert _equal_or_tie(tokens, reference["third"][sid],
                                     reference["gaps"][sid]), (name, sid)
            assert rank["third"] == run[0]["third"]


@pytest.mark.parametrize("case", ["plain", "sharded", "staggered"])
def test_every_rank_lands_the_sessions_as_jax_s_destination(
        ranks, reference, case):
    """The destination's counters equal JAX's on every rank; each
    session is pinned and recorded there, and turn 3 is a prefix hit of
    every pinned chain; the source lets go of its sessions."""
    for name, run in _runs(ranks, case):
        pinned = sum(run[0]["turns"]["pinned"].values())
        for rank in run:
            assert rank["dest"] == reference["dest"], (name, case)
            assert rank["dest_sessions"] == [("default", sid)
                                             for sid in SESSIONS]
            assert rank["records"] == len(SESSIONS) and \
                rank["pending"] == 0
            assert rank["prefix_admits"] == len(SESSIONS)
            assert rank["hit_tokens"] == pinned
        assert run[0]["source"]["migrated"] == len(SESSIONS)
        assert run[0]["source_sessions"] == 0


@pytest.mark.parametrize("case", ["plain", "sharded", "staggered"])
def test_each_rank_installs_its_slice_of_the_shipped_blocks(ranks, case):
    """Byte for byte: a rank's installed K and V of each block are its
    KV heads of the whole block the lead received."""
    for name, run in _runs(ranks, case):
        histories = run[0]["histories"]
        shipped = {}
        for tokens, start, blocks, _ in run[0]["ships"]:
            sid = next(sid for sid, history in histories.items()
                       if history[:len(tokens)] == tokens)
            for index, block in enumerate(blocks):
                shipped[(sid, start + index)] = block
        assert shipped
        for rank in run:
            first, stop, total = rank["kv_heads"]
            for sid, rows in rank["rows"].items():
                for index, block in enumerate(rows):
                    whole = shipped[(sid, index)]
                    for (k, v), (k_whole, v_whole) in zip(block, whole):
                        for got, leaf in ((k, k_whole), (v, v_whole)):
                            heads = np.frombuffer(leaf, np.float32) \
                                .reshape(total, 8, HEAD_DIM)
                            assert got == heads[first:stop].tobytes(), \
                                (name, case, sid, index)


@pytest.mark.parametrize("case", LANDING)
def test_the_ranks_plan_alike_and_only_the_lead_replies(ranks, case):
    """Every rank's destination decoder runs the same round plans, with
    the lead's envelopes reaching the other ranks late too; only the
    lead acks and sends done, and only its source offers."""
    from aiko_services_tpu_torch.transport import wire

    for name, run in _runs(ranks, case):
        assert run[0]["plans"]
        for rank in run[1:]:
            assert rank["plans"] == run[0]["plans"], (name, case)
            assert rank["replies"] == [] and rank["offers"] == 0
        assert sorted(run[0]["replies"]) == sorted(
            [wire.KV_MIGRATE_ACK_COMMAND, wire.KV_MIGRATE_DONE_COMMAND] *
            len(SESSIONS))
        assert run[0]["offers"] == len(SESSIONS)


def test_a_tiered_destination_promotes_at_the_offer(ranks):
    """The destination's host tier holds the chains: the offer's note
    promotes them on every rank, the ack marks them resident, and every
    block crosses as a handle."""
    run = ranks[("model2", "tiered")]
    blocks = sum(run[0]["turns"]["pinned"].values()) // 8
    for rank in run:
        assert rank["demoted"] >= blocks
        assert rank["promoted"] == blocks
        assert rank["dest"]["installed_blocks"] == 0
        assert rank["dest"]["landed"] == len(SESSIONS)
        assert rank["prefix_admits"] == len(SESSIONS)
    assert run[0]["source"]["handle_blocks"] == blocks
    assert run[0]["source"]["shipped_blocks"] == 0


def test_a_shed_destination_withholds_done_on_every_rank(ranks):
    """The destination table is at its session budget: every rank's
    landing sheds at the same note and releases its pin, no rank sends
    done, and the source's timeout keeps the sessions there."""
    run = ranks[("model2", "shed")]
    for rank in run:
        assert rank["migrated"]
        assert rank["dest"]["refused"] == len(SESSIONS)
        assert rank["dest"]["landed"] == 0
        assert rank["dest_sessions"] == [] and rank["records"] == 1
        assert rank["pending"] == 0
    from aiko_services_tpu_torch.transport import wire
    assert run[0]["replies"] == [wire.KV_MIGRATE_ACK_COMMAND] * \
        len(SESSIONS)
    assert run[0]["source"]["expired"] == len(SESSIONS)
    assert run[0]["source"]["migrated"] == 0
    assert run[0]["source_sessions"] == len(SESSIONS)


def test_an_unanswered_transfer_expires_alike_on_every_rank(ranks):
    """The source never ships after the ack: the lead's timer expires
    each inbound transfer, and every rank drops it at the same note;
    nothing lands and nothing is pinned."""
    run = ranks[("model2", "expiry")]
    for rank in run:
        assert rank["migrated"]
        assert rank["dest"]["expired"] == len(SESSIONS)
        assert rank["dest"]["received"] == len(SESSIONS)
        assert rank["dest"]["landed"] == 0
        assert rank["dest_sessions"] == [] and rank["pending"] == 0
    assert run[0]["source"]["expired"] == len(SESSIONS)
    assert run[0]["source_sessions"] == len(SESSIONS)


def test_a_mesh_destination_needs_its_decoder():
    """A migrator on a cache bound on a mesh must be handed the decoder
    whose round note lands its sessions."""
    from aiko_services_tpu_torch.serving import PrefixKVCache
    from aiko_services_tpu_torch.serving_disagg import SessionMigrator

    cache = PrefixKVCache(block_tokens=8)
    cache.bind((2, 2, 8, "torch.float32", False, 8, 4), paged=True,
               agreed=True)
    with pytest.raises(ValueError, match="decoder="):
        SessionMigrator(SimpleNamespace(topic_path="x"), cache)
