"""PE_LlamaAgent with `disagg: true` on gloo ranks over {model: 2},
{model: 4} and {data: 2, model: 2}, against the JAX package's
disaggregated agent and its colocated one.

Each rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`agent_disagg`) runs its own pipeline, engine and ComputeRuntime over the
mesh and serves its shards of the JAX-seeded weights in f32, with a
prefix cache (prefix_block 8, prefill_chunk 16).  Rank 0 alone hosts a
PrefillRuntime (unsharded: the prefill side serves whole blocks) and its
PrefillClient alone sends each request, once for the whole mesh; the
other ranks' clients send nothing.  Rank 0 decides every landing,
timeout, retry and fallback, and every rank applies it in the same round
note: each installs its KV heads of the shipped rows.  The prefill side
ships the JAX donor's block rows (recorded from the JAX run, replayed by
chain key), so each rank's installed slice can be held byte for byte
against that head slice of JAX's block.  The conversation runs in
lockstep, then staggered with skewed clocks; then with a prefill
candidate that never answers, where every transfer times out, retries
and falls back to local prefill; and without a prefix cache, the
shipped blocks landing straight in each rank's pool (submit's
kv_blocks).  A PrefillRuntime on a decoder sharded over the mesh, and a
SessionMigrator on its cache, are built beside it on every rank and
serve (tests/test_torch_tp_prefill.py drives such a side).

Tolerance, f32: every response equals the JAX disaggregated agent's and
the JAX colocated agent's; every rank plans every round alike (plan
digests), submits every request in the same round, and counts the same
installs and fallbacks; rank 0 alone sends transfers, one a request;
installed slices are byte-equal."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import compute as JC
from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu import process as JPR
from aiko_services_tpu import registrar as JR
from aiko_services_tpu import serving_disagg as JD
from aiko_services_tpu import share as JSH
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.transport import memory as JM

import torch_spmd_cases as cases
from test_torch_agent import _converse
from torch_spmd import run_ranks

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], num_heads=8,
                               num_kv_heads=4)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
COLOCATED = {"mode": "continuous", "max_batch": 2, "steps_per_sync": 2,
             "prefix_block": 8, "prefill_chunk": 16}
PARAMETERS = {**COLOCATED, "role": "decode", "disagg": True}
TIMEOUT = {**PARAMETERS, "disagg_timeout": 0.02, "disagg_retries": 1}
# no prefix cache: the paged decoder takes the shipped blocks straight
# into its pool (install_shipped_blocks, submit's kv_blocks), in blocks
# of 32 tokens (the element's kv_block without prefix_block)
CACHELESS = {"mode": "continuous", "max_batch": 2, "steps_per_sync": 2,
             "paged": True, "prefill_chunk": 16, "role": "decode",
             "disagg": True}
TEXTS = {"s0": ["hello there prefill pool, how is the queue",
                "a second turn that is a little longer than the first one"],
         "s1": ["what does the decode side hold now?",
                "why"]}
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4},
              "data2_model2": {"data": 2, "model": 2}}
# the turns long enough to ship a block (the others prefill locally,
# local_short, on every rank alike)
REMOTE = sum(len(text) >= 8 for turns in TEXTS.values() for text in turns)
REMOTE_CACHELESS = sum(len(text) >= 32 for turns in TEXTS.values()
                       for text in turns)
DRIVES = {"lockstep": 0, "staggered_skewed": 1}


@functools.cache
def jax_tree():
    return JL.llama_init(jax.random.PRNGKey(0), J_CONFIG)


def jax_disaggregated(parameters=PARAMETERS):
    """The JAX disaggregated agent's responses (with `parameters`) and
    the block rows its prefill runtime shipped, by chain key."""
    shipped = {}
    real = JD._chain_wire_blocks

    def recording(cache, keys):
        blocks = real(cache, keys)
        for key, block in zip(keys, blocks):
            shipped[key] = [(np.array(layer["k"]), np.array(layer["v"]))
                            for layer in block]
        return blocks

    engine = JE.EventEngine(JE.VirtualClock())
    broker = JM.MemoryBroker()

    def make_runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return JM.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        return JPR.ProcessRuntime(name=name, engine=engine,
                                  transport_factory=factory).initialize()

    JD._chain_wire_blocks = recording
    try:
        JR.Registrar(make_runtime("dz_reg"))
        engine.clock.advance(2.1)            # the primary's promotion
        for _ in range(300):
            engine.step()
        prefill = JD.PrefillRuntime(
            make_runtime("dz_prefill"), "dz_prefill", params=jax_tree(),
            config=J_CONFIG, block_tokens=parameters.get("prefix_block",
                                                         32),
            max_slots=2, prefill_buckets=(16,), prefill_chunk=16)
        host = make_runtime("dz_host")
        JC.ComputeRuntime(host, "compute")
        definition = JP.parse_pipeline_definition({
            "version": 0, "name": "p_dz", "runtime": "jax",
            "graph": ["(PE_LlamaAgent)"],
            "parameters": {f"PE_LlamaAgent.{k}": v for k, v in {
                "preset": "tiny", "max_tokens": 6, "prompt_length": 16,
                **parameters}.items()},
            "elements": [{
                "name": "PE_LlamaAgent", "input": [{"name": "text"}],
                "output": [{"name": "response"},
                           {"name": "response_tokens"}],
                "parameters": {}}]})
        pipeline = JP.Pipeline(host, definition,
                               services_cache=JSH.ServicesCache(host),
                               stream_lease_time=0)
        done = []
        pipeline.add_frame_handler(done.append)
        for stream_id in TEXTS:
            pipeline.create_stream(stream_id, lease_time=0)
        agent = next(node.element for node in pipeline.graph.nodes()
                     if node.name == "PE_LlamaAgent")
        for _ in range(400):
            engine.step()
        assert agent._prefill_client.loads, "prefill pool not found"
        responses = {}
        for stream_id, turns in TEXTS.items():
            for turn, text in enumerate(turns):
                pipeline.post("process_frame", stream_id, {"text": text})
                for _ in range(8000):
                    if len(done) > len(responses):
                        break
                    engine.clock.advance(0.002)
                    engine.step()
                frame = done[len(responses)]
                responses[(stream_id, turn)] = [
                    int(t) for t in frame.swag["response_tokens"]]
        stats = dict(agent._prefill_client.stats)
        pipeline.destroy_stream("s0")
        pipeline.destroy_stream("s1")
        pipeline.stop()
        prefill.stop()
    finally:
        JD._chain_wire_blocks = real
    assert stats["local_fallbacks"] == 0
    return responses, shipped


@pytest.fixture(scope="module")
def reference():
    saved = JL.LLAMA_PRESETS["tiny"]
    JL.LLAMA_PRESETS["tiny"] = J_CONFIG
    try:
        responses, shipped = jax_disaggregated()
        cacheless, shipped_32 = jax_disaggregated(CACHELESS)
        colocated, *_ = _converse("jax", COLOCATED, TEXTS)
    finally:
        JL.LLAMA_PRESETS["tiny"] = saved
    return {"responses": responses, "colocated": colocated,
            "cacheless": cacheless, "shipped": {**shipped, **shipped_32}}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_tree())}
    out = {}
    for world, names in ((2, ("model2",)), (4, ("model4", "data2_model2"))):
        results = run_ranks(
            cases.agent_disagg, world,
            tmp_path_factory.mktemp(f"disagg{world}"),
            {name: GEOMETRIES[name] for name in names}, flat, FIELDS,
            PARAMETERS, TEXTS, reference["shipped"], TIMEOUT, CACHELESS,
            timeout=240.0)
        for name in names:
            out[name] = [{key[1]: value for key, value in rank.items()
                          if key[0] == name} for rank in results]
    return out


@pytest.mark.parametrize("drive", list(DRIVES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_disagg_agent_on_a_mesh_answers_like_jax(ranks, reference,
                                                 geometry, drive):
    """JAX's disaggregated responses, which are its colocated ones; one
    transfer a request, sent by rank 0 alone, and no fallback."""
    assert reference["responses"] == reference["colocated"]
    for rank, run in enumerate(ranks[geometry]):
        got = run[DRIVES[drive]]
        assert got["responses"] == reference["responses"]
        assert got["client"]["transfers"] == (REMOTE if rank == 0 else 0)
        assert got["client"]["installs"] == REMOTE
        assert got["client"]["local_fallbacks"] == 0


@pytest.mark.parametrize("drive", list(DRIVES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_every_rank_lands_each_transfer_in_the_same_round(ranks, geometry,
                                                          drive):
    runs = [rank[DRIVES[drive]] for rank in ranks[geometry]]
    assert runs[0]["plans"]
    for run in runs:
        assert run["plans"] == runs[0]["plans"]
        assert run["submitted"] == runs[0]["submitted"]
        assert run["client"]["installed_blocks"] == \
            runs[0]["client"]["installed_blocks"] > 0
        assert run["prefix_admits"] == runs[0]["prefix_admits"] > 0


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_each_rank_installs_its_heads_of_jax_s_block_bytes(
        ranks, reference, geometry):
    for run in ranks[geometry]:
        first, stop = run["heads"]
        rows = run[0]["rows"]
        assert rows
        for key, layers in rows.items():
            want = reference["shipped"][key]
            for (k, v), (k_jax, v_jax) in zip(layers, want):
                assert k.tobytes() == k_jax[first:stop].tobytes()
                assert v.tobytes() == v_jax[first:stop].tobytes()


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_a_timed_out_transfer_falls_back_on_every_rank_in_one_round(
        ranks, reference, geometry):
    """Rank 0's candidate never answers: each transfer times out, is
    retried once and falls back to local prefill; every rank submits
    each fallback in the same round and answers like the colocated
    agent."""
    runs = [rank[2] for rank in ranks[geometry]]
    for rank, run in enumerate(runs):
        assert run["responses"] == reference["colocated"]
        assert run["client"]["local_fallbacks"] == REMOTE
        assert run["client"]["installs"] == 0
        assert run["client"]["transfer_timeouts"] == \
            (2 * REMOTE if rank == 0 else 0)
        assert run["submitted"] == runs[0]["submitted"]
        assert run["plans"] == runs[0]["plans"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_prefill_side_serves_a_sharded_decoder(ranks, geometry):
    """A PrefillRuntime handed a decoder sharded over the agent's mesh,
    and a SessionMigrator on its prefix cache, are built on every rank
    and serve through their link to the lead (whole blocks gathered from
    every rank's KV heads: tests/test_torch_tp_prefill.py drives them);
    neither refuses."""
    for run in ranks[geometry]:
        side = run["prefill_side"]
        for name in ("prefill", "migrate"):
            assert side[name] is None
            assert side[f"{name}_linked"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_a_cacheless_disagg_agent_lands_shipped_blocks_in_its_pool(
        ranks, reference, geometry):
    """No prefix cache: each rank takes its KV heads of the shipped
    blocks straight into its pool (streamed chunks, then the final
    envelope) and hands their ids to submit(kv_blocks=...): JAX's
    cacheless disaggregated responses, rank 0 alone sending, the same
    installs and plans on every rank."""
    assert reference["cacheless"] == reference["colocated"]
    runs = [rank[3] for rank in ranks[geometry]]
    for rank, run in enumerate(runs):
        assert run["responses"] == reference["cacheless"]
        assert run["client"]["transfers"] == \
            (REMOTE_CACHELESS if rank == 0 else 0)
        assert run["client"]["installs"] == REMOTE_CACHELESS
        assert run["client"]["direct_installs"] == REMOTE_CACHELESS
        assert run["client"]["local_fallbacks"] == 0
        assert run["plans"] == runs[0]["plans"]
        assert run["submitted"] == runs[0]["submitted"]
