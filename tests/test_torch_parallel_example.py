"""examples/speech/pipeline_assistant_parallel.json on the port over four
gloo ranks with --mesh expert=4, against the JAX package's run of it.

The JAX side is driven as __graft_entry__.py's _drive_parallel_example
drives it (a ComputeRuntime over parse_mesh_spec("expert=4") of the
virtual CPU devices, one microphone chunk of 0.5 s, a virtual clock).
Each port rank builds the example as `pipeline create --mesh expert=4
--device cpu` does (cli.build_pipeline; tests/torch_spmd.py ranks, rank
body in tests/torch_spmd_cases.py) and drives it the same way: PE_WhisperASR
in two pipeline stages (pp_stages 2) and PE_LlamaAgent on tiny_moe in
continuous mode, each rank holding one expert of four.  Both packages
serve the same weights: the ASR from one flat npz (the JAX element's
model for the example's shapes, written with save_flat_npz) switched to
f32 after setup, as tests/test_torch_speech_pipeline.py does; the agent
from the JAX element's PRNGKey(0) tree (the port element's llama_init
returns it through the bridge).  Tolerance: f32, the frame's ASR tokens
and text and the agent's response tokens and text equal JAX's on every
rank.  PE_Synthesize's audio is left out: it seeds with Python's hash(),
which differs across processes (ROADMAP.md Queue 3 item 2)."""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aiko_services_tpu.cli import parse_mesh_spec
from aiko_services_tpu.compute import ComputeRuntime
from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.event import EventEngine, VirtualClock
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.pipeline import Pipeline, load_pipeline_definition
from aiko_services_tpu.process import ProcessRuntime
from aiko_services_tpu.transport.memory import MemoryBroker, MemoryMessage

import torch_spmd_cases as cases
from torch_spmd import run_ranks

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "speech" / \
    "pipeline_assistant_parallel.json"
STREAM = {"PE_MicrophoneSim.limit": 1, "PE_MicrophoneSim.chunk_seconds": 0.5}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(the definition naming the ASR weights, the JAX ASR params in f32,
    the npz, the agent's JAX tree as a flat numpy dict, its config)."""
    raw = json.loads(EXAMPLE.read_text())
    parameters = raw["parameters"]
    config = dataclasses.replace(
        JW.WHISPER_PRESETS[parameters["PE_WhisperASR.preset"]],
        n_audio_ctx=max(parameters["PE_WhisperASR.buckets"]) // 2,
        n_text_ctx=parameters["PE_WhisperASR.max_tokens"] + 8)
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(0))
    folder = tmp_path_factory.mktemp("parallel_example")
    npz = str(folder / "whisper_test.npz")
    save_flat_npz(params, npz)
    parameters["PE_WhisperASR.weights"] = npz
    parameters["PE_LogMel.device"] = "cpu"
    definition = folder / "pipeline_assistant_parallel.json"
    definition.write_text(json.dumps(raw))
    agent_config = JL.LLAMA_PRESETS[parameters["PE_LlamaAgent.preset"]]
    agent = JL.llama_init(jax.random.PRNGKey(0), agent_config)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(agent)}
    fields = {f.name: getattr(agent_config, f.name)
              for f in dataclasses.fields(agent_config)} | \
        {"dtype": "float32"}
    return str(definition), params, npz, flat, fields


def jax_frame(definition, params) -> dict:
    engine = EventEngine(VirtualClock())
    broker = MemoryBroker()

    def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
        return MemoryMessage(on_message=on_message, broker=broker,
                             lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                             lwt_retain=lwt_retain)

    runtime = ProcessRuntime(name="example", engine=engine,
                             transport_factory=transport).initialize()
    ComputeRuntime(runtime, "compute", mesh=parse_mesh_spec("expert=4"))
    pipeline = Pipeline(runtime, load_pipeline_definition(definition),
                        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s0", lease_time=0, parameters=dict(STREAM))
    asr = pipeline.graph.node("PE_WhisperASR").element
    asr.config = dataclasses.replace(asr.config, dtype=jnp.float32)
    asr.params = params
    asr._stage_params = tuple({key: params[key] for key in stage}
                              for stage in asr._stage_params)
    for _ in range(3000):
        if done:
            break
        engine.clock.advance(0.01)
        engine.step()
    assert done, "the JAX example never completed a frame"
    swag = done[0].swag
    agent = pipeline.graph.node("PE_LlamaAgent").element
    assert not agent.decoder.params["layers"][0]["moe"]["w_in"] \
        .sharding.is_fully_replicated
    runtime.terminate()
    return {"text": swag["text"],
            "tokens": np.asarray(swag["tokens"]).tolist(),
            "response": swag["response"],
            "response_tokens": np.asarray(swag["response_tokens"]).tolist()}


@pytest.fixture(scope="module")
def frames(inputs, tmp_path_factory):
    definition, params, npz, flat, fields = inputs
    want = jax_frame(definition, params)
    ranks = run_ranks(cases.parallel_example, 4,
                      tmp_path_factory.mktemp("example_ranks"), definition,
                      npz, flat, fields, STREAM, timeout=300.0)
    return want, ranks


def test_every_rank_completes_jax_s_assistant_frame(frames):
    want, ranks = frames
    assert want["response_tokens"] and want["tokens"]
    for rank in ranks:
        assert rank["frames"] == 1
        got = {key: rank[key] for key in want}
        assert got == want


def test_the_agent_holds_one_expert_of_four_on_each_rank(frames):
    _, ranks = frames
    for rank in ranks:
        assert rank["mesh"] == {"expert": 4}
        assert rank["w_in"] == (1, 64, 128)          # w_in [E/4, D, F]
        assert rank["router"] == (64, 4)             # the router whole


def test_the_agent_on_four_ranks_refuses_what_each_rank_would_time(frames):
    """Nothing is refused on four ranks any more: the agent's batched
    mode agrees its batch cut over the mesh (rank 0's clock decides which
    items form each batch, every rank runs it), disagg's transfers are
    sent, timed out and landed by rank 0's client alone and applied at
    the decoder's round note, and sessions ride that note too.  Set up
    again in batched mode, the agent answers the frame's text as
    llama_greedy_decode does on the whole model; with disagg and no
    prefill pool, every rank prefills it locally (local_short, or
    local_no_pool decided by rank 0 and applied at the note; no rank
    sends) and answers as its decoder
    answers the text submitted directly (the paged pool: tiny_moe's
    expert capacity counts the rows each program hands it, so the
    dense decoder's answer is another), the same on every rank."""
    want, ranks = frames
    for rank in ranks:
        assert rank["refused"] == {}
        batched = rank["batched"]
        assert batched["agreed"]
        assert batched["tokens"] == batched["unsharded"]
        disagg = rank["disagg"]
        assert disagg["tokens"] == disagg["direct"]
        assert len(disagg["tokens"]) == len(want["response_tokens"])
        assert disagg["tokens"] == ranks[0]["disagg"]["tokens"]
        assert sum(disagg["local"]) == 1 and disagg["transfers"] == 0
        assert disagg["local"] == ranks[0]["disagg"]["local"]
