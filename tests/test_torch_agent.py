"""PE_LlamaAgent on the port against the JAX package's, each in its own
package's pipeline on its own engine under a virtual clock: batched,
sync and continuous modes, and the multi-turn session scenario of
tests/test_prefix_cache.py:358-435 (each turn re-submits the session's
history, turn 2 admits through the prefix cache, lease expiry releases
every pin).  Both serve the tiny preset in f32 from the same weights:
the JAX element draws them from PRNGKey(0), and the port element's
llama_init is patched to return that tree through
bridge.params_from_numpy.  The JAX continuous decoder is latched to the
Pallas paged kernel (interpret mode) while its element sets up.
Responses must be equal frame by frame; the decoders' prefix counters
too."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JP, JComputeRuntime),
    "torch": (TE, TM, TProcessRuntime, TP, TComputeRuntime),
}
CONTINUOUS = {"mode": "continuous", "paged": True, "max_batch": 2,
              "steps_per_sync": 2, "prefix_block": 8}


@pytest.fixture(scope="module")
def jax_params():
    return JL.llama_init(jax.random.PRNGKey(0), JL.LLAMA_PRESETS["tiny"])


@pytest.fixture
def same_weights(jax_params, monkeypatch):
    """The port element's llama_init returns the JAX element's tree."""
    def bridged(generator, config, device=None):
        return bridge.params_from_numpy(
            jax.tree.map(np.asarray, jax_params), config, device="cpu")
    monkeypatch.setattr(TL, "llama_init", bridged)


def _definition(module, parameters):
    return module.parse_pipeline_definition({
        "version": 0, "name": "p_agent", "runtime": "jax",
        "graph": ["(PE_LlamaAgent)"],
        "parameters": {f"PE_LlamaAgent.{key}": value for key, value in {
            "preset": "tiny", "max_tokens": 6, "prompt_length": 16,
            **parameters}.items()},
        "elements": [{
            "name": "PE_LlamaAgent", "input": [{"name": "text"}],
            "output": [{"name": "response"},
                       {"name": "response_tokens"}],
            "parameters": {}}]})


def _build(package, parameters, streams):
    event, memory, runtime_class, module, compute_class = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = runtime_class(name="agent_host", engine=engine,
                            transport_factory=factory).initialize()
    compute_class(runtime, "compute",
                  **({"device": "cpu"} if package == "torch" else {}))
    pipeline = module.Pipeline(runtime, _definition(module, parameters),
                               stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    before = JS.ATTENTION_IMPL
    JS.ATTENTION_IMPL = "paged_kernel"
    try:
        for stream_id in streams:
            pipeline.create_stream(stream_id, lease_time=0)
    finally:
        JS.ATTENTION_IMPL = before
    agent = next(node.element for node in pipeline.graph.nodes()
                 if node.name == "PE_LlamaAgent")
    if package == "jax" and parameters.get("mode") == "continuous" and \
            parameters.get("paged"):
        # with prefix_block set the JAX agent forces chunked prefill: its
        # paged decoder's shared table-row buffer races its own dispatch
        # (ROADMAP.md Queue 3 items 1 and 7)
        fresh_table_scratch(agent.decoder)
    return engine, pipeline, agent, done


def _await_promotions(agent, timeout=60.0):
    """Wait until the host tier's promoter thread has staged every
    promotion it was kicked for, so that the next engine step's poll()
    installs the same jobs in every run: the engine runs on a virtual
    clock, the promoter on wall time, and which chain an install evicts
    from a small device cache depends on when its job lands."""
    promoter = getattr(getattr(agent, "prefix_cache", None), "promoter",
                       None)
    for job in list(getattr(promoter, "_jobs", {}).values()):
        assert job.done.wait(timeout), "a promotion did not stage"


def _converse(package, parameters, texts, settle=0.0):
    """Every stream posts its turns one after another (a turn only once
    the stream's previous turn came back).  Returns ({(stream, turn):
    response tokens}, the element, its pipeline, its engine)."""
    engine, pipeline, agent, done = _build(package, parameters, texts)
    turn_of = {stream_id: 0 for stream_id in texts}
    responses, seen = {}, 0
    for stream_id, turns in texts.items():
        pipeline.post("process_frame", stream_id, {"text": turns[0]})
    total = sum(len(turns) for turns in texts.values())
    for _ in range(20000):
        for frame in done[seen:]:
            stream_id = frame.stream_id
            responses[(stream_id, turn_of[stream_id])] = [
                int(t) for t in frame.swag["response_tokens"]]
            assert isinstance(frame.swag["response"], str)
            turn_of[stream_id] += 1
            if turn_of[stream_id] < len(texts[stream_id]):
                pipeline.post("process_frame", stream_id, {
                    "text": texts[stream_id][turn_of[stream_id]]})
        seen = len(done)
        if len(responses) == total:
            break
        engine.clock.advance(0.002)
        _await_promotions(agent)
        engine.step()
    assert len(responses) == total, f"{len(responses)}/{total}"
    event = PACKAGES[package][0]
    if settle:
        event.settle_virtual(engine, settle)
    return responses, agent, pipeline, engine


TEXTS = {"s0": ["hello there agent", "and again please", "a third turn"],
         "s1": ["what is the queue doing", "why", "show me"]}


@pytest.mark.parametrize("mode", ["batched", "sync"])
def test_batched_and_sync_modes_answer_like_jax(same_weights, mode):
    parameters = {"mode": mode, "max_batch": 4, "max_wait": 0.01}
    texts = {f"s{i}": [f"question {i} about stream {i}", "more"]
             for i in range(3)}
    port, *_ = _converse("torch", parameters, texts)
    expected, *_ = _converse("jax", parameters, texts)
    assert port == expected
    assert all(len(tokens) == 6 for tokens in port.values())


def test_continuous_mode_with_a_prefix_cache(same_weights):
    port, agent, *_ = _converse("torch", CONTINUOUS, TEXTS)
    expected, jax_agent, *_ = _converse("jax", CONTINUOUS, TEXTS)
    assert port == expected
    for key in ("prefix_admits", "tokens_prefill", "completed"):
        assert agent.decoder.stats[key] == jax_agent.decoder.stats[key]
    assert agent.prefix_cache.stats["hit_tokens"] == \
        jax_agent.prefix_cache.stats["hit_tokens"]


def test_sessions_resume_a_conversation(same_weights):
    """sessions=true: each turn re-submits the session's history, turn 2
    admits through the cache, the finished turn's chain is pinned under
    the session handle, lease expiry releases the pins."""
    parameters = {**CONTINUOUS, "sessions": True, "session_lease": 5.0}
    results = {package: _converse(package, parameters, TEXTS, settle=6.0)
               for package in ("jax", "torch")}
    assert results["torch"][0] == results["jax"][0]
    agent = results["torch"][1]
    jax_agent = results["jax"][1]
    for key in ("prefix_admits", "tokens_prefill", "cow_copies"):
        assert agent.decoder.stats[key] == jax_agent.decoder.stats[key], key
    cache = agent.prefix_cache
    assert agent.decoder.stats["prefix_admits"] >= 4
    assert cache.stats["session_handles"] == 6 == \
        jax_agent.prefix_cache.stats["session_handles"]
    assert cache.stats["hit_tokens"] == \
        jax_agent.prefix_cache.stats["hit_tokens"]
    # the leases lapsed during the settle: no session, no pin
    assert len(agent._session_table) == 0
    assert all(node.refs == 0 for node in cache._nodes.values())
    pipeline, engine = results["torch"][2], results["torch"][3]
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    assert cache.purge() > 0 and agent.decoder.pool.used_blocks() == 0
    assert not agent.decoder.attached


def test_session_history_feeds_the_next_turn(same_weights):
    parameters = {**CONTINUOUS, "sessions": True, "session_lease": 30.0}
    texts = {"s0": TEXTS["s0"][:2]}
    responses, agent, *_ = _converse("torch", parameters, texts)
    table = agent._session_table
    payload = table.get("default", "s0")
    turn_1 = agent.tokenizer(TEXTS["s0"][0])
    turn_2 = agent.tokenizer(TEXTS["s0"][1])
    assert payload["history"] == turn_1 + responses[("s0", 0)] + turn_2 + \
        responses[("s0", 1)]
    # the pinned chain: every complete block of the history but its last
    # token (whose K/V is never written)
    assert payload["kv_tokens"] == (len(payload["history"]) - 1) // 8 * 8


def test_continuous_mode_defaults_to_the_dense_decoder(same_weights):
    """paged false, the JAX element's default: the dense decoder, with
    no prefix cache unless prefix_block is set; responses equal JAX's."""
    parameters = {"mode": "continuous", "max_batch": 2, "steps_per_sync": 2}
    texts = {stream: turns[:2] for stream, turns in TEXTS.items()}
    port, agent, *_ = _converse("torch", parameters, texts)
    expected, jax_agent, *_ = _converse("jax", parameters, texts)
    assert port == expected
    assert not agent.decoder.paged and agent.prefix_cache is None
    for key in ("completed", "tokens_prefill", "steps"):
        assert agent.decoder.stats[key] == jax_agent.decoder.stats[key]


def test_place_params_moves_to_the_runtime_device():
    """One device (no mesh): placement is the device, whatever the axes
    and rules say; the parameters stay plain tensors."""
    from aiko_services_tpu_torch.parallel import DEFAULT_RULES
    engine, pipeline, agent, _ = _build("torch", {"mode": "sync"}, ["s0"])
    config = TL.LLAMA_PRESETS["tiny"]
    model = TL.llama_init(torch.Generator().manual_seed(1), config,
                          device="cpu")
    assert agent.compute.place_params(model) is model
    rules = DEFAULT_RULES.with_overrides(embed="model")
    assert agent.compute.place_params(model, TL.llama_axes(config),
                                      rules=rules) is model
    assert all(type(p.data) is torch.Tensor and p.device.type == "cpu"
               for p in model.parameters())
    assert dataclasses.is_dataclass(TL.LLAMA_PRESETS["tiny"])
