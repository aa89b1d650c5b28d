"""PE_LlamaAgent with `role: decode` and `disagg: true` on the port
against the JAX package's (tests/test_disagg.py
test_llama_agent_disagg_routes_through_prefill_pool): the agent's prompt
rides a PrefillClient to a PrefillRuntime discovered through the
registrar, the shipped chain installs into the agent decoder's prefix
cache, and the request admits as a prefix hit in the "remote" TTFT
population.  Each package runs its own registrar, prefill runtime and
pipeline on one virtual-clock engine and broker; both serve the tiny
preset in f32 from the same weights (the port element's llama_init is
patched to return the JAX tree).  The response tokens must be equal, and
so must the transfer, install and prefix counters."""

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
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import compute as TC
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch import process as TPR
from aiko_services_tpu_torch import registrar as TR
from aiko_services_tpu_torch import serving_disagg as TD
from aiko_services_tpu_torch import share as TSH
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

PACKAGES = {"jax": (JE, JM, JPR, JP, JC, JR, JD, JSH),
            "torch": (TE, TM, TPR, TP, TC, TR, TD, TSH)}
PARAMETERS = {
    "preset": "tiny", "max_tokens": 6, "prompt_length": 16,
    "mode": "continuous", "max_batch": 2, "steps_per_sync": 2,
    "prefix_block": 8, "prefill_chunk": 16, "role": "decode",
    "disagg": True,
}
TEXTS = ["hello there prefill pool",
         "a second turn that is a little longer than the first one"]


@pytest.fixture(scope="module")
def jax_params():
    return JL.llama_init(jax.random.PRNGKey(0), JL.LLAMA_PRESETS["tiny"])


@pytest.fixture
def same_weights(jax_params, monkeypatch):
    def bridged(generator, config, device=None):
        return bridge.params_from_numpy(
            jax.tree.map(np.asarray, jax_params), config, device="cpu")
    monkeypatch.setattr(TL, "llama_init", bridged)


def serve(package, jax_params, text):
    (event, memory, process, pipelines, compute, registrar, disagg,
     share) = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def make_runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        return process.ProcessRuntime(name=name, engine=engine,
                                      transport_factory=factory).initialize()

    registrar.Registrar(make_runtime("dz_reg"))
    engine.clock.advance(2.1)            # the primary's promotion
    for _ in range(300):
        engine.step()
    tiny = JL.LLAMA_PRESETS["tiny"]
    if package == "jax":
        weights, config, extra = jax_params, tiny, {}
    else:
        config = TL.LLAMA_PRESETS["tiny"]
        weights = bridge.params_from_numpy(
            jax.tree.map(np.asarray, jax_params), config, device="cpu")
        extra = {"decoder_opts": {"device": "cpu"}}
    prefill = disagg.PrefillRuntime(
        make_runtime("dz_prefill"), "dz_prefill", params=weights,
        config=config, block_tokens=8, max_slots=2, prefill_buckets=(16,),
        prefill_chunk=16, **extra)
    host = make_runtime("dz_host")
    compute.ComputeRuntime(host, "compute",
                           **({"device": "cpu"} if package == "torch"
                              else {}))
    definition = pipelines.parse_pipeline_definition({
        "version": 0, "name": "p_dz", "runtime": "jax",
        "graph": ["(PE_LlamaAgent)"],
        "parameters": {f"PE_LlamaAgent.{k}": v
                       for k, v in PARAMETERS.items()},
        "elements": [{
            "name": "PE_LlamaAgent", "input": [{"name": "text"}],
            "output": [{"name": "response"},
                       {"name": "response_tokens"}],
            "parameters": {}}]})
    pipeline = pipelines.Pipeline(host, definition,
                                  services_cache=share.ServicesCache(host),
                                  stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s1", lease_time=0)
    agent = next(node.element for node in pipeline.graph.nodes()
                 if node.name == "PE_LlamaAgent")
    # discovery settles before the first frame (a frame racing it would
    # take the counted local_no_pool rung instead)
    for _ in range(400):
        engine.step()
    client = agent._prefill_client
    assert client is not None and client.loads, "prefill pool not found"
    responses = []
    for turn in text:
        pipeline.post("process_frame", "s1", {"text": turn})
        for _ in range(8000):
            if len(done) > len(responses):
                break
            engine.clock.advance(0.002)
            engine.step()
        assert len(done) > len(responses), "agent frame never completed"
        frame = done[len(responses)]
        assert frame.swag["response"]
        responses.append([int(t) for t in frame.swag["response_tokens"]])
    remote = agent.decoder.slo_sketch_stats(prefill="remote")
    out = (responses,
           {k: client.stats[k] for k in (
               "transfers", "installs", "installed_blocks",
               "local_fallbacks", "local_no_pool", "local_short")},
           prefill.stats["computed"], agent.decoder.stats["prefix_admits"],
           agent.decoder.stats["tokens_prefill"],
           remote["ttft_p50_ms"] is not None, "role=decode" in pipeline.tags)
    pipeline.destroy_stream("s1")
    pipeline.stop()
    prefill.stop()
    assert agent._prefill_client is None       # torn down with the stream
    return out


@pytest.mark.parametrize("turns", [1, 2])
def test_llama_agent_disagg_routes_through_prefill_pool(same_weights,
                                                        jax_params, turns):
    port = serve("torch", jax_params, TEXTS[:turns])
    expected = serve("jax", jax_params, TEXTS[:turns])
    assert port == expected
    responses, stats, computed, admits, _, remote, tagged = port
    assert len(responses) == turns and remote and tagged
    assert (stats["transfers"], stats["installs"],
            stats["local_fallbacks"]) == (turns, turns, 0)
    assert computed == turns and admits == turns
