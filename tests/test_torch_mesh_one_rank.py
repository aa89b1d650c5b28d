"""A decoder on a one-rank mesh (create_mesh({"model": 1}) on gloo, in
this process) under the callers that read submit's and drain's results:
the disaggregated client and the chaos wrapper.

On a mesh, one rank included, submit refuses nothing by time and drain
evacuates the queue at the round note that agrees it (serving.py's
header).  Each case runs the port's unsharded decoder and the one-rank
mesh decoder on the same tiny-preset f32 weights:

- PrefillClient's local rung with a passed deadline: off a mesh submit
  returns False and the caller owns the shed; on the mesh submit returns
  True and the shed reaches the client's on_refused at the note, counted
  once either way.
- A remote reply's install with a passed deadline: the shed request's
  shipped pool blocks go back to the pool on both decoders (on the mesh
  the decoder releases them at the note) and on_refused fires once.
- ChaosDecoder's preemption with one live slot and two queued requests:
  every request is evacuated and routed, none lost, and the descriptors
  equal the unsharded decoder's."""

import dataclasses
import functools
import time

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch import serving_disagg as TD
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.serving_chaos import ChaosDecoder

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
MESHES = [False, True]
IDS = ["unsharded", "one_rank_mesh"]
_SEQ = [0]


@functools.cache
def model():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                    T_CONFIG, device="cpu")


def decoder_for(on_mesh: bool, **kwargs):
    """The port's decoder on the tiny weights; on_mesh: on a one-rank
    model mesh, given this rank's shards (the whole model)."""
    _SEQ[0] += 1
    kwargs = {"max_slots": 2, "prefill_buckets": (64,), "paged_kv": True,
              "kv_block": 8, "name": f"one{_SEQ[0]}", **kwargs}
    if not on_mesh:
        return TS.ContinuousDecoder(model(), T_CONFIG, device="cpu",
                                    **kwargs)
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards
    mesh = create_mesh({"model": 1}, device="cpu")
    params, _ = local_shards(model(), TL.llama_axes(T_CONFIG), mesh,
                             config=T_CONFIG)
    decoder = TS.ContinuousDecoder(params, T_CONFIG, mesh=mesh, **kwargs)
    assert decoder.agreed and not decoder.sharded
    return decoder


def client_for(decoder):
    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.process import ProcessRuntime
    runtime = ProcessRuntime(name=f"rt{_SEQ[0]}",
                             engine=EventEngine()).initialize()
    return runtime, TD.PrefillClient(runtime, decoder, name=f"c{_SEQ[0]}")


@pytest.mark.parametrize("on_mesh", MESHES, ids=IDS)
def test_local_rung_shed_reaches_on_refused_once(on_mesh):
    cache = TS.PrefixKVCache(block_tokens=8, name=f"shed{_SEQ[0]}")
    decoder = decoder_for(on_mesh, prefix_cache=cache, paged_kv=False)
    runtime, client = client_for(decoder)
    decoder._round_ewma = 10.0
    refused = []
    try:
        accepted = client.submit("r1", [1, 2, 3], 4, lambda *_: None,
                                 deadline=time.monotonic() - 1.0,
                                 on_refused=refused.append)
        assert accepted is on_mesh
        assert refused == []
        decoder.pump()
        assert refused == (["r1"] if on_mesh else [])
        assert client.stats["install_shed"] == 1
        assert client.stats["local_short"] == 1
        assert decoder.stats["admission_shed"] == 1
        assert decoder.idle
    finally:
        client.stop()
        runtime.terminate()


@pytest.mark.parametrize("on_mesh", MESHES, ids=IDS)
def test_shed_install_gives_its_blocks_back(on_mesh):
    decoder = decoder_for(on_mesh)
    runtime, client = client_for(decoder)
    decoder._round_ewma = 10.0
    used = decoder.pool.used_blocks()
    ids = decoder.pool.alloc_blocks(2)
    assert decoder.pool.used_blocks() == used + 2
    refused = []
    entry = {"request_id": "r1", "prompt": PROMPT[:20], "max_new": 4,
             "callback": lambda *_: None,
             "deadline": time.monotonic() - 1.0, "tenant": "",
             "on_refused": refused.append}
    try:
        client._submit_installed(entry, kv_blocks=(16, ids))
        decoder.pump()
        assert refused == ["r1"]
        assert client.stats["install_shed"] == 1
        assert decoder.pool.used_blocks() == used
        assert decoder.idle
    finally:
        client.stop()
        runtime.terminate()


def preempted(on_mesh: bool) -> tuple:
    """One live slot and two queued requests, preempted at round 3; the
    evacuated descriptors go to the chaos wrapper's route."""
    decoder = decoder_for(on_mesh, max_slots=1)
    chaos = ChaosDecoder(decoder, name=f"chaos{_SEQ[0]}")
    routed = []
    chaos.on_evacuate = routed.append
    chaos.arm_preemption(at_round=3)
    done = {}
    for index in range(3):
        decoder.submit(f"r{index}", PROMPT[index:index + 24], 24,
                       lambda rid, t: done.update({rid: list(t)}))
    for _ in range(50):
        chaos.pump()
        if decoder.drained:
            break
    assert decoder.drained
    return (sorted((d["request_id"], list(d["prompt"]), list(d["generated"]),
                    d["max_new_tokens"]) for d in routed),
            done, dict(chaos.stats),
            {key: decoder.stats[key] for key in (
                "drain_evacuated", "drain_checkpoints", "drain_refused")})


def test_chaos_preemption_routes_every_queued_request():
    expected = preempted(False)
    got = preempted(True)
    assert [d[0] for d in expected[0]] == ["r0", "r1", "r2"]
    assert expected[1] == {}
    assert got == expected
