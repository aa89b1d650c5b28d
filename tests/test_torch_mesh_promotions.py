"""Host-tier promotions on a mesh (create_mesh({"model": 1}) on gloo, in
this process): the round note kicks the promotion of an arrival's
host-resident chain, the admit waits while the agreed job is in flight,
and the job lands at the next note, before the admit, which then sees the
promoted blocks as hits (an async install), as the unsharded decoder's
admit sees a prefetch that landed before it.  A job some rank never
holds is given up after rank 0's bound of notes, the same on every rank,
and the admit then stages the chain inline.

Each case serves a prompt on the tiny preset in f32 (paged, a prefix
cache with a host tier), demotes the cache to the host, then serves a
continuation: tokens, hits and promotions must equal the unsharded
decoder's."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
from aiko_services_tpu_torch.serving_tiered import HostBlockStore

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
FOLLOW = PROMPT + [7, 8, 9, 10]
_SEQ = [0]


@functools.cache
def model():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                    T_CONFIG, device="cpu")


def tiered_decoder(on_mesh: bool):
    _SEQ[0] += 1
    registry = MetricsRegistry()
    cache = TS.PrefixKVCache(block_tokens=8, name=f"mp{_SEQ[0]}",
                             registry=registry)
    kwargs = {"max_slots": 2, "prefill_buckets": (16,), "prefill_chunk": 16,
              "paged_kv": True, "kv_block": 8, "prefix_cache": cache,
              "registry": registry, "name": f"mp{_SEQ[0]}"}
    if on_mesh:
        from aiko_services_tpu_torch.parallel import create_mesh
        from aiko_services_tpu_torch.parallel.sharding import local_shards
        mesh = create_mesh({"model": 1}, device="cpu")
        params, _ = local_shards(model(), TL.llama_axes(T_CONFIG), mesh,
                                 config=T_CONFIG)
        decoder = TS.ContinuousDecoder(params, T_CONFIG, mesh=mesh,
                                       **kwargs)
    else:
        decoder = TS.ContinuousDecoder(model(), T_CONFIG, device="cpu",
                                       **kwargs)
    cache.attach_host_store(HostBlockStore(max_bytes=1 << 24,
                                           name=f"mp{_SEQ[0]}",
                                           registry=registry))
    return decoder, cache


def serve_then_continue(on_mesh: bool, never_landed: bool = False,
                        bound: int = 8) -> dict:
    """PROMPT, the cache demoted to the host, then FOLLOW: the tokens,
    the round FOLLOW admitted at (counted from its submit), its hits and
    the promoter's counts."""
    decoder, cache = tiered_decoder(on_mesh)
    decoder.promote_wait_notes = bound
    promoter = cache.promoter
    if never_landed:
        promoter.landed = lambda: []        # a rank that never stages
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    decoder.submit("first", PROMPT, 4, keep)
    for _ in range(50):
        if "first" in done:
            break
        decoder.pump()
    assert cache.purge() > 0 and len(cache.host_store) > 0
    decoder.submit("follow", FOLLOW, 4, keep)
    admitted = None
    for pumps in range(1, 60):
        before = decoder.stats["prefix_admits"]
        decoder.pump()
        if admitted is None and decoder.stats["prefix_admits"] > before:
            admitted = pumps
        if "follow" in done:
            break
    promoter.stop()
    return {"tokens": done, "admitted": admitted,
            "hit_tokens": cache.stats["hit_tokens"],
            "promoted": cache.stats["promoted"],
            "promoter": {key: promoter.stats[key] for key in (
                "kicks", "installs_async", "installs_sync")}}


@pytest.fixture(scope="module")
def unsharded():
    return serve_then_continue(False)


def test_an_agreed_kick_lands_at_the_next_note_before_its_admit(unsharded):
    """The arrival's note kicks; the admit waits one round; the next
    note lands the job, whose blocks the admit then aliases: every
    promoted block an async install, none staged inline; tokens, hits
    and promotions the unsharded decoder's."""
    run = serve_then_continue(True)
    assert run["tokens"] == unsharded["tokens"]
    assert run["hit_tokens"] == unsharded["hit_tokens"] > 0
    assert run["promoted"] == unsharded["promoted"] > 0
    assert run["promoter"]["kicks"] == 1
    assert run["promoter"]["installs_async"] == run["promoted"]
    assert run["promoter"]["installs_sync"] == 0
    assert run["admitted"] == 2


@pytest.mark.parametrize("bound", [0, 3])
def test_a_job_no_rank_holds_is_given_up_after_rank_0s_bound(unsharded,
                                                              bound):
    """landed() never holds the job (a rank that never staged it): the
    admit waits `bound` notes past the kick's, then stages the chain
    inline; the tokens, hits and promotions are unchanged."""
    run = serve_then_continue(True, never_landed=True, bound=bound)
    assert run["tokens"] == unsharded["tokens"]
    assert run["hit_tokens"] == unsharded["hit_tokens"]
    assert run["promoter"]["installs_async"] == 0
    assert run["promoter"]["installs_sync"] == run["promoted"] > 0
    assert run["admitted"] == bound + 2
