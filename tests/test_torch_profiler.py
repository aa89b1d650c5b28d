"""The port's decode-round phase profiler against the JAX package's.

The PhaseProfiler cases of tests/test_health.py (attribution, abandoned
rounds, the registry families, the CPU smoke's 90% attribution) run on
the port.  Then tiny Llama decoders of both packages (dense, paged with
the JAX decoder latched to the Pallas kernel in interpret mode,
speculate_k 2, chunked prefill with fresh_table_scratch) serve one
request stream: each pump round must commit or abandon alike, mark the
same phases in the same order and charge the same modeled bytes to each
phase, so phase_bytes are equal, and greedy tokens stay the JAX
decoder's.  Last, arm_trace on the CPU writes a Chrome trace."""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe import profiler as TP
from aiko_services_tpu_torch.observe.metrics import (MetricsRegistry,
                                                     default_registry)
from aiko_services_tpu_torch.observe.profiler import PHASES, PhaseProfiler
from aiko_services_tpu_torch.serving import ContinuousDecoder

from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


# -- the PhaseProfiler cases of tests/test_health.py ---------------------------

def test_phases_are_the_jax_phases():
    from aiko_services_tpu.observe import profiler as JP
    assert PHASES == JP.PHASES


def test_mark_commit_attribution():
    profiler = PhaseProfiler("port_unit")
    profiler.begin_round()
    profiler.mark("plan")
    profiler.mark("host_sync")
    profiler.add_bytes("host_sync", 1000)
    profiler.commit_round()
    stats = profiler.phase_stats()
    assert stats["rounds"] == 1
    assert "plan" in stats["phases"]
    assert stats["phases"]["host_sync"]["bytes"] == 1000
    total = sum(e["s"] for e in stats["phases"].values())
    assert total == pytest.approx(stats["wall_s"], rel=1e-6)


def test_abandoned_rounds_do_not_dilute():
    profiler = PhaseProfiler("port_unit2")
    profiler.begin_round()
    profiler.mark("plan")
    profiler.abandon_round()
    assert profiler.rounds == 0
    assert profiler.phase_stats()["wall_s"] == 0.0


def test_registry_counters_accumulate():
    registry = default_registry()
    profiler = PhaseProfiler("port_unit3")
    before = registry.value("serving_phase_seconds_total",
                            {"decoder": "port_unit3", "phase": "plan"})
    profiler.begin_round()
    profiler.mark("plan")
    profiler.add_bytes("plan", 64)
    profiler.commit_round()
    after = registry.value("serving_phase_seconds_total",
                           {"decoder": "port_unit3", "phase": "plan"})
    assert after > before
    # the bytes family by its counter: the JAX graft-check baseline
    # expects that family's name unmentioned outside its own module
    assert profiler._bytes_counters["plan"].value == 64
    profiler.reset()
    assert profiler.rounds == 0 and profiler.phase_bytes["plan"] == 0


def test_decoder_smoke_attributes_90_percent(weights):
    """The CPU Llama smoke of tests/test_health.py on the port: >= 90% of
    the committed rounds' wall time lands in named phases."""
    _, model = weights
    decoder = ContinuousDecoder(model, T_CONFIG, device="cpu", max_slots=4,
                                prefill_buckets=(16,), steps_per_sync=4,
                                name="port_smoke",
                                registry=MetricsRegistry())
    done = {}
    rng = np.random.default_rng(7)
    for index in range(6):
        prompt = [int(x) for x in rng.integers(1, T_CONFIG.vocab, size=5)]
        decoder.submit(f"r{index}", prompt, 8,
                       lambda rid, t: done.update({rid: t}))
    for _ in range(60):
        decoder.pump()
        if len(done) == 6:
            break
    assert len(done) == 6
    stats = decoder.phase_stats()
    assert stats == decoder.profiler.phase_stats()
    assert stats["rounds"] >= 2
    assert stats["attributed_frac"] >= 0.9, stats
    for phase in ("plan", "scan_dispatch", "admit_dispatch", "host_sync",
                  "deliver"):
        assert phase in stats["phases"], stats["phases"].keys()
    assert stats["phases"]["host_sync"]["bytes"] > 0
    total = sum(e["s"] for e in stats["phases"].values())
    assert total == pytest.approx(stats["wall_s"], rel=1e-6)


# -- the decoders of both packages on one request stream -----------------------

PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
STREAM = {"a": (PROMPT, 10), "b": (PROMPT[:17] + [3, 4], 8),
          "long": ((PROMPT * 3)[:80], 6)}
MIDSTREAM = {"mid": (PROMPT[:9] + [7], 6), "m2": (PROMPT[5:30], 5)}


def record_rounds(decoder) -> list:
    """Wrap the decoder's profiler so each pump round records what it
    did: ("commit", marked phases in order, bytes by phase) or
    ("abandon",)."""
    rounds = []
    profiler = decoder.profiler
    commit, abandon = profiler.commit_round, profiler.abandon_round

    def committed():
        rounds.append(("commit", tuple(p for p, _ in profiler._staged),
                       dict(profiler._staged_bytes)))
        commit()

    def abandoned():
        rounds.append(("abandon",))
        abandon()

    profiler.commit_round, profiler.abandon_round = committed, abandoned
    return rounds


def serve(decoder, requests, midstream, rounds=300) -> dict:
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    for request_id, (prompt, max_new) in requests.items():
        decoder.submit(request_id, prompt, max_new, keep)
    total = len(requests) + len(midstream)
    for i in range(rounds):
        decoder.pump()
        if i == 1:
            for request_id, (prompt, max_new) in midstream.items():
                decoder.submit(request_id, prompt, max_new, keep)
        if len(done) == total:
            break
    decoder.pump()                          # one idle tick: abandoned
    assert len(done) == total
    return done


def both(weights, kernel: bool, **kwargs):
    params, model = weights
    kwargs = {"max_slots": 4, "prefill_buckets": (64, 96),
              "steps_per_sync": 4, **kwargs}
    before = JS.ATTENTION_IMPL
    if kernel:
        JS.ATTENTION_IMPL = "paged_kernel"
    try:
        jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    finally:
        JS.ATTENTION_IMPL = before
    if kwargs.get("paged_kv"):
        fresh_table_scratch(jax_decoder)
    port = ContinuousDecoder(model, T_CONFIG, device="cpu",
                             registry=MetricsRegistry(), **kwargs)
    return jax_decoder, port


@pytest.mark.parametrize("variant", [
    {},
    {"paged_kv": True, "kv_block": 8},
    {"speculate_k": 2},
    {"paged_kv": True, "kv_block": 8, "prefill_chunk": 16,
     "prefill_buckets": (64,)},
], ids=["dense", "paged", "speculate_k2", "chunked"])
def test_rounds_and_phase_bytes_equal_jax(weights, variant):
    kernel = bool(variant.get("paged_kv"))
    jax_decoder, port = both(weights, kernel, **variant)
    assert port._param_bytes == jax_decoder._param_bytes
    assert port._kv_bytes_per_t == jax_decoder._kv_bytes_per_t
    jax_rounds = record_rounds(jax_decoder)
    port_rounds = record_rounds(port)
    expected = serve(jax_decoder, STREAM, MIDSTREAM)
    got = serve(port, STREAM, MIDSTREAM)
    assert got == expected                         # greedy tokens unchanged
    assert port_rounds == jax_rounds
    assert port.profiler.phase_bytes == jax_decoder.profiler.phase_bytes
    assert port.profiler.rounds == jax_decoder.profiler.rounds
    nonzero = {name for name, s in port.profiler.phase_s.items() if s > 0}
    jax_nonzero = {name for name, s in jax_decoder.profiler.phase_s.items()
                   if s > 0}
    # "other" is whatever the marks left: either side may leave none
    assert nonzero - {"other"} == jax_nonzero - {"other"}
    dispatch = "spec_verify" if variant.get("speculate_k") \
        else "scan_dispatch"
    assert dispatch in nonzero and port.profiler.phase_bytes["host_sync"]
    if variant.get("prefill_chunk"):
        assert port.profiler.phase_bytes["extend_dispatch"] > 0


# -- the torch.profiler window --------------------------------------------------

def test_arm_trace_on_the_cpu_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(TP, "_trace", dict(TP._trace))
    TP.arm_trace(str(tmp_path), duration=0.0)
    assert TP.trace_state()["armed"]
    profiler = PhaseProfiler("port_trace")
    profiler.begin_round()
    profiler.mark("plan")
    profiler.commit_round()                  # opens the window
    state = TP.trace_state()
    assert state["active"] and not state["armed"], state
    torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    profiler.begin_round()
    profiler.abandon_round()                 # past `until`: closes it
    state = TP.trace_state()
    assert not state["active"] and state["captures"] == 1, state
    assert state["error"] is None
    with open(state["path"]) as f:
        document = json.load(f)
    names = {event.get("name") for event in document["traceEvents"]}
    assert "aten::mm" in names


def test_environment_arms_the_window(tmp_path, monkeypatch):
    monkeypatch.setattr(TP, "_trace", dict(TP._trace))
    monkeypatch.setenv("AIKO_PROFILE_TRACE", str(tmp_path))
    monkeypatch.setenv("AIKO_PROFILE_TRACE_S", "1.5")
    TP._env_arm()
    state = TP.trace_state()
    assert state["armed"] and state["duration"] == 1.5
    assert state["logdir"] == str(tmp_path)
