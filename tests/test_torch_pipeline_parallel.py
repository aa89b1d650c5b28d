"""Pipeline parallelism on the port against the JAX package's.

StagedExecutor: three affine stages over the CPU's logical devices
against the sequential product and JAX's executor; submit() queues
without waiting (eight frames in flight, none forced) and collect()
retires them; a real Whisper (the test preset, JAX's weights through the
bridge, f32) staged encoder -> greedy decode gives JAX's single-program
tokens and lengths exactly.  gpipe_spmd over four gloo ranks (one spawn,
tests/torch_spmd.py), stage s applying tanh(x @ w[s]) to eight
microbatches, with the stacked weights passed whole and sharded over
the stage axis: equal to JAX's gpipe_spmd on four virtual devices and to
the sequential stages within 2e-5 (f32 products in other orders).
PE_WhisperASR with pp_stages = 2 gives the unstaged element's tokens."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.parallel import pipeline_parallel as JPP
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import parallel as TP
from aiko_services_tpu_torch.models import whisper as TW

import torch_spmd_cases as cases
from torch_spmd import run_ranks

torch.set_num_threads(1)


def test_staged_executor_matches_sequential_and_jax():
    stages = [(lambda p, x: x @ p, torch.eye(8) * 2.0),
              (lambda p, x: x + p, torch.ones(8)),
              (lambda p, x: x @ p, torch.eye(8) * 0.5)]
    executor = TP.StagedExecutor(stages, devices=TP.devices("cpu")[:3])
    frames = [torch.full((4, 8), float(i)) for i in range(5)]
    results = executor.map(frames)
    jax_executor = JPP.StagedExecutor(
        [(lambda p, x: x @ p, jnp.eye(8) * 2.0),
         (lambda p, x: x + p, jnp.ones(8)),
         (lambda p, x: x @ p, jnp.eye(8) * 0.5)],
        devices=jax.devices()[:3])
    want = jax_executor.map([jnp.full((4, 8), float(i)) for i in range(5)])
    for i, (result, reference) in enumerate(zip(results, want)):
        expected = (np.full((4, 8), float(i)) * 2.0 + 1.0) * 0.5
        np.testing.assert_allclose(result, expected, rtol=1e-6)
        np.testing.assert_array_equal(result, reference)
    assert executor.in_flight == 0


def test_staged_executor_overlaps_dispatch():
    stages = [(lambda p, x: x * p, torch.tensor(2.0))] * 2
    executor = TP.StagedExecutor(stages, devices=TP.devices("cpu")[:2])
    pending = [executor.submit(torch.ones((64, 64)) * i) for i in range(8)]
    assert executor.in_flight == 8          # all queued, none forced
    outs = [executor.collect(y) for y in pending]
    assert executor.in_flight == 0          # occupancy retires on collect
    np.testing.assert_allclose(outs[3], np.ones((64, 64)) * 12.0)


def test_stage_groups_raise_where_jax_does():
    for count, stages in ((8, 2), (8, 3), (1, 2), (4, 4)):
        devices = list(range(count))
        try:
            want = JPP.stage_device_groups(devices, stages)
        except ValueError as error:
            with pytest.raises(ValueError) as port_error:
                TP.stage_device_groups(devices, stages)
            assert str(port_error.value) == str(error)
        else:
            assert TP.stage_device_groups(devices, stages) == want


def test_staged_executor_carries_real_whisper():
    config = JW.WHISPER_PRESETS["test"]
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     TW.WhisperConfig(**{
                                         **vars(config),
                                         "dtype": "float32"}),
                                     device="cpu")
    t_config = model.config

    def stage_encode(p, mel):
        with torch.inference_mode():
            return TW.encode(p, t_config, mel)

    def stage_decode(p, audio):
        return TW.greedy_decode_from_audio(p, t_config, audio, max_tokens=6)

    executor = TP.StagedExecutor([(stage_encode, model),
                                  (stage_decode, model)],
                                 devices=TP.devices("cpu")[:2])
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((2, 64, config.n_mels)).astype(np.float32)
            for _ in range(3)]
    pending = [executor.submit(torch.from_numpy(mel)) for mel in mels]
    assert executor.in_flight == 3          # stages occupied concurrently
    staged = [executor.collect(y) for y in pending]
    for mel, (tokens, lengths, _) in zip(mels, staged):
        oracle = JW.greedy_decode_scored(params, config, jnp.asarray(mel),
                                         max_tokens=6)
        np.testing.assert_array_equal(tokens, np.asarray(oracle[0]))
        np.testing.assert_array_equal(lengths, np.asarray(oracle[1]))


def test_gpipe_spmd_matches_jax_and_sequential(tmp_path):
    num_stages, num_micro = 4, 8
    weights = (np.random.default_rng(0).standard_normal(
        (num_stages, 8, 8)) * 0.3).astype(np.float32)
    microbatches = np.random.default_rng(1).standard_normal(
        (num_micro, 2, 8)).astype(np.float32)
    ranks = run_ranks(cases.gpipe, num_stages, tmp_path, weights,
                      microbatches)

    mesh = JP.create_mesh({"stage": num_stages},
                          devices=jax.devices()[:num_stages])
    step = JPP.gpipe_spmd(lambda p, x: jnp.tanh(x @ p["w"]), mesh,
                          num_micro)
    from jax.sharding import NamedSharding, PartitionSpec as P
    want = np.asarray(step(jax.device_put(
        {"w": weights}, NamedSharding(mesh, P("stage"))), microbatches))
    expected = microbatches
    for stage in range(num_stages):
        expected = np.tanh(expected @ weights[stage])
    for full, sharded in ranks:
        np.testing.assert_allclose(full, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(full, expected, rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(sharded, full)


def test_asr_element_pp_stages_matches_unstaged():
    """PE_WhisperASR with pp_stages = 2 (mel + encoder stage -> decode
    stage over two groups of the CPU's logical devices) produces the
    fused program's tokens."""
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.pipeline import (
        Pipeline, parse_pipeline_definition)
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import (MemoryBroker,
                                                   MemoryMessage)

    def build(tag, pp_stages):
        engine = EventEngine(VirtualClock())
        broker = MemoryBroker()
        runtime = ProcessRuntime(
            name=f"pp_{tag}", engine=engine,
            transport_factory=lambda on_message, *_: MemoryMessage(
                on_message=on_message, broker=broker)).initialize()
        ComputeRuntime(runtime, f"compute_pp_{tag}", device="cpu")
        definition = parse_pipeline_definition({
            "version": 0, "name": f"p_pp_{tag}", "runtime": "python",
            "graph": ["(PE_WhisperASR)"],
            "parameters": {
                "PE_WhisperASR.preset": "test",
                "PE_WhisperASR.mode": "sync",
                "PE_WhisperASR.max_tokens": 6,
                "PE_WhisperASR.buckets": [64],
                "PE_WhisperASR.pp_stages": pp_stages,
                "PE_WhisperASR.compute": f"compute_pp_{tag}",
                "PE_WhisperASR.logprob_threshold": -1e9,
            },
            "elements": [
                {"name": "PE_WhisperASR", "input": [{"name": "mel"}],
                 "output": [{"name": "tokens"}, {"name": "text"}],
                 "deploy": {"local": {"class_name": "PE_WhisperASR"}}},
            ],
        })
        return engine, runtime, Pipeline(runtime, definition,
                                         stream_lease_time=0)

    mel = np.random.default_rng(0).standard_normal(
        (64, 80)).astype(np.float32)
    outputs = {}
    for tag, stages in (("flat", 0), ("staged", 2)):
        engine, runtime, pipeline = build(tag, stages)
        done = []
        pipeline.add_frame_handler(done.append)
        pipeline.create_stream("s0", lease_time=0)
        pipeline.post("process_frame", "s0", {"mel": mel})
        for _ in range(200):
            if done:
                break
            engine.clock.advance(0.01)
            engine.step()
        assert done, tag
        outputs[tag] = np.asarray(done[0].swag["tokens"])
        element = pipeline.graph.node("PE_WhisperASR").element
        program = element.compute.programs[element._program]
        assert (hasattr(element, "_stage_params")) == (stages == 2)
        assert program.scheduler.stats["batches"] == 1
        runtime.terminate()
    assert len(outputs["flat"]) > 0
    np.testing.assert_array_equal(outputs["flat"], outputs["staged"])
