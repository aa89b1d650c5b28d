"""The port's pipelined results path (compute.py, ops/batching.py) against
the JAX package's: the same script on both packages' BatchingScheduler,
and on both packages' ComputeRuntime on a virtual clock, with split()
held on a semaphore so that every step is deterministic.  The dispatch
gate stops at max_in_flight, force bypasses it, callbacks arrive on the
event loop through the results queue, a raising split fans its exception
out to every item and brings in_flight back to 0, first-call and service
times are recorded as in JAX, and the stats equal JAX's.  The pipelined
path's results equal the direct path's, and PE_WhisperASR with pipelined
true gives the tokens it gives without."""

import threading
import time

import numpy as np
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu.ops import batching as JB
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import compute as TC
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch.ops import batching as TB
from aiko_services_tpu_torch.pipeline import (Pipeline,
                                              parse_pipeline_definition)
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JComputeRuntime, JB),
    "torch": (TE, TM, TProcessRuntime, TC.ComputeRuntime, TB),
}
STATS = ("batches", "items", "batch_size_sum", "full_batches", "gated",
         "deadline_dispatches")


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def gate_script(package):
    """tests/test_ops.py's gate script, plus a process_batch that takes
    ownership (returns None) of every third batch."""
    batching = PACKAGES[package][4]
    clock = FakeClock()
    open_gate = [True]
    calls, results, owned = [], [], []

    def process(bucket, items):
        calls.append(len(items))
        if len(calls) % 3 == 0:
            owned.extend(items)
            return None
        return [i.payload for i in items]

    sched = batching.BatchingScheduler(
        process, batching.ShapeBuckets([100]), max_batch=2, max_wait=0.0,
        clock=clock, dispatch_gate=lambda: open_gate[0])
    for i in range(6):
        sched.submit(f"s{i}", i, 50, lambda sid, r: results.append((sid, r)))
    open_gate[0] = False
    trace = [sched.drain(), sched.stats["gated"], sched.pending()]
    open_gate[0] = True
    trace.append(sched.drain())
    open_gate[0] = False
    sched.submit("s9", 9, 50, lambda sid, r: results.append((sid, r)))
    trace += [sched.drain(), sched.drain(force=True)]
    for item in owned:
        item.callback(item.stream_id, "owned")
    return trace, calls, results, {key: sched.stats[key] for key in STATS}


def test_scheduler_gate_and_ownership_equal_jax():
    port = gate_script("torch")
    assert port == gate_script("jax")
    trace, calls, results, stats = port
    assert trace == [0, 1, 6, 6, 0, 1]
    assert stats["gated"] == 2 and stats["batches"] == 4
    assert sorted(results) == [("s0", 0), ("s1", 1), ("s2", 2), ("s3", 3),
                               ("s4", "owned"), ("s5", "owned"),
                               ("s9", 9)]


def _runtime(package, name):
    event, memory, runtime_class, compute_class, _ = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = runtime_class(name=name, engine=engine,
                            transport_factory=factory).initialize()
    compute = compute_class(runtime, "compute", **(
        {"device": "cpu"} if package == "torch" else {}))
    return engine, compute


def pump(engine, done, count, timeout=20.0):
    """Step the engine (its clock held: no scheduler timer fires) until
    `count` callbacks have arrived from the worker thread."""
    deadline = time.monotonic() + timeout
    while len(done) < count and time.monotonic() < deadline:
        engine.step()
        time.sleep(0.001)
    assert len(done) == count, f"{len(done)}/{count} delivered"


def runtime_script(package):
    """Seven items, batches of two, at most two batches in flight; split
    waits for the test to release each batch in turn."""
    engine, compute = _runtime(package, f"pipe_{package}")
    release = threading.Semaphore(0)
    loop_thread = threading.get_ident()

    def split(results, count):
        assert release.acquire(timeout=20)
        return [int(v) for v in np.asarray(results)[:count]]

    scheduler = compute.register_batched(
        "double", lambda _bucket, batch: batch * 2, [10],
        lambda _bucket, payloads: np.asarray(payloads), split,
        max_batch=2, max_wait=0.0, pipelined=True, max_in_flight=2)
    program = compute.programs["double"]
    done = []
    for i in range(7):
        compute.submit("double", f"s{i}", i, 5, lambda sid, r: done.append(
            (sid, r, threading.get_ident() == loop_thread)))
    trace = [scheduler.drain(), dict(program.in_flight), scheduler.pending()]
    trace.append(scheduler.drain())          # still gated
    release.release()
    pump(engine, done, 2)
    trace += [dict(program.in_flight), scheduler.drain(),
              scheduler.drain(force=True), dict(program.in_flight)]
    for _ in range(3):
        release.release()
    pump(engine, done, 7)
    trace.append(dict(program.in_flight))
    stats = {key: scheduler.stats[key] for key in STATS}
    timing = (sorted(program.first_call_times), len(program.recent_service),
              scheduler.service_estimate(10) is not None)
    compute.stop()
    return trace, done, stats, timing


def test_runtime_gate_force_and_delivery_equal_jax():
    port = runtime_script("torch")
    reference = runtime_script("jax")
    trace, done, stats, timing = port
    assert trace == reference[0]
    assert trace == [4, {"now": 2, "peak": 2}, 3, 0, {"now": 1, "peak": 2},
                     2, 1, {"now": 3, "peak": 3}, {"now": 0, "peak": 3}]
    assert done == reference[1]
    assert done == [(f"s{i}", 2 * i, True) for i in range(7)]
    assert stats == reference[2]
    assert stats["gated"] == 3 and stats["batches"] == 4
    # first call apart, later service times feed the estimate
    assert timing == reference[3] == ([10], 3, True)


def failing_script(package):
    engine, compute = _runtime(package, f"fail_{package}")

    def split(results, count):
        raise ValueError("split failed")

    compute.register_batched(
        "boom", lambda _bucket, batch: batch, [10],
        lambda _bucket, payloads: np.asarray(payloads), split,
        max_batch=4, max_wait=0.0, pipelined=True, max_in_flight=1)
    done = []
    for i in range(6):
        compute.submit("boom", f"s{i}", i, 5,
                       lambda sid, r: done.append((sid, repr(r))))
    program = compute.programs["boom"]
    program.scheduler.drain()
    pump(engine, done, 4)
    program.scheduler.drain()
    pump(engine, done, 6)
    in_flight = dict(program.in_flight)
    compute.stop()
    return done, in_flight


def test_a_raising_split_reaches_every_item_and_frees_the_gate():
    port = failing_script("torch")
    assert port == failing_script("jax")
    done, in_flight = port
    assert done == [(f"s{i}", "ValueError('split failed')")
                    for i in range(6)]
    assert in_flight == {"now": 0, "peak": 1}


def _sums(pipelined):
    engine, compute = _runtime("torch", f"eq_{pipelined}")

    def fn(_bucket, batch):
        return batch.sum(dim=1), batch.argmax(dim=1)

    def split(results, count):
        total, arg = (r.cpu().numpy() for r in results)
        return [(float(total[i]), int(arg[i])) for i in range(count)]

    compute.register_batched(
        "p", fn, [8], lambda _b, payloads: torch.from_numpy(
            np.stack(payloads)), split, max_batch=3, max_wait=0.0,
        pipelined=pipelined)
    rng = np.random.default_rng(0)
    done = {}
    for i in range(7):
        compute.submit("p", f"s{i}", rng.normal(size=8).astype(np.float32),
                       8, done.__setitem__)
    compute.programs["p"].scheduler.drain(force=True)
    pump(engine, done, 7)
    compute.stop()
    return done


def test_pipelined_results_equal_the_direct_paths():
    assert _sums(True) == _sums(False)


def test_to_host_leaves_cpu_results_alone():
    results = (torch.arange(3), [torch.ones(2)], 5)
    host, event = TC._to_host(results, torch.device("cpu"))
    assert host is results and event is None


def _asr_tokens(pipelined):
    engine, compute = _runtime("torch", f"asr_{pipelined}")
    pipeline = Pipeline(compute.runtime, parse_pipeline_definition({
        "version": 0, "name": "p_asr", "runtime": "python",
        "graph": ["(asr)"],
        "elements": [{"name": "asr", "parameters": {
            "preset": "test", "buckets": [100, 300], "max_batch": 4,
            "max_tokens": 6, "frontend": "audio", "pipelined": pipelined,
            "max_in_flight": 2, "logprob_threshold": -1e9,
            "compression_ratio_threshold": 1e9},
            "input": [{"name": "audio"}],
            "output": [{"name": "tokens"}, {"name": "text"}],
            "deploy": {"local": {"class_name": "PE_WhisperASR"}}}],
    }), stream_lease_time=0)
    element = pipeline.graph.node("asr").element
    rng = np.random.default_rng(1)
    answers = {}
    for i, samples in enumerate((8000, 12000, 40000, 9000, 30000)):
        element.submit(f"s{i}", answers.__setitem__,
                       audio=(rng.standard_normal(samples) * 3000)
                       .astype(np.int16))
    element.scheduler.drain(force=True)
    pump(engine, answers, 5)
    compute.stop()
    return {sid: answer["tokens"].tolist() for sid, answer in answers.items()}


def test_whisper_asr_pipelined_gives_the_same_tokens():
    assert _asr_tokens(True) == _asr_tokens(False)
