"""The methods and flags the port's host modules gained to match the JAX
package's surface, each run call for call beside its JAX counterpart on
the CPU, with the same results:

  - observe/tracing.py Tracer.span: a record on exit (also when the
    section raises), a child span of a given context, a no-op when
    disabled; the same records (names, ids, parents, fields) and stats;
  - observe/metrics.py Histogram.quantile: the upper bound of the bucket
    holding the q-th observation over seeded observations, the last
    bound on overflow, 0.0 with none — exactly equal;
  - transport/memory.py MemoryBroker.reset: the same deliveries and
    retained messages before and after a reset;
  - serving.py PrefixKVCache.layout: None before the first bind, the
    bound tuple after it, the same refusal of a second layout;
  - native/__init__.py NATIVE_AVAILABLE: JAX's value, resolved at the
    first read and never at import."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from aiko_services_tpu import serving as JServing
from aiko_services_tpu.observe import metrics as JMetrics
from aiko_services_tpu.observe import tracing as JTracing
from aiko_services_tpu.transport import memory as JMemory
from aiko_services_tpu_torch import serving as TServing
from aiko_services_tpu_torch.observe import metrics as TMetrics
from aiko_services_tpu_torch.observe import tracing as TTracing
from aiko_services_tpu_torch.transport import memory as TMemory

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (JTracing, JMetrics, JMemory, JServing),
            "torch": (TTracing, TMetrics, TMemory, TServing)}


# -- Tracer.span --------------------------------------------------------------

def _span_script(package):
    tracing = PACKAGES[package][0]
    tracer = tracing.Tracer(enabled=False)
    with tracer.span("off") as value:
        assert value is None
    tracer.enable()
    context = tracing.TraceContext("t" * 32, "s" * 16, "p" * 16, None)
    with tracer.span("plain", cat="host", proc="p0", args={"n": 1}):
        pass
    with tracer.span("child", context=context, cat="hop"):
        pass
    with pytest.raises(KeyError):
        with tracer.span("raised", context=context):
            raise KeyError("section")
    records = []
    for span in tracer.spans:
        assert span.dur >= 0.0
        child = span.span_id not in ("", context.span_id)
        records.append((span.name, span.trace_id,
                        span.span_id if not child else "<new>",
                        span.parent_id, span.cat, span.proc, span.args))
    tracer.disable()
    with tracer.span("off again"):
        pass
    stats = {name: entry["count"] for name, entry in tracer.stats().items()}
    return records, stats, len(tracer.spans)


def test_tracer_span_records_as_jax_does():
    port = _span_script("torch")
    assert port == _span_script("jax")
    records, stats, count = port
    assert [r[0] for r in records] == ["plain", "child", "raised"]
    assert records[1][2] == "<new>" and records[1][3] == "s" * 16
    assert stats == {"plain": 1, "child": 1, "raised": 1} and count == 3


# -- Histogram.quantile -------------------------------------------------------

QUANTILES = (0.0, 0.01, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0)


def _quantiles(package, seed, buckets):
    metrics = PACKAGES[package][1]
    histogram = metrics.Histogram("h", {}, buckets=buckets)
    out = [[histogram.quantile(q) for q in QUANTILES]]
    rng = np.random.default_rng(seed)
    for value in rng.lognormal(-4.0, 2.0, size=500):
        histogram.observe(float(value))
        if rng.random() < 0.05:
            out.append([histogram.quantile(q) for q in QUANTILES])
    out.append([histogram.quantile(q) for q in QUANTILES])
    return out


@pytest.mark.parametrize("buckets", [None, (0.001, 0.01, 0.1)],
                         ids=["latency", "overflowing"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantile_matches_jax(seed, buckets):
    port = _quantiles("torch", seed, buckets)
    assert port == _quantiles("jax", seed, buckets)
    assert port[0] == [0.0] * len(QUANTILES)
    if buckets is not None:                 # overflow: the last bound
        assert port[-1][-1] == buckets[-1]


# -- MemoryBroker.reset -------------------------------------------------------

def _broker_script(package):
    memory = PACKAGES[package][2]
    broker = memory.MemoryBroker()
    log = []

    def client(name, subscriptions=()):
        message = memory.MemoryMessage(
            on_message=lambda t, p: log.append((name, t, p)),
            subscriptions=subscriptions, broker=broker)
        message.connect()
        return message

    first = client("first", ["a/#", "b/x"])
    broker.mark_data_plane("d/#")
    first.publish("a/1", "one", retain=True)
    first.publish("b/x", "bee")
    log.append(("retained", broker.retained("a/1")))
    broker.reset()
    log.append(("after reset", broker.retained("a/1"),
                broker._is_data_topic("d/1")))
    first.publish("a/2", "unrouted")        # its subscriptions are gone
    second = client("second", ["a/#"])      # no retained message replays
    second.publish("a/3", "three", retain=True)
    log.append(("retained", broker.retained("a/3")))
    third = client("third", ["a/#"])
    log.append(("stats", broker.stats["routed"]))
    second.disconnect()
    third.disconnect()
    return log


def test_memory_broker_reset_matches_jax():
    port = _broker_script("torch")
    assert port == _broker_script("jax")
    assert ("after reset", None, False) in port
    assert ("third", "a/3", "three") in port
    assert not any(entry[0] == "first" and entry[1] == "a/2"
                   for entry in port)


# -- PrefixKVCache.layout -----------------------------------------------------

def _layout_script(package):
    serving = PACKAGES[package][3]
    cache = serving.PrefixKVCache(block_tokens=4, max_bytes=1 << 20)
    log = [cache.layout]
    layout = (2, 2, 16, "float32", False, 4, 4)
    cache.bind(layout)
    log.append(cache.layout)
    cache.bind(layout)
    log.append(cache.layout)
    with pytest.raises(ValueError, match="already bound"):
        cache.bind((2, 2, 32, "float32", False, 4, 4))
    log.append(cache.layout)
    log.append(cache.wire_layout())
    return log


def test_prefix_cache_layout_matches_jax():
    port = _layout_script("torch")
    assert port == _layout_script("jax")
    assert port[0] is None
    assert port[1] == (2, 2, 16, "float32", False, 4, 4) == port[3]


# -- NATIVE_AVAILABLE ---------------------------------------------------------

def test_native_available_is_jaxs_flag_and_resolved_at_first_read():
    script = (
        "import aiko_services_tpu_torch.native as native\n"
        "before = native._load_attempted\n"
        "flag = native.NATIVE_AVAILABLE\n"
        "print(before, native._load_attempted, flag, "
        "'NATIVE_AVAILABLE' in native.__all__)\n")
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    from aiko_services_tpu.native import NATIVE_AVAILABLE as jax_flag
    assert result.stdout.split() == ["False", "True", str(jax_flag), "True"]
