"""The port's telemetry exporters (observe/export.py) against the JAX
package's: identical Prometheus text for registries fed the same seeded
series (counters, gauges, histograms, sketches; extra labels and label
escaping), the same Chrome trace events (names, ids, parents, phases,
timestamps) from the same spans, equal parse_retained_json, series_key
and series_quantile on seeded inputs, and MetricsPublisher publishing
the same retained documents on the same (jittered) virtual-time
schedule."""

import json

import numpy as np
import pytest

from torch_ops_host import PACKAGES, Host, both


def fed_registry(package: str, seed: int = 3):
    """A registry of `package` fed the same seeded series."""
    m = PACKAGES[package]
    rng = np.random.default_rng(seed)
    registry = m.metrics.MetricsRegistry()
    for route in ("a/b", 'quote"d', "new\nline"):
        registry.counter("req_total", "requests", {"route": route}).inc(
            int(rng.integers(1, 9)))
    registry.gauge("depth", "queue depth").set(float(rng.random()))
    registry.gauge("slots", labels={"decoder": "d0"}).set(
        int(rng.integers(0, 16)))
    hist = registry.histogram("dur_seconds", "durations",
                              buckets=m.metrics.log_buckets(0.001, 2.0, 8))
    for value in rng.exponential(0.02, size=40):
        hist.observe(float(value))
    sketch = registry.sketch("serving_ttft_seconds", "ttft",
                             labels={"decoder": "d0", "tenant": "t"})
    for value in rng.exponential(0.05, size=64):
        sketch.observe(float(value))
    registry.histogram("empty_seconds")
    return registry


def test_prometheus_text_equals_jax():
    def scenario(package):
        m = PACKAGES[package]
        registry = fed_registry(package)
        text = m.export.render_prometheus(registry)
        return text, m.export.render_snapshot_prometheus(
            registry.snapshot(), extra_labels={"topic_path": "test/h/p"})
    text, labelled = both(scenario)
    assert "# TYPE req_total counter" in text
    assert 'req_total{route="quote\\"d"}' in text
    assert "# TYPE serving_ttft_seconds summary" in text
    assert 'dur_seconds_bucket{le="+Inf"} 40' in text
    assert 'topic_path="test/h/p"' in labelled
    assert both(lambda package: PACKAGES[package].export
                .render_snapshot_prometheus({})) == ""


def test_default_registry_renders():
    from aiko_services_tpu_torch.observe import export, metrics
    metrics.default_registry().counter("port_export_probe_total").inc()
    assert "port_export_probe_total 1" in export.render_prometheus()


def spans(package: str):
    """The same spans recorded into `package`'s tracer: a root hop, a
    child with args, one under another process name, one with zero
    duration and one without a context."""
    m = PACKAGES[package]
    tracer = m.tracing.Tracer(enabled=True)
    root = m.tracing.TraceContext("t" * 16, "s1", "", None)
    child = m.tracing.TraceContext("t" * 16, "s2", "s1", None)
    tracer.record("hop:x", ts=1.0, dur=0.25, context=root, cat="hop",
                  proc="caller", args={"attempt": 1})
    tracer.record("serve", ts=1.05, dur=0.1, context=child, proc="server")
    tracer.record("call:f", ts=1.06, dur=0.0, context=child,
                  span_id="s3", cat="method", proc="server")
    tracer.record("orphan", ts=2.0, dur=0.5)
    return tracer


def test_chrome_trace_equals_jax(tmp_path):
    def scenario(package):
        m = PACKAGES[package]
        document = m.export.chrome_trace(spans(package))
        path = m.export.dump_chrome_trace(tmp_path / f"{package}.json",
                                          spans(package))
        with open(path) as f:
            assert json.load(f) == document
        return document
    document = both(scenario)
    events = document["traceEvents"]
    names = [(e["name"], e["ph"], e["pid"]) for e in events]
    assert names[0] == ("process_name", "M", 1)
    call = next(e for e in events if e["name"] == "call:f")
    assert call["args"]["parent_id"] == "s2" and call["dur"] == 0.001
    assert call["ts"] == 1.06e6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retained_json_series_key_and_quantile_equal_jax(seed):
    rng = np.random.default_rng(seed)
    payloads = [json.dumps({"snapshot": {}, "n": seed}),
                json.dumps({"snapshot": {}}).encode(),
                bytearray(b'{"rule": "r"}'), "[1, 2]", "not json",
                b"\xff\xfe", json.dumps({"other": 1})]
    labels = {f"k{i}": str(rng.integers(0, 9)) for i in
              range(int(rng.integers(0, 4)))}
    counts = [int(c) for c in rng.integers(0, 5, size=6)]
    series = [{"count": sum(counts), "counts": counts,
               "bounds": [0.01 * 2 ** i for i in range(5)]},
              {"count": 0, "counts": [0], "bounds": [1.0]},
              {"count": 3, "counts": [1, 2], "bounds": []}]

    def scenario(package):
        export = PACKAGES[package].export
        return ([export.parse_retained_json(p) for p in payloads],
                [export.parse_retained_json(p, require_key="snapshot")
                 for p in payloads],
                export.series_key("fam", labels), export.series_key("f", {}),
                [export.series_quantile(s, q) for s in series
                 for q in (0.0, 0.5, 0.95, 1.0)],
                export.METRICS_TOPIC_SUFFIX)
    both(scenario)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_metrics_publisher_equals_jax(jitter):
    """Retained snapshots on {topic_path}/0/metrics at the same virtual
    times (the jittered schedule's seed is the topic's crc32 on both),
    the same document, the publish-cost gauge, and stop."""
    def scenario(package):
        host = Host(package)
        m = host.m
        runtime = host.runtime("pub_host")
        registry = m.metrics.MetricsRegistry()
        frames = registry.counter("frames_total")
        publisher = m.export.MetricsPublisher(runtime, interval=1.0,
                                              registry=registry,
                                              jitter=jitter)
        seen = []
        spy = host.runtime("spy")

        def on_snapshot(topic, payload):
            document = m.export.parse_retained_json(payload)
            seen.append((round(host.engine.clock.now(), 6), topic,
                         document["process"], document["topic_path"],
                         document["snapshot"]["frames_total"]))
        spy.add_message_handler(on_snapshot,
                                f"{runtime.topic_path}/0/metrics")
        for _ in range(6):
            frames.inc()
            host.settle_virtual(1.0)
        publisher.stop()
        count = len(seen)
        host.settle_virtual(3.0)
        assert len(seen) == count
        gauge = registry.value("metrics_publish_seconds",
                               {"publisher": "pub_host"})
        assert gauge >= 0.0
        return seen
    seen = both(scenario)
    assert len(seen) >= 4
