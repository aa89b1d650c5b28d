"""The port's health plane (observe/series.py) against the JAX package's.

The series cases of tests/test_health.py run on both packages with
equal results: the selector grammar, the scalar, histogram and sketch
rings' windowed reads, the store's birth seeding, first-snapshot
baseline, type flips, pruning and series bound, the SLO rules' multi-
window burn and level verdicts and their validation, and the
HealthAggregator's publisher round trip and alert life cycle.  Then one
seeded snapshot stream feeds both stores and both aggregators: latest,
maximum, delta, trend, windowed and fleet-merged quantiles, exemplars
and the published alert sequence must be equal."""

import json

import numpy as np
import pytest

from torch_ops_host import PACKAGES, Host, both


def series_of(package):
    return PACKAGES[package].series


@pytest.mark.parametrize("text", [
    "hop_seconds", "pipeline_hop_seconds{pipeline=chaos_call,kind=x}:p95",
    "h:p50", "f{a=1}", "g:p99.9"])
def test_selectors_equal_jax(text):
    both(lambda package: series_of(package).parse_selector(text))


def test_scalar_rings_equal_jax():
    def scenario(package):
        S = series_of(package)
        gauge = S.ScalarSeries("g", {}, "gauge")
        gauge.append(0.0, 5.0)
        out = [gauge.latest(10.0, 30.0), gauge.latest(100.0, 30.0)]
        counter = S.ScalarSeries("c", {}, "counter")
        counter.append(0.0, 1000.0)
        out.append(counter.delta(1.0, 30.0))
        counter.append(1.0, 1015.0)
        out.append(counter.delta(2.0, 30.0))
        ramp = S.ScalarSeries("g", {}, "gauge")
        for t in range(5):
            ramp.append(float(t), 10.0 * t)
        out += [ramp.trend(5.0, 30.0), ramp.maximum(5.0, 30.0)]
        return out
    assert both(scenario) == [5.0, None, 0.0, 15.0, pytest.approx(10.0),
                              40.0]


def test_histogram_ring_equal_jax():
    def scenario(package):
        S = series_of(package)
        ring = S.HistogramSeries("h", {}, bounds=(0.1, 1.0, 4.0))
        ring.append(0.0, (100, 0, 0, 0))
        ring.append(1.0, (100, 0, 3, 0))
        fresh = S.HistogramSeries("h", {}, bounds=(0.1, 1.0, 4.0))
        fresh.append(0.0, (100, 0, 0, 0))
        return (ring.delta_quantile(0.95, 2.0, 30.0),
                ring.delta_count(2.0, 30.0),
                fresh.delta_quantile(0.95, 1.0, 30.0),
                fresh.delta_quantile(0.95, 1.0, 30.0, baseline_empty=True))
    assert both(scenario) == (4.0, 3, None, 0.1)


def test_store_semantics_equal_jax():
    def scenario(package):
        S = series_of(package)
        out = []
        store = S.SeriesStore(window=30.0)
        store.append_snapshot("p1", {
            "other": {"type": "gauge",
                      "series": [{"labels": {}, "value": 1}]}}, t=0.0)
        store.append_snapshot("p1", {
            "shed_total": {"type": "counter",
                           "series": [{"labels": {}, "value": 15}]}},
            t=0.5)
        out.append(store.selector_delta("shed_total", 1.0, 30.0))
        first = S.SeriesStore(window=30.0)
        first.append_snapshot("p1", {
            "shed_total": {"type": "counter",
                           "series": [{"labels": {}, "value": 999}]}},
            t=0.0)
        out.append(first.selector_delta("shed_total", 1.0, 30.0))
        flip = S.SeriesStore(window=30.0)
        for t, entry in ((0.0, {"type": "histogram", "series": [{
                "labels": {}, "bounds": [1.0], "counts": [2, 0],
                "sum": 0.5, "count": 2}]}),
                (1.0, {"type": "gauge",
                       "series": [{"labels": {}, "value": 5.0}]}),
                (2.0, {"type": "histogram", "series": [{
                    "labels": {}, "bounds": [1.0], "counts": [3, 0],
                    "sum": 0.5, "count": 3}]})):
            flip.append_snapshot("p1", {"f": entry}, t=t)
            (_, ring), = flip.rings("f")
            out.append(type(ring).__name__)
        pruned = S.SeriesStore(window=5.0)
        pruned.append_scalar("dead", "g", {}, 0.0, 1.0)
        pruned.append_scalar("live", "g", {}, 20.0, 2.0)
        out += [pruned.prune(now=21.0), pruned.sources()]
        bounded = S.SeriesStore(window=5.0, max_series=2)
        for index in range(5):
            bounded.append_scalar("p", "g", {"i": str(index)}, 0.0, 1.0)
        out.append(len(bounded))
        return out
    assert both(scenario) == [15.0, 0.0, "HistogramSeries", "ScalarSeries",
                              "HistogramSeries", 1, ["live"], 2]


def feed_ratio(store, t, bad, good):
    store.append_snapshot("p1", {
        "bad_total": {"type": "counter",
                      "series": [{"labels": {}, "value": bad}]},
        "good_total": {"type": "counter",
                       "series": [{"labels": {}, "value": good}]},
    }, t=t)


def test_slo_rules_equal_jax():
    def scenario(package):
        S = series_of(package)
        rule = S.SLORule(name="r", kind="ratio", bad="bad_total",
                         good="good_total", objective=0.99,
                         pairs=((30.0, 5.0, 2.0),))
        store = S.SeriesStore(window=60.0)
        feed_ratio(store, 0.0, 0, 0)
        feed_ratio(store, 1.0, 10, 10)
        verdicts = [rule.evaluate(store, 2.0)]
        for t in (3.0, 5.0, 7.0, 9.0, 11.0):
            feed_ratio(store, t, 10, 10)
        verdicts.append(rule.evaluate(store, 11.0))
        quiet = S.SeriesStore(window=60.0)
        feed_ratio(quiet, 0.0, 0, 0)
        feed_ratio(quiet, 1.0, 0, 0)
        verdicts.append(rule.evaluate(quiet, 2.0))
        lat = S.SeriesStore(window=60.0)
        for t, counts in ((0.0, (5, 0, 0, 0)), (1.0, (5, 0, 2, 0))):
            lat.append_snapshot("p1", {
                "lat": {"type": "histogram", "series": [{
                    "labels": {}, "bounds": [0.1, 1.0, 4.0],
                    "counts": list(counts), "sum": 0.0,
                    "count": sum(counts)}]}}, t=t)
        level = S.SLORule(name="lat", kind="level", series="lat:p95",
                          threshold=2.0, window=30.0)
        verdicts.append(level.evaluate(lat, 2.0))
        errors = []
        for kwargs in ({"kind": "nope"}, {"kind": "ratio", "bad": "b"},
                       {"kind": "level"}):
            with pytest.raises(ValueError) as error:
                S.SLORule(name="x", **kwargs)
            errors.append(str(error.value))
        return verdicts, errors
    verdicts, _ = both(scenario)
    assert [v["breaching"] for v in verdicts] == [True, False, False, True]
    assert verdicts[1]["windows"][0]["burn_long"] >= 2.0


def test_publisher_round_trip_into_the_aggregator_equals_jax():
    def scenario(package):
        host = Host(package)
        m = host.m
        registry = m.metrics.MetricsRegistry()
        publisher_rt = host.runtime("rt_pub")
        aggregator_rt = host.runtime("rt_agg")
        counter = registry.counter("rt_events_total", labels={"kind": "x"})
        gauge = registry.gauge("rt_depth")
        histogram = registry.histogram("rt_seconds",
                                       buckets=(0.1, 1.0, 4.0))
        counter.inc(7)
        gauge.set(3)
        histogram.observe(2.0)
        publisher = m.export.MetricsPublisher(publisher_rt, interval=0.5,
                                              registry=registry)
        aggregator = m.series.HealthAggregator(
            aggregator_rt, interval=0.5, registry=m.metrics.MetricsRegistry())
        host.settle_virtual(2.0)
        store = aggregator.store
        (source, counter_ring), = store.rings("rt_events_total",
                                              {"kind": "x"})
        (_, gauge_ring), = store.rings("rt_depth")
        (_, histogram_ring), = store.rings("rt_seconds")
        out = [source, store.sources(), counter_ring.points[-1][1],
               gauge_ring.latest(host.engine.clock.now(), 30.0),
               tuple(histogram_ring.bounds)]
        counter.inc(5)
        histogram.observe(0.05)
        host.settle_virtual(1.0)
        now = host.engine.clock.now()
        out.append(store.selector_delta("rt_events_total{kind=x}", now, 2.0))
        aggregator.stop()
        publisher.stop()
        return out
    out = both(scenario)
    assert out[0] == "test/rt_pub/rt_pub" or out[0].endswith("rt_pub")
    assert out[2:] == [7, 3, (0.1, 1.0, 4.0), 5.0]


def test_alert_life_cycle_equals_jax():
    def scenario(package):
        host = Host(package)
        m = host.m
        registry = m.metrics.MetricsRegistry()
        publisher_rt = host.runtime("rt_pub2")
        aggregator_rt = host.runtime("rt_agg2")
        watcher_rt = host.runtime("rt_watch")
        bad = registry.counter("alert_bad_total")
        good = registry.counter("alert_good_total")
        good.inc()
        bad.inc(0)
        publisher = m.export.MetricsPublisher(publisher_rt, interval=0.5,
                                              registry=registry)
        rule = m.series.SLORule(name="bad-burn", kind="ratio",
                                bad="alert_bad_total",
                                good="alert_good_total", objective=0.9,
                                pairs=((8.0, 2.0, 1.0),))
        aggregator = m.series.HealthAggregator(
            aggregator_rt, rules=[rule], interval=0.5,
            registry=m.metrics.MetricsRegistry())
        fired = []
        aggregator.on_alert.append(lambda r, rec: fired.append(rec["state"]))
        retained = []
        watcher_rt.add_message_handler(
            lambda topic, payload: retained.append(json.loads(payload)),
            f"{watcher_rt.namespace}/{m.series.ALERT_TOPIC_PREFIX}/bad-burn")
        host.settle_virtual(2.0)
        firing = [aggregator.firing()]
        bad.inc(50)
        good.inc(5)
        host.settle_virtual(2.0)
        firing.append(aggregator.firing())
        host.settle_virtual(12.0)
        firing.append(aggregator.firing())
        aggregator.stop()
        publisher.stop()
        return firing, fired, dict(aggregator.fired), retained
    firing, fired, counts, retained = both(scenario)
    assert firing == [[], ["bad-burn"], []]
    assert fired == ["firing"] and counts == {"bad-burn": 1}
    assert [r["state"] for r in retained][-2:] == ["firing", "resolved"]


def snapshot_stream(seed: int, steps: int = 24):
    """A seeded stream of (source, t, snapshot) documents from three
    processes: a counter pair, a gauge, a histogram and a TTFT sketch
    payload made by each package's own Sketch from the same values."""
    rng = np.random.default_rng(seed)
    sources = ("test/h/a", "test/h/b", "test/h/c")
    stream = []
    bad = {s: 0 for s in sources}
    good = {s: 0 for s in sources}
    counts = {s: [0, 0, 0, 0] for s in sources}
    values = {s: [] for s in sources}
    for step in range(steps):
        for source in sources:
            bad[source] += int(rng.integers(0, 4 if step > 10 else 1))
            good[source] += int(rng.integers(1, 6))
            bucket = int(rng.integers(0, 4))
            counts[source][bucket] += int(rng.integers(1, 4))
            values[source] += [float(v) for v in rng.exponential(
                0.05 * (1 + step / 8), size=int(rng.integers(1, 6)))]
            stream.append((source, 0.5 * step + 0.01 * len(stream) % 0.5,
                           bad[source], good[source],
                           float(rng.integers(0, 50)), list(counts[source]),
                           list(values[source])))
    return stream


def snapshot_of(package, entry):
    S = PACKAGES[package]
    _, _, bad, good, depth, counts, values = entry
    sketch = S.sketch.Sketch("serving_ttft_seconds")
    for index, value in enumerate(values):
        sketch.observe(value, exemplar=f"tr{index:04d}")
    return {
        "bad_total": {"type": "counter",
                      "series": [{"labels": {}, "value": bad}]},
        "good_total": {"type": "counter",
                       "series": [{"labels": {}, "value": good}]},
        "event_mailbox_depth": {"type": "gauge",
                                "series": [{"labels": {}, "value": depth}]},
        "lat_seconds": {"type": "histogram", "series": [{
            "labels": {}, "bounds": [0.01, 0.1, 1.0], "counts": counts,
            "sum": 0.0, "count": sum(counts)}]},
        "serving_ttft_seconds": {"type": "sketch", "series": [{
            "labels": {"tenant": "t"}, **sketch.to_dict()}]},
    }


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_stream_reads_equal_jax(seed):
    stream = snapshot_stream(seed)

    def scenario(package):
        S = series_of(package)
        store = S.SeriesStore(window=60.0)
        reads = []
        for entry in stream:
            source, t = entry[0], entry[1]
            store.append_snapshot(source, snapshot_of(package, entry), t=t)
            now = t + 0.25
            merged = store.merged_sketch("serving_ttft_seconds", now, 5.0)
            reads.append((
                [(src, ring.latest(now, 5.0), ring.maximum(now, 5.0),
                  ring.trend(now, 5.0))
                 for src, ring in store.rings("event_mailbox_depth")],
                store.selector_delta("bad_total", now, 5.0),
                store.selector_delta("good_total", now, 30.0),
                [(src, ring.delta_quantile(q, now, 5.0))
                 for src, ring in store.rings("lat_seconds")
                 for q in (0.5, 0.95)],
                store.selector_level("lat_seconds:p95", now, 5.0),
                store.selector_level("serving_ttft_seconds:p95", now, 5.0),
                None if merged is None else
                (merged.count, merged.quantile(0.5), merged.quantile(0.99)),
                store.selector_exemplars("serving_ttft_seconds", now, 5.0)))
        return reads
    reads = both(scenario)
    assert any(r[6] is not None for r in reads)


@pytest.mark.parametrize("seed", [1, 4])
def test_seeded_stream_alert_sequence_equals_jax(seed):
    """The same snapshots, published retained by three runtimes on each
    package's broker, drive both HealthAggregators: the same alert
    records, in the same order, at the same virtual times."""
    stream = snapshot_stream(seed, steps=30)

    def scenario(package):
        host = Host(package)
        m = host.m
        publishers = {source: host.runtime(source.rsplit("/", 1)[-1])
                      for source in sorted({e[0] for e in stream})}
        rules = [
            m.series.SLORule(name="burn", kind="ratio", bad="bad_total",
                             good="good_total", objective=0.8,
                             pairs=((6.0, 1.5, 1.0),)),
            m.series.SLORule(name="ttft", kind="level",
                             series="serving_ttft_seconds:p95",
                             threshold=0.15, window=3.0),
            m.series.SLORule(name="lat", kind="level",
                             series="lat_seconds:p95", threshold=0.5,
                             window=3.0, for_seconds=1.0),
        ]
        aggregator = m.series.HealthAggregator(
            host.runtime("agg"), rules=rules, interval=0.5,
            registry=m.metrics.MetricsRegistry())
        records = []
        host.runtime("watch").add_message_handler(
            lambda topic, payload: records.append(
                (round(host.engine.clock.now(), 6), topic.rsplit("/", 1)[-1],
                 json.loads(payload)["state"])),
            f"test/{m.series.ALERT_TOPIC_PREFIX}/+")
        for entry in stream:
            source, t = entry[0], entry[1]
            if t > host.engine.clock.now():
                host.settle_virtual(t - host.engine.clock.now())
            runtime = publishers[source]
            runtime.publish(
                f"{runtime.topic_path}/{m.export.METRICS_TOPIC_SUFFIX}",
                json.dumps({"topic_path": source,
                            "snapshot": snapshot_of(package, entry)}),
                retain=True)
        host.settle_virtual(10.0)
        aggregator.stop()
        return records, dict(aggregator.fired)
    records, fired = both(scenario)
    assert records and sum(fired.values()) >= 1
