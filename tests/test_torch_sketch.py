"""The port's mergeable quantile sketches (observe/sketch.py) and the
registry's sketch family against the JAX package's.

The same seeded values (numpy, log-normal latencies with zeros mixed in)
and exemplar ids go into a JAX Sketch and a port Sketch: the serialised
form (to_dict, JSON-dumped) must be equal byte for byte, so
scripts/slo_report.py and the dashboard merge both packages' sketches;
quantiles, worst exemplars, collapsing at a small bin cap, merges,
merge_sketches' skip of a foreign alpha, from_dict's tolerance and the
registry snapshot must be equal too."""

import json

import numpy as np
import pytest

from aiko_services_tpu.observe import metrics as JM
from aiko_services_tpu.observe import sketch as JS
from aiko_services_tpu_torch.observe import metrics as TM
from aiko_services_tpu_torch.observe import sketch as TS

QUANTILES = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)


def values(seed: int, count: int = 2000) -> list:
    rng = np.random.default_rng(seed)
    out = np.exp(rng.normal(-4.0, 1.5, count))
    out[rng.random(count) < 0.03] = 0.0           # the zero bin
    return [float(v) for v in out]


def fill(sketch, seed: int, count: int = 2000):
    for i, value in enumerate(values(seed, count)):
        sketch.observe(value, exemplar=f"trace-{seed}-{i}"
                       if i % 3 == 0 else None)
    return sketch


def dumped(sketch) -> str:
    return json.dumps(sketch.to_dict(), sort_keys=True)


@pytest.mark.parametrize("seed,alpha,max_bins", [
    (0, 0.01, 2048), (1, 0.01, 2048), (2, 0.02, 2048), (3, 0.005, 2048),
    (4, 0.01, 16), (5, 0.05, 8)])
def test_sketches_serialise_byte_for_byte(seed, alpha, max_bins):
    jax_sketch = fill(JS.Sketch("lat", {"t": "a"}, alpha=alpha,
                                max_bins=max_bins), seed)
    port = fill(TS.Sketch("lat", {"t": "a"}, alpha=alpha,
                          max_bins=max_bins), seed)
    assert dumped(port) == dumped(jax_sketch)
    assert len(port.bins) <= max_bins
    for q in QUANTILES:
        assert port.quantile(q) == jax_sketch.quantile(q), q
    assert port.worst_exemplars() == jax_sketch.worst_exemplars()
    assert port.worst_exemplars(k=2, min_seq=1000) == \
        jax_sketch.worst_exemplars(k=2, min_seq=1000)


def test_merge_equals_one_sketch_fed_both_streams():
    jax_a, jax_b = fill(JS.Sketch(), 10), fill(JS.Sketch(), 11)
    port_a, port_b = fill(TS.Sketch(), 10), fill(TS.Sketch(), 11)
    port_a.merge(port_b)
    jax_a.merge(jax_b)
    assert dumped(port_a) == dumped(jax_a)
    both = TS.Sketch()
    for value in values(10) + values(11):
        both.observe(value)
    assert port_a.bins == both.bins and port_a.count == both.count
    with pytest.raises(ValueError, match="different gamma"):
        port_a.merge(TS.Sketch(alpha=0.02))


def test_merge_sketches_skips_foreign_alpha_and_none():
    parts = [fill(TS.Sketch(), 20), None, fill(TS.Sketch(alpha=0.05), 21),
             fill(TS.Sketch(), 22)]
    jax_parts = [fill(JS.Sketch(), 20), None,
                 fill(JS.Sketch(alpha=0.05), 21), fill(JS.Sketch(), 22)]
    merged = TS.merge_sketches(parts)
    assert dumped(merged) == dumped(JS.merge_sketches(jax_parts))
    assert merged.count == 4000
    assert TS.merge_sketches([]) is None and TS.merge_sketches([None]) \
        is None


def test_from_dict_round_trip_and_tolerance():
    port = fill(TS.Sketch(), 30)
    jax_sketch = fill(JS.Sketch(), 30)
    # each package reads the other's wire form
    assert dumped(TS.Sketch.from_dict(jax_sketch.to_dict())) == \
        dumped(port)
    assert dumped(JS.Sketch.from_dict(port.to_dict())) == \
        dumped(jax_sketch)
    assert TS.Sketch.from_dict({"alpha": "x"}) is None
    assert TS.Sketch.from_dict({"bins": {"a": 1}}) is None
    empty = TS.Sketch()
    assert empty.quantile(0.5) is None and empty.value == 0
    port.clear()
    assert port.count == 0 and port.bins == {} and not port.exemplars


def test_registry_sketch_family_and_snapshot():
    jax_registry, port_registry = JM.MetricsRegistry(), TM.MetricsRegistry()
    for registry, module in ((jax_registry, JS), (port_registry, TS)):
        for tenant in ("a", "b"):
            sketch = registry.sketch(
                "serving_ttft_seconds", "ttft",
                labels={"decoder": "d", "tenant": tenant})
            assert isinstance(sketch, module.Sketch)
            fill(sketch, 40 if tenant == "a" else 41, 300)
        registry.counter("c", labels={"k": "v"}).inc(3)
    port_snapshot = port_registry.snapshot()
    jax_snapshot = jax_registry.snapshot()
    assert json.dumps(port_snapshot, sort_keys=True) == \
        json.dumps(jax_snapshot, sort_keys=True)
    assert port_registry.value("serving_ttft_seconds",
                               {"decoder": "d", "tenant": "a"}) == 300
    with pytest.raises(ValueError, match="already registered"):
        port_registry.gauge("serving_ttft_seconds")
