# The port's own graft-check gate at HEAD: every analysis layer over the
# port package and chip_smoke.py, strict, against the port's committed
# baseline; the port's wire snapshot against the JAX package's lock (one
# wire, two packages); and the serving round's one allowed host sync.

import contextlib
import io
import json
from pathlib import Path

import pytest

from aiko_services_tpu_torch.analysis import main, wire_schema_snapshot
from aiko_services_tpu_torch.analysis.callgraph import build_graph
from aiko_services_tpu_torch.analysis.effects import EffectAnalysis

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "aiko_services_tpu_torch"
BASELINE = "aiko_services_tpu_torch/analysis/baseline.json"
PUMP = "aiko_services_tpu_torch.serving::ContinuousDecoder.pump"


@pytest.fixture(scope="module")
def gate():
    """The gate's exit code and output, run once for the module."""
    with contextlib.redirect_stdout(io.StringIO()) as output:
        code = main(["--self-check", "--strict", "--baseline",
                     str(REPO_ROOT / BASELINE)])
    return code, output.getvalue().strip()


def test_port_gate_strict_baseline_exits_zero_at_head(gate):
    code, output = gate
    assert code == 0, output
    assert output.endswith("graft-check: 0 finding(s), 0 error(s)")


def test_baseline_entries_are_port_paths_or_examples():
    entries = json.loads((REPO_ROOT / BASELINE).read_text())["entries"]
    for key in entries:
        rule, path, _ = key.split("|", 2)
        assert path.startswith(("aiko_services_tpu_torch/", "examples/")), \
            key
        assert rule in ("graph-dead-output", "lint-metric-drift",
                        "lint-hot-alloc"), key


def test_wire_snapshot_equals_the_jax_lock():
    jax_lock = REPO_ROOT / "aiko_services_tpu" / "analysis" / \
        "wire_schema.lock"
    port_lock = PORT / "analysis" / "wire_schema.lock"
    assert wire_schema_snapshot() == json.loads(jax_lock.read_text())
    assert port_lock.read_bytes() == jax_lock.read_bytes()


def test_pump_reaches_exactly_one_waived_sync():
    """Every host sync the serving round reaches, waivers ignored on the
    way: the one it is allowed (_finish_fetch's event wait), waived."""
    analysis = EffectAnalysis(build_graph(
        [PORT, REPO_ROOT / "chip_smoke.py"], REPO_ROOT)).run()
    leaves = analysis.reachable_leaves(PUMP, "transfers")
    assert len(leaves) == 1, leaves
    leaf, waived = leaves[0]
    assert "ContinuousDecoder._finish_fetch → done.synchronize()" in leaf
    assert waived
    assert PUMP in analysis.graph.hot_roots
    assert PUMP in analysis.graph.event_roots


def test_no_serving_round_reaches_a_kernel_build():
    """Nothing the serving round reaches starts a process: a decoder
    builds its kernel library at construction, and the rounds launch
    through a lookup that never builds (ops/kernels.py load)."""
    analysis = EffectAnalysis(build_graph(
        [PORT, REPO_ROOT / "chip_smoke.py"], REPO_ROOT)).run()
    leaves = analysis.reachable_leaves(PUMP, "blocks")
    assert leaves, "the round's event wait is a blocking leaf"
    assert not [leaf for leaf, _ in leaves if "subprocess" in leaf], leaves
    assert all(waived for _, waived in leaves), leaves
