# The port's interprocedural effect analysis, drift checkers and
# findings baseline, against the JAX package's where the case is
# package-neutral: provenance chains, waivers severing at every frame,
# static lock-order cycles, metric drift, the port's wire lock, baseline
# round trips and the CLI's exit codes.  The port's own cases: a host
# sync (.item(), .synchronize()) reached from a hot path.

import json
from pathlib import Path

import pytest

import aiko_services_tpu.analysis as JA
import aiko_services_tpu_torch.analysis as TA

REPO_ROOT = Path(__file__).resolve().parents[1]


def _records(findings):
    return [(f.rule, f.severity, f.line, f.message, f.chain)
            for f in findings]


def _effects(module, tmp_path, source, name="element.py"):
    (tmp_path / name).write_text(source)
    return module.effect_findings([tmp_path], root=tmp_path)


def _both(tmp_path, source):
    """The port's findings, after checking the JAX package's agree."""
    port = _effects(TA, tmp_path, source)
    assert _records(port) == _records(_effects(JA, tmp_path, source))
    return port


BLOCKING = """\
import time

class Element:
    def process_frame(self, stream, frame):
        self._flush(frame)

    def _flush(self, frame):
        self._write(frame)

    def _write(self, frame):
        time.sleep(0.1)
"""

NEUTRAL = {
    "blocking_two_deep": (BLOCKING, ["lint-blocking-call"], 3),
    "wall_clock_two_deep": ("""\
import time

class Element:
    def start_stream(self, stream, stream_id):
        self._stamp()

    def _stamp(self):
        return self._now()

    def _now(self):
        return time.time()
""", ["lint-wall-clock"], 3),
    "hot_alloc_two_deep": ("""\
import numpy as np

class Decoder:
    # graft: hot-path
    def pump(self):
        self._stage()

    def _stage(self):
        return self._gather()

    def _gather(self):
        return np.zeros((4, 4))
""", ["lint-hot-alloc"], 3),
    "handler_registration_root": ("""\
import time

class Service:
    def __init__(self, engine):
        engine.add_timer_handler(self._tick, 0.1)

    def _tick(self):
        self._drain()

    def _drain(self):
        time.sleep(0.5)
""", ["lint-blocking-call"], 2),
    "subprocess_through_partial": ("""\
import functools
import subprocess

class Element:
    def process_frame(self, stream, frame):
        run = functools.partial(self._spawn, frame)
        run()

    def _spawn(self, frame):
        subprocess.run(["true"])
""", ["lint-blocking-call"], 2),
    "depth_zero_left_to_syntax": ("""\
import time

class Element:
    def process_frame(self, stream, frame):
        time.sleep(0.1)
""", [], 0),
    "leaf_waiver": (BLOCKING.replace(
        "time.sleep(0.1)",
        "time.sleep(0.1)  # graft: disable=lint-blocking-call"), [], 0),
    "call_site_waiver": (BLOCKING.replace(
        "self._flush(frame)",
        "self._flush(frame)  # graft: disable=lint-blocking-call"), [], 0),
    "root_def_waiver": (BLOCKING.replace(
        "def process_frame(self, stream, frame):",
        "def process_frame(self, stream, frame):"
        "  # graft: disable=lint-blocking-call"), [], 0),
    "other_rule_waiver": (BLOCKING.replace(
        "time.sleep(0.1)",
        "time.sleep(0.1)  # graft: disable=lint-hot-alloc"),
        ["lint-blocking-call"], 3),
}


@pytest.mark.parametrize("name", sorted(NEUTRAL))
def test_neutral_effect_fixture_gives_the_same_findings(tmp_path, name):
    source, rules, frames = NEUTRAL[name]
    findings = _both(tmp_path, source)
    assert [f.rule for f in findings] == rules
    if rules:
        assert len(findings[0].chain) == frames


def test_lock_order_cycle_in_both(tmp_path):
    findings = _both(tmp_path, """\
class Cache:
    def one(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def two(self):
        with self._b_lock:
            self._take_a()

    def _take_a(self):
        with self._a_lock:
            pass
""")
    assert [(f.rule, f.severity) for f in findings] == \
        [("lint-lock-order", "warning")]
    assert "Cache._a_lock" in findings[0].message
    assert "Cache._b_lock" in findings[0].message


# -- host syncs: the port's transfers effect --------------------------------

READBACK = """\
class Decoder:
    # graft: hot-path
    def pump(self):
        self._plan()

    def _plan(self):
        return self._count()

    def _count(self):
        return self.lengths.max().item()
"""


def test_item_two_calls_deep_from_a_hot_path(tmp_path):
    findings = _effects(TA, tmp_path, READBACK)
    assert [f.rule for f in findings] == ["lint-host-transfer"]
    finding = findings[0]
    assert "hot path 'Decoder.pump'" in finding.message
    assert "2 call(s) deep" in finding.message
    assert len(finding.chain) == 3
    assert "Decoder._plan" in finding.chain[1]
    assert ".item()" in finding.chain[2]


def test_waiver_on_an_intermediate_call_severs_the_sync(tmp_path):
    source = READBACK.replace(
        "return self._count()",
        "return self._count()  # graft: disable=lint-host-transfer")
    assert _effects(TA, tmp_path, source) == []
    # a waiver for another rule severs nothing
    source = READBACK.replace(
        "return self._count()",
        "return self._count()  # graft: disable=lint-hot-alloc")
    assert [f.rule for f in _effects(TA, tmp_path, source)] == \
        ["lint-host-transfer"]


def test_event_sync_is_a_host_transfer_and_a_blocking_call(tmp_path):
    findings = _effects(TA, tmp_path, """\
import torch

class Element:
    def process_frame(self, stream, frame):
        self._wait()

    def _wait(self):
        torch.cuda.synchronize()
""")
    assert sorted(f.rule for f in findings) == \
        ["lint-blocking-call", "lint-host-transfer"]


def test_reachable_leaves_names_every_leaf_waived_or_not(tmp_path):
    (tmp_path / "element.py").write_text("""\
class Decoder:
    # graft: hot-path
    def pump(self):
        self._fetch()
        self._count()

    def _fetch(self):
        # graft: disable=lint-host-transfer
        self.done.synchronize()

    def _count(self):
        return self.lengths.item()
""")
    from aiko_services_tpu_torch.analysis.callgraph import build_graph
    from aiko_services_tpu_torch.analysis.effects import EffectAnalysis
    analysis = EffectAnalysis(build_graph([tmp_path], tmp_path)).run()
    leaves = analysis.reachable_leaves("element::Decoder.pump", "transfers")
    assert [(leaf.split(" → ")[0].rsplit(" ", 1)[1], waived)
            for leaf, waived in leaves] == \
        [("Decoder._count", False), ("Decoder._fetch", True)]


# -- lint-metric-drift (invented family names: the drift corpus counts
#    every mention in tests/*.py) -------------------------------------------

def _drift(module, tmp_path, creator, consumer):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "metrics_mod.py").write_text(creator)
    (tmp_path / "chip_smoke.py").write_text(consumer)
    return module.metric_drift_findings(
        [pkg / "metrics_mod.py", tmp_path / "chip_smoke.py"], tmp_path)


def test_renamed_family_consumed_by_chip_smoke_is_an_error(tmp_path):
    findings = _drift(
        TA, tmp_path,
        'def build(registry):\n'
        '    return registry.counter("fixture_frames_seen_total")\n',
        'def report(registry):\n'
        '    return registry.value("fixture_frames_total")\n')
    errors = [f for f in findings if f.severity == TA.ERROR]
    assert len(errors) == 1
    assert "fixture_frames_total" in errors[0].message
    assert errors[0].path.endswith("chip_smoke.py")
    assert any("fixture_frames_seen_total" in f.message
               for f in findings if f.severity == TA.WARNING)


@pytest.mark.parametrize("consumer, errors", [
    ('def report(registry):\n'
     '    return registry.value("fixture_frames_total")\n', 0),
    ('def report(registry):\n'
     '    # graft: disable=lint-metric-drift\n'
     '    return registry.value("fixture_scraped_total")\n', 0),
])
def test_drift_clean_and_waived_like_jax(tmp_path, consumer, errors):
    creator = ('def build(registry):\n'
               '    return registry.counter("fixture_frames_total")\n')
    port = _drift(TA, tmp_path, creator, consumer)
    (tmp_path / "bench.py").write_text(consumer)
    jax = JA.metric_drift_findings(
        [tmp_path / "pkg" / "metrics_mod.py", tmp_path / "bench.py"],
        tmp_path)
    assert [(f.rule, f.severity) for f in port] == \
        [(f.rule, f.severity) for f in jax]
    assert len([f for f in port if f.severity == TA.ERROR]) == errors


# -- lint-wire-schema: the port's lock --------------------------------------

def test_fresh_port_lock_is_clean_and_drift_fails(tmp_path):
    lock = TA.write_wire_lock(tmp_path / "wire_schema.lock")
    assert TA.wire_schema_findings(REPO_ROOT, lock_path=lock) == []
    document = json.loads(lock.read_text())
    document["buffer_marker_arity"] = 8
    lock.write_text(json.dumps(document))
    findings = TA.wire_schema_findings(REPO_ROOT, lock_path=lock)
    assert [f.severity for f in findings] == [TA.ERROR]
    assert "buffer_marker_arity" in findings[0].message
    assert "aiko_services_tpu_torch" in findings[0].path


def test_missing_port_lock_names_the_ports_command(tmp_path):
    findings = TA.wire_schema_findings(
        REPO_ROOT, lock_path=tmp_path / "absent.lock")
    assert [f.severity for f in findings] == [TA.ERROR]
    assert "aiko_services_tpu_torch.analysis --update-wire-lock" in \
        findings[0].message


# -- baseline and CLI -------------------------------------------------------

def test_baseline_round_trip_matches_jax(tmp_path):
    findings = [TA.Finding("lint-print", TA.ERROR, str(tmp_path / "a.py"),
                           3, "bare print( at a.py:3")]
    path = tmp_path / "baseline.json"
    TA.write_baseline(path, findings, tmp_path)
    jax_path = tmp_path / "jax_baseline.json"
    JA.write_baseline(jax_path, [JA.Finding(*(
        getattr(findings[0], key) for key in
        ("rule", "severity", "path", "line", "message")))], tmp_path)
    assert path.read_text() == jax_path.read_text()
    shifted = TA.Finding("lint-print", TA.ERROR, str(tmp_path / "a.py"),
                         9, "bare print( at a.py:9")
    entries = TA.load_baseline(path)
    assert TA.apply_baseline([shifted], entries, tmp_path, path) == []
    stale = TA.apply_baseline([], entries, tmp_path, path)
    assert [f.rule for f in stale] == ["baseline-stale"]


@pytest.mark.parametrize("argv, code", [
    ([], 2),
    (["--update-baseline"], 2),
    (["--rules"], 0),
])
def test_cli_usage_codes_match_jax(argv, code, capsys):
    assert TA.main(argv) == JA.main(argv) == code


def test_cli_strict_json_and_baseline_flow(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import threading\nlock = threading.Lock()\n")
    assert TA.main(["--lint", str(bad), "--format", "json"]) == 1
    document = json.loads(capsys.readouterr().out)
    assert [record["rule"] for record in document] == ["lint-raw-lock"]
    assert "aiko_services_tpu_torch.utils.Lock" in document[0]["message"]
    baseline = tmp_path / "baseline.json"
    assert TA.main(["--lint", str(bad), "--baseline", str(baseline),
                    "--update-baseline"]) == 0
    assert TA.main(["--lint", str(bad), "--baseline", str(baseline)]) == 0
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert TA.main(["--lint", str(good), "--baseline", str(baseline)]) == 0
    assert TA.main(["--lint", str(good), "--baseline", str(baseline),
                    "--strict"]) == 1
    bad_baseline = tmp_path / "broken.json"
    bad_baseline.write_text("not json")
    assert TA.main(["--lint", str(good),
                    "--baseline", str(bad_baseline)]) == 2
    dead = tmp_path / "dead.json"
    dead.write_text(json.dumps({
        "version": 0, "name": "p", "runtime": "python",
        "graph": ["(PE_A PE_B)"],
        "elements": [{"name": "PE_A",
                      "output": [{"name": "x"}, {"name": "unused"}]},
                     {"name": "PE_B", "input": [{"name": "x"}]}]}))
    assert TA.main(["--pipeline", str(dead)]) == 0
    assert TA.main(["--pipeline", str(dead), "--strict"]) == 1
