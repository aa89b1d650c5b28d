"""The port's chaos soak (aiko_services_tpu_torch/scripts/chaos_soak.py)
against the repo's scripts/chaos_soak.py, continued from
tests/test_torch_soak.py: the SLO breach that ships one flight dump, the
flooding tenant and the polite baseline on the admission gate, and the
migrate soak (a seeded preemption, resume on the standby, session KV
migration and the source's leak audit).  Each scenario runs in both
packages on the same seed; the port's report must equal the JAX
script's apart from the fields that read the wall clock or what the
process ran before, and pass what
tests/test_chaos_soak.py asserts of the JAX one.  Left out:
  - wall_seconds (every scenario);
  - telemetry.spans.*.total_ms and mean_ms (the SLO breach);
  - the directory of the dump's path in health.dumps (each package
    writes into a directory of its own; the file names are compared);
  - health.autoscaler.signals (the tenant soaks): hop_p95 reads the
    hops' latency histogram, which reads perf_counter (as the JAX
    script's comment on its queue-depth signal says), and every signal
    is the worst series of its family in the published snapshot of the
    process-wide registry, which holds the series other tests of the
    same worker left (a batch scheduler's wait, say);
  - health.rings.*.samples (the SLO breach): a flight recorder samples
    every series of its families in that registry, so the count grows
    with what the process ran before.  Spans and faults are compared.
The migrate soak runs on the real clock and its report holds counts,
token counts and parity verdicts only; the port's decoders run on the
JAX package's tiny-preset f32 weights, crossed through the bridge."""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import chaos_soak as J  # noqa: E402

from aiko_services_tpu.models import llama as JL  # noqa: E402
from aiko_services_tpu_torch import bridge  # noqa: E402
from aiko_services_tpu_torch.models import llama as TL  # noqa: E402
from aiko_services_tpu_torch.scripts import chaos_soak as T  # noqa: E402

from test_torch_soak import differences  # noqa: E402

torch.set_num_threads(1)


def without_wall_clock(report: dict) -> dict:
    report = json.loads(json.dumps(report))
    report.pop("wall_seconds")
    for stats in report.get("telemetry", {}).get("spans", {}).values():
        stats.pop("total_ms")
        stats.pop("mean_ms")
    health = report.get("health", {})
    for rule, path in health.get("dumps", {}).items():
        health["dumps"][rule] = os.path.basename(path)
    health.get("autoscaler", {}).pop("signals", None)
    for ring in health.get("rings", {}).values():
        ring.pop("samples")
    return report



def test_slo_breach_ships_one_flight_dump_as_jax(tmp_path):
    reports = {}
    for name, package in (("jax", J), ("torch", T)):
        directory = tmp_path / name
        directory.mkdir()
        options = {"device": "cpu"} if name == "torch" else {}
        reports[name] = package.run_soak(
            seed=11, frames=6, horizon=40.0,
            health_dump_dir=str(directory), **options)
    assert not differences(without_wall_clock(reports["torch"]),
                           without_wall_clock(reports["jax"]))

    report = reports["torch"]
    assert report["frames_lost"] == 0, report
    assert report["frames_recovered"] == 6
    health = report["health"]
    assert health["alerts_fired"] >= 1
    assert "hop-retry-burn" in health["alerts"]
    dumps = list((tmp_path / "torch").glob("*.json"))
    assert len(dumps) == 1
    assert health["dumps"] == {"hop-retry-burn": str(dumps[0])}

    with open(dumps[0]) as f:
        document = json.load(f)
    assert document["metadata"]["reason"] == "slo-breach:hop-retry-burn"
    events = document["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    samples = [e for e in events if e.get("ph") == "C"]
    faults = [e for e in events
              if e.get("ph") == "i" and e["name"].startswith("fault:")]
    assert spans and samples and faults
    kinds = {e["name"] for e in faults}
    assert "fault:partitioned" in kinds or "fault:drop" in kinds
    pid_names = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert {"caller", "serving1", "serving2"} <= pid_names
    by_trace: dict = {}
    for event in spans:
        trace_id = event["args"].get("trace_id")
        if trace_id:
            by_trace.setdefault(trace_id, set()).add(event["pid"])
    assert any(len(pids) >= 2 for pids in by_trace.values())


def test_tenant_flood_equals_jax():
    port = T.run_tenant_soak(seed=11)
    assert not differences(without_wall_clock(port), without_wall_clock(
        J.run_tenant_soak(seed=11)))
    assert port["flood"]["shed"] > 0
    health = port["health"]
    assert health["alerts_fired"] >= 1
    assert "admission-shed-burn" in health["alerts"]
    assert health["autoscaler"]["scale_ups"] >= 1
    assert port["polite"]["deadline_met_fraction"] == 1.0


def test_tenant_baseline_equals_jax():
    port = T.run_tenant_soak(seed=11, flood_frames=0)
    assert not differences(without_wall_clock(port), without_wall_clock(
        J.run_tenant_soak(seed=11, flood_frames=0)))
    assert port["flood"]["posted"] == 0
    assert port["polite"]["deadline_met_fraction"] == 1.0
    health = port["health"]
    assert health["alerts_fired"] == 0
    assert health["alerts"] == {}
    assert health["autoscaler"]["scale_ups"] == 0


def test_tenant_main_exit_rule(monkeypatch):
    # --tenants exits 0 only when the polite tenant shed nothing, the
    # flood shed, and the polite deadlines held
    verdicts = [({"shed": 0, "deadline_met_fraction": 1.0}, {"shed": 3}, 0),
                ({"shed": 1, "deadline_met_fraction": 1.0}, {"shed": 3}, 1),
                ({"shed": 0, "deadline_met_fraction": 1.0}, {"shed": 0}, 1),
                ({"shed": 0, "deadline_met_fraction": 0.9}, {"shed": 3}, 1)]
    for polite, flood, code in verdicts:
        monkeypatch.setattr(T, "run_tenant_soak",
                            lambda **_: {"polite": polite, "flood": flood})
        assert T.main(["--tenants"]) == code


def test_migrate_soak_equals_jax():
    config = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
    params = JL.llama_init(jax.random.PRNGKey(0), config)
    model = bridge.params_from_numpy(
        jax.tree.map(np.asarray, params),
        dataclasses.replace(TL.LLAMA_PRESETS["tiny"], max_seq_len=96),
        device="cpu")
    port = T.run_migrate_soak(seed=11, sessions=2, device="cpu",
                              params=model)
    assert not differences(without_wall_clock(port), without_wall_clock(
        J.run_migrate_soak(seed=11, sessions=2)))

    assert port["ok"], port
    assert port["alerts"] == ["preemption"]
    assert port["chaos"]["drains"] == 1
    victim = port["victim"]
    assert victim["lost_requests"] == 0
    assert victim["evacuated"] == 1
    assert 0 < victim["partial_tokens"] < 32
    assert victim["resume_parity"]
    migration = port["migration"]
    assert migration["offered"] == 2
    assert migration["migrated"] == 2
    assert migration["shipped_blocks"] == migration["blocks_pinned"] \
        == 12
    assert migration["handle_blocks"] == 0
    assert migration["installed_blocks"] == 12
    assert migration["dropped_chunks"] == 0
    assert migration["refused"] == 0
    assert port["dest"]["prefix_hit_tokens"] == 48
    assert port["dest"]["turn2_parity"]
    scaler = port["autoscaler"]
    assert scaler["shrink_refused_without_drain"]
    assert scaler["drains"] == 1
    assert scaler["straggler_delivered"]
    assert all(value == 0 for value in port["leaks"].values())


def test_migrate_main_exit_rule(monkeypatch):
    # --migrate exits on the report's own verdict, with the preset and
    # device passed through
    seen = []

    def stub(**options):
        seen.append(options)
        return {"ok": options["preset"] == "tiny"}

    monkeypatch.setattr(T, "run_migrate_soak", stub)
    assert T.main(["--migrate", "--device", "cpu"]) == 0
    assert T.main(["--migrate", "--device", "cpu", "--preset", "1b"]) == 1
    assert seen == [{"seed": 11, "preset": "tiny", "device": "cpu"},
                    {"seed": 11, "preset": "1b", "device": "cpu"}]
