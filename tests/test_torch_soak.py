"""The port's chaos soak (aiko_services_tpu_torch/scripts/chaos_soak.py)
against the repo's scripts/chaos_soak.py: the speech pipeline across two
runtimes over a ChaosBroker, on the memory transport, over negotiated
peer channels, and over MQTT with the serving fleet behind the
autoscaler.  Each scenario runs in both packages on the same seed, and
the port's report must equal the JAX script's, apart from the fields
that read the wall clock:
  - wall_seconds;
  - telemetry.spans.*.total_ms and telemetry.spans.*.mean_ms;
  - the autoscaler's hold decisions in telemetry.metrics
    (autoscaler_decisions_total{action=hold,...}): whether a tick holds
    at the floor ("at-min", "cooldown"), holds in the dead band, or
    counts nothing (below the floor, in cooldown) depends on whether
    its window was quiet, which reads the hops' p95 latency in wall
    seconds.  Its scale-ups ({action=up,...}) are compared.
Left out too, as the process numbers them (each package counts the
runtimes and channels its process made before, in other tests of the
same worker): the topic paths and channel ids of peer.caller_pins,
whose count is compared.
The port's report must then pass what tests/test_chaos_soak.py asserts of
the JAX one.  The port's runtimes run on the CPU (device="cpu"); the
remaining soak scenarios are in tests/test_torch_soak_serving.py."""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import chaos_soak as J  # noqa: E402

from aiko_services_tpu_torch.scripts import chaos_soak as T  # noqa: E402

torch.set_num_threads(1)

SOAK = {"seed": 11, "frames": 6, "horizon": 40.0}


def without_wall_clock(report: dict) -> dict:
    """The report with its wall-clock fields taken out."""
    report = json.loads(json.dumps(report))
    report.pop("wall_seconds")
    for stats in report["telemetry"]["spans"].values():
        stats.pop("total_ms")
        stats.pop("mean_ms")
    metrics = report["telemetry"]["metrics"]
    for key in [key for key in metrics if key.startswith(
            "autoscaler_decisions_total{action=hold,")]:
        metrics.pop(key)
    if "peer" in report:
        report["peer"]["caller_pins"] = len(report["peer"]["caller_pins"])
    return report


def differences(got, want, path="report") -> list:
    """The paths at which two JSON-like values differ."""
    if isinstance(got, dict) and isinstance(want, dict):
        return [line for key in sorted(set(got) | set(want), key=str)
                for line in differences(got.get(key), want.get(key),
                                        f"{path}.{key}")]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def both(**options) -> dict:
    """The scenario in both packages; asserts the reports equal apart
    from the wall clock and returns the port's."""
    reference = J.run_soak(**SOAK, **options)
    port = T.run_soak(**SOAK, device="cpu", **options)
    assert not differences(without_wall_clock(port),
                           without_wall_clock(reference))
    assert port["telemetry"]["spans"].keys() == \
        reference["telemetry"]["spans"].keys()
    return port


def assert_recovered(report: dict) -> None:
    assert report["frames_sent"] == 6
    assert report["frames_lost"] == 0, report
    assert report["frames_recovered"] == 6
    assert report["texts_returned"] == 6
    assert report["pending_hops"] == 0
    assert report["leaked_hop_leases"] == 0


def test_speech_soak_equals_jax():
    report = both()
    assert_recovered(report)
    assert report["transport"] == "memory"
    faults = report["faults_injected"]
    assert faults.get("partitioned", 0) > 0
    assert faults.get("duplicate", 0) > 0
    caller = report["caller_recovery"]
    assert caller["retries"] > 0
    assert caller["failovers"] >= 1
    assert caller["dup_replies"] + \
        report["serving_recovery"]["dup_requests"] > 0
    # the span stats the report embeds come from the port's tracer
    assert report["telemetry"]["spans"]
    assert all(stats["count"] > 0
               for stats in report["telemetry"]["spans"].values())


def test_peer_soak_equals_jax():
    report = both(peer=True)
    assert_recovered(report)
    peer = report["peer"]
    assert peer["mid_stream_kills"] >= 1
    assert peer["caller"]["sent"] > 0
    assert peer["caller"]["received"] > 0
    assert peer["caller"]["closed"] >= 1
    assert peer["caller"]["renegotiations"] >= 1
    assert report["faults_injected"].get("partitioned", 0) > 0
    assert report["caller_recovery"]["retries"] > 0


def test_mqtt_autoscale_soak_equals_jax():
    report = both(mqtt=True, autoscale=True)
    assert_recovered(report)
    assert report["transport"] == "mqtt"
    scaler = report["autoscaler"]
    assert scaler["deaths"] == 1
    assert scaler["policy_respawns"] == 0
    assert scaler["servings_built"] == 3
    assert scaler["ready"] == 2
    ups = {key: value
           for key, value in report["telemetry"]["metrics"].items()
           if key.startswith("autoscaler_decisions_total")
           and "action=up" in key}
    assert sum(ups.values()) >= 1
    assert any("reason=below-floor" in key for key in ups)
    assert sum(report["faults_injected"].values()) > 0
    assert report["caller_recovery"]["retries"] > 0


def test_soak_main_exit_rule(monkeypatch, capsys):
    # main prints the report and exits 1 beyond --max-lost, as the JAX
    # script does (chaos_soak.py main); the scenario is stubbed to a
    # report with one lost frame
    monkeypatch.setattr(T, "run_soak", lambda **_: {"frames_lost": 1})
    assert T.main(["--device", "cpu", "--max-lost", "1"]) == 0
    assert json.loads(capsys.readouterr().out) == {"frames_lost": 1}
    assert T.main(["--device", "cpu"]) == 1


def test_runners_take_the_card_by_default():
    # no device named and no card: the runner raises before building
    # anything, as the port's entry points do
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_soak(frames=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_migrate_soak()
