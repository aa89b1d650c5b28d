"""The port's operator scripts (aiko_services_tpu_torch/scripts/) against
the repo's scripts/ of the same names, on the same inputs:

  - metrics_dump: a live runtime's retained snapshot, scraped and
    rendered as Prometheus text and JSON;
  - slo_report: the two-tenant journey snapshot, scraped, reported in
    both formats, and main's CI-gate exit (1 when a tenant with deadline
    evidence misses --objective);
  - session_load: main's JSON report and exit code at small rungs;
  - peer_smoke: the broker and peer modes' data-plane accounting;
  - disagg_smoke: the colocated and disaggregated runs' probe parity,
    transfer, handle-hit and completion counts, on the JAX package's
    tiny-preset f32 weights crossed through the bridge.

Fields that read the wall clock are left out of each comparison:
  - metrics_dump, slo_report: the source's topic path (each package's
    runtimes number their own processes);
  - session_load: each rung's wall_s, ops_per_wall_s,
    sessions_per_wall_s, handler_p95_ms, handler_mean_us and
    handler_count (the latency sample), and the verdicts read from them
    (flat, ok);
  - peer_smoke: every count and latency of a run (wall-clock streams):
    the accounting's verdicts are compared;
  - disagg_smoke: the ITL, stall and transfer latencies, the streams'
    completions and postings (closed loops on the real clock), the
    overlap seconds, and every byte count (the layout names each
    package's dtype)."""

import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import disagg_smoke as JDisagg  # noqa: E402
import metrics_dump as JDump  # noqa: E402
import peer_smoke as JPeer  # noqa: E402
import session_load as JLoad  # noqa: E402
import slo_report as JSlo  # noqa: E402

import aiko_services_tpu.event as JE  # noqa: E402
import aiko_services_tpu.observe as JO  # noqa: E402
import aiko_services_tpu.process as JP  # noqa: E402
import aiko_services_tpu.transport.memory as JM  # noqa: E402
from aiko_services_tpu.models import llama as JL  # noqa: E402
import aiko_services_tpu_torch.event as TE  # noqa: E402
import aiko_services_tpu_torch.observe as TO  # noqa: E402
import aiko_services_tpu_torch.process as TP  # noqa: E402
import aiko_services_tpu_torch.transport.memory as TM  # noqa: E402
from aiko_services_tpu_torch import bridge  # noqa: E402
from aiko_services_tpu_torch.models import llama as TL  # noqa: E402
from aiko_services_tpu_torch.scripts import (  # noqa: E402
    disagg_smoke as TDisagg, metrics_dump as TDump, peer_smoke as TPeer,
    session_load as TLoad, slo_report as TSlo)

torch.set_num_threads(1)

PACKAGES = {"jax": (JE, JO, JP, JM), "torch": (TE, TO, TP, TM)}
DUMP = {"jax": JDump, "torch": TDump}
SLO = {"jax": JSlo, "torch": TSlo}
EMPTY_NAMESPACE = "torch_op_scripts_empty"


@contextlib.contextmanager
def fleet(package: str):
    """A virtual-clock engine, one memory broker and a runtime factory;
    terminates the runtimes it made."""
    event, _, process, memory = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()
    made = []

    def runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        made.append(process.ProcessRuntime(
            name=name, engine=engine, transport_factory=factory)
            .initialize())
        return made[-1]

    try:
        yield engine, runtime
    finally:
        for rt in made:
            rt.terminate()


def settle(package: str):
    return lambda engine, seconds: PACKAGES[package][0].settle_virtual(
        engine, seconds)


def scraped_dump(package: str):
    """A publisher's retained snapshot scraped and rendered: (prom text,
    the JSON document's snapshot), the source's topic path replaced."""
    _, observe, _, _ = PACKAGES[package]
    observe.default_registry().counter(
        "op_scripts_dump_events_total", labels={"kind": "t"}).inc(4)
    with fleet(package) as (engine, runtime):
        publisher_rt = runtime("dump_pub")
        publisher = observe.MetricsPublisher(publisher_rt, interval=0.5)
        settle(package)(engine, 1.0)
        documents = DUMP[package].collect_snapshots(
            runtime("dump_scraper"), wait=1.0, settle=settle(package))
        publisher.stop()
        source = publisher_rt.topic_path
    assert list(documents) == [source]
    prom = DUMP[package].render(documents, "prom",
                                family="op_scripts_dump_events")
    blob = json.loads(DUMP[package].render(documents, "json",
                                           family="op_scripts_dump_events"))
    return prom.replace(source, "<source>"), blob[source]["snapshot"]


def test_metrics_dump_renders_as_jax():
    port, reference = scraped_dump("torch"), scraped_dump("jax")
    assert port == reference
    prom, snapshot = port
    assert "# TYPE op_scripts_dump_events_total counter" in prom
    assert 'process="<source>"' in prom and 'kind="t"' in prom
    assert list(snapshot) == ["op_scripts_dump_events_total"]


def test_metrics_dump_main_exits_one_on_an_empty_namespace(capsys):
    codes = [DUMP[package].main(["--namespace", EMPTY_NAMESPACE,
                                 "--wait", "0.05"])
             for package in ("jax", "torch")]
    assert codes == [1, 1]
    errors = capsys.readouterr().err.splitlines()
    assert errors[0] == errors[1] and "no retained metrics" in errors[0]


def tenant_snapshot(package: str) -> dict:
    """tests/test_journey.py's two-tenant journey evidence, built in one
    package's registry."""
    registry = PACKAGES[package][1].MetricsRegistry()
    ttft_acme = registry.sketch("serving_ttft_seconds", "",
                                {"decoder": "d", "tenant": "acme"})
    ttft_flood = registry.sketch("serving_ttft_seconds", "",
                                 {"decoder": "d", "tenant": "flood"})
    for value in (0.010, 0.012, 0.011):
        ttft_acme.observe(value, exemplar="trace-acme")
    for value in (0.900, 1.100):
        ttft_flood.observe(value, exemplar="trace-flood")
    for tenant, outcome, count in (("acme", "deadline-met", 99),
                                   ("acme", "deadline-missed", 1),
                                   ("flood", "deadline-missed", 6),
                                   ("flood", "deadline-met", 4)):
        registry.counter("journey_requests_total",
                         labels={"log": "d", "tenant": tenant,
                                 "outcome": outcome}).inc(count)
    registry.counter("admission_shed_total",
                     labels={"tenant": "flood", "tier": "1",
                             "reason": "tenant-over-budget"}).inc(15)
    return json.loads(json.dumps(registry.snapshot()))


def slo_documents(package: str) -> dict:
    with fleet(package) as (engine, runtime):
        publisher_rt = runtime("slo_pub")
        publisher_rt.publish(
            f"{publisher_rt.topic_path}/0/metrics",
            json.dumps({"process": "slo_pub",
                        "topic_path": publisher_rt.topic_path,
                        "time": 1.0, "snapshot": tenant_snapshot(package)}),
            retain=True)
        documents = SLO[package].collect_snapshots(
            runtime("slo_scrape"), wait=1.0, settle=settle(package))
    assert list(documents) == [publisher_rt.topic_path]
    return {"<source>": documents[publisher_rt.topic_path]}


def test_slo_report_renders_as_jax():
    reports = {}
    for package in ("jax", "torch"):
        documents = slo_documents(package)
        rows = SLO[package].report_rows(documents, objective=0.99)
        reports[package] = (
            rows, SLO[package].render_report(rows, "text", 0.99),
            SLO[package].render_report(rows, "json", 0.99))
    assert reports["torch"] == reports["jax"]
    rows, text, blob = reports["torch"]
    assert not all(row["met"] for row in rows)
    assert "MISSED" in text and "flood" in text
    parsed = json.loads(blob)
    assert parsed["objective"] == 0.99
    assert {row["tenant"] for row in parsed["tenants"]} == {"acme", "flood"}


@pytest.mark.parametrize("objective,code", [("0.99", 1), ("0.3", 0)])
def test_slo_report_main_is_a_ci_gate(monkeypatch, capsys, objective,
                                      code):
    # the flood tenant's attainment is 0.4: it misses 0.99 and meets 0.3
    outputs = {}
    for package in ("jax", "torch"):
        documents = slo_documents(package)
        monkeypatch.setattr(SLO[package], "collect_snapshots",
                            lambda runtime, wait: documents)
        assert SLO[package].main(["--namespace", EMPTY_NAMESPACE,
                                  "--objective", objective]) == code
        outputs[package] = capsys.readouterr().out
    assert outputs["torch"] == outputs["jax"]
    monkeypatch.setattr(TSlo, "collect_snapshots",
                        lambda runtime, wait: {})
    assert TSlo.main(["--namespace", EMPTY_NAMESPACE]) == 1
    assert "no tenant SLO evidence" in capsys.readouterr().err


LOAD_WALL = ("wall_s", "ops_per_wall_s", "sessions_per_wall_s",
             "handler_p95_ms", "handler_mean_us", "handler_count")


def load_report(package: str, argv: list, monkeypatch, capsys):
    if package == "jax":
        monkeypatch.setattr(sys, "argv", ["session_load.py", *argv])
        code = JLoad.main()
    else:
        code = TLoad.main(argv)
    report = json.loads(capsys.readouterr().out)
    assert code == (0 if report["ok"] else 1)
    for rung in report["rungs"]:
        for key in LOAD_WALL:
            rung.pop(key)
    report.pop("flat")
    report.pop("ok")
    return code, report


def test_session_load_report_equals_jax(monkeypatch, capsys):
    argv = ["--rungs", "200,1500", "--lease", "8", "--seed", "5"]
    port = load_report("torch", argv, monkeypatch, capsys)
    assert port == load_report("jax", argv, monkeypatch, capsys)
    code, report = port
    assert code == 0
    assert report["sustained_sessions"] >= 1500
    assert report["drain"] == {"leaked_sessions": 0, "leaked_timers": 0,
                               "ok": True}
    assert report["budgets"]["flood_shed"] > 0
    assert report["budgets"]["polite_shed"] == 0


def accounting(run: dict) -> dict:
    """The data-plane verdicts of one run: what the peer smoke's
    acceptance reads."""
    return {"mode": run["mode"],
            "completed": run["frames_completed"] == run["frames_posted"]
            and run["frames_posted"] > 0,
            "peer_envelopes": run["peer_envelopes"] > 0,
            "broker_flat": run["broker_routed_steady_state"] <
            run["frames_posted"]}


def test_peer_smoke_accounting_as_jax():
    verdicts = {}
    for package, module in (("jax", JPeer), ("torch", TPeer)):
        verdicts[package] = [accounting(module.run_mode(peer, 4, 0.4))
                             for peer in (True, False)]
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"] == [
        {"mode": "peer", "completed": True, "peer_envelopes": True,
         "broker_flat": True},
        {"mode": "broker", "completed": True, "peer_envelopes": False,
         "broker_flat": False}]
    cost = TPeer.measure_delivery_cost(n=200)
    assert set(cost) == set(JPeer.measure_delivery_cost(n=200))
    assert cost["broker_us_per_envelope"] > 0 and \
        cost["peer_us_per_envelope"] > 0


# the counts of a run that do not read the wall clock (window 0.2 s: the
# 0.4 s burst timer never fires, so every burst is the warm-up's)
DISAGG_COUNTS = ("burst_completions", "lost", "drained", "transfers",
                 "handle_hit_rate", "local_fallbacks", "install_shed",
                 "chunk_streamed", "chunk_installs", "chunk_dropped")
PREFILL_COUNTS = ("requests", "computed", "blocks_shipped",
                  "handle_blocks", "refused", "empty_ships", "envelopes",
                  "batched_envelopes", "chunks_shipped", "chunk_blocks")


def disagg_counts(report: dict) -> dict:
    counts = {"preset": report["preset"],
              "parity_bit_identical": report["parity_bit_identical"],
              "count": report["per_transfer"]["count"],
              "handle_hit_rate": report["per_transfer"]["handle_hit_rate"]}
    for mode in ("colocated", "disaggregated"):
        run = report[mode]
        counts[mode] = {key: run[key] for key in DISAGG_COUNTS
                        if key in run}
    counts["prefill_runtime"] = {
        key: report["disaggregated"]["prefill_runtime"][key]
        for key in PREFILL_COUNTS}
    return counts


def test_disagg_smoke_counts_equal_jax():
    config = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=1024)
    params = JL.llama_init(jax.random.PRNGKey(0), config)
    model = bridge.params_from_numpy(
        jax.tree.map(np.asarray, params),
        dataclasses.replace(TL.LLAMA_PRESETS["tiny"], max_seq_len=1024),
        device="cpu")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = JDisagg.main(["--window", "0.2"])
    reference = json.loads(printed.getvalue())
    port = TDisagg.run(window=0.2, device="cpu", params=model)
    assert disagg_counts(port) == disagg_counts(reference)
    assert code == 0 and TDisagg.passed(port)
    counts = disagg_counts(port)
    assert counts["parity_bit_identical"]
    assert counts["count"] > 0 and counts["handle_hit_rate"] > 0
    assert counts["disaggregated"]["local_fallbacks"] == 0


def test_disagg_smoke_main_exit(monkeypatch, capsys):
    # main prints run()'s report and exits on passed(): a lost request
    # fails it
    good = {"parity_bit_identical": True,
            "colocated": {"lost": 0, "drained": True},
            "disaggregated": {"lost": 0, "drained": True},
            "per_transfer": {"count": 3}}
    lost = json.loads(json.dumps(good))
    lost["disaggregated"]["lost"] = 1
    for report, code in ((good, 0), (lost, 1)):
        monkeypatch.setattr(TDisagg, "run", lambda *_: report)
        assert TDisagg.main(["--device", "cpu"]) == code
        assert json.loads(capsys.readouterr().out) == report


def test_disagg_smoke_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDisagg.run()
