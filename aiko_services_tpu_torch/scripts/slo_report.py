# report CLI: the rendered report on stdout is the product
# graft: disable-file=lint-print
# slo_report: per-tenant SLO-attainment report from a namespace's
# retained metrics snapshots.
#
# The port's copy of scripts/slo_report.py.  Every serving runtime leaves
# a retained snapshot on {namespace}/{host}/{pid}/0/metrics carrying the
# journey outcome counters (journey_requests_total{tenant, outcome}), the
# admission shed/reject counters, and the MERGEABLE TTFT/ITL sketches.
# This CLI scrapes them fleet-wide (metrics_dump's collector) and renders
# the per-tenant verdict:
#
#   tenant  attainment  ttft p50/p95/p99  itl p50/p95/p99  shed  \
#       rejected  exemplar trace ids
#
# The percentiles come from MERGED sketches (the latency each tenant was
# served across the whole fleet, not the worst process's), and the
# exemplar ids are the worst requests behind the ttft numbers.  Exit 1
# when any tenant with deadline evidence misses `--objective`: the report
# doubles as a CI gate.
#
# Usage:
#   python -m aiko_services_tpu_torch.scripts.slo_report --host mqtt.local \
#       --objective 0.99
#   python -m aiko_services_tpu_torch.scripts.slo_report --format json
#
# Without --host the scrape runs over the in-process memory broker, which
# is only useful embedded (tests call collect + render against a live
# runtime).

from __future__ import annotations

import argparse
import json
import sys

from ..observe.journey import tenant_slo_rows
from .metrics_dump import collect_snapshots, scrape_runtime

__all__ = ["collect_snapshots", "report_rows", "render_report", "main"]


def report_rows(documents: dict,
                objective: float | None = None) -> list:
    """Per-tenant rows from scraped snapshot documents (the
    {topic_path: document} map collect_snapshots returns), merged
    fleet-wide through observe.journey.tenant_slo_rows."""
    return tenant_slo_rows(
        [document.get("snapshot", {})
         for document in documents.values()],
        objective=objective)


def render_report(rows: list, fmt: str = "text",
                  objective: float | None = None) -> str:
    if fmt == "json":
        return json.dumps({"objective": objective, "tenants": rows},
                          indent=2, default=str, sort_keys=True)

    def ms(value, digits=1):
        return "-" if value is None else f"{value:.{digits}f}"

    lines = [f"{'tenant':16s} {'attain':>7s} "
             f"{'ttft p50/p95/p99 ms':>22s} "
             f"{'itl p50/p95/p99 ms':>22s} {'shed':>6s} {'rej':>5s}  "
             f"exemplars"]
    for row in rows:
        attainment = "-" if row["attainment"] is None \
            else f"{row['attainment']:.3f}"
        verdict = "" if row["met"] else "  ** MISSED **"
        lines.append(
            f"{row['tenant']:16.16s} {attainment:>7s} "
            f"{ms(row['ttft_p50_ms']):>6s}/{ms(row['ttft_p95_ms'])}/"
            f"{ms(row['ttft_p99_ms'])} "
            f"{ms(row['itl_p50_ms'], 2):>6s}/"
            f"{ms(row['itl_p95_ms'], 2)}/{ms(row['itl_p99_ms'], 2)} "
            f"{row['shed']:>6d} {row['rejected']:>5d}  "
            f"{','.join(row['exemplars']) or '-'}{verdict}")
        # cached/cold TTFT split: present only when the
        # serving side ran with prefill-labeled sketches — quotes what
        # the prefix cache actually bought this tenant
        if any(row.get(f"ttft_{p}_p50_ms") is not None
               for p in ("cached", "cold")):
            lines.append(
                f"{'':16s} {'':>7s} prefix: cached p50/p95 "
                f"{ms(row.get('ttft_cached_p50_ms'))}/"
                f"{ms(row.get('ttft_cached_p95_ms'))} ms, cold "
                f"{ms(row.get('ttft_cold_p50_ms'))}/"
                f"{ms(row.get('ttft_cold_p95_ms'))} ms")
        # KV memory ledger attribution: present only when a
        # runtime shipped kv_ledger_* families — what this tenant's KV
        # footprint cost per tier, integrated over time, and how often
        # its blocks moved between tiers
        if row.get("device_bytes") or row.get("host_bytes") or \
                row.get("byte_seconds"):
            lines.append(
                f"{'':16s} {'':>7s} memory: device "
                f"{row['device_bytes']:,d} B, host "
                f"{row['host_bytes']:,d} B, "
                f"{row['byte_seconds']:,.0f} B*s, "
                f"demote/promote {row['demotions']}/"
                f"{row['promotions']}")
    if objective is not None:
        missed = [row["tenant"] for row in rows if not row["met"]]
        lines.append(
            f"objective {objective}: "
            + (f"MISSED by {', '.join(missed)}" if missed
               else "met by every tenant with deadline evidence"))
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="per-tenant SLO attainment from a namespace's "
                    "retained metrics snapshots (merged sketches + "
                    "journey outcome counters)")
    parser.add_argument("--namespace", default=None,
                        help="namespace to scrape (default: "
                             "AIKO_NAMESPACE or 'aiko')")
    parser.add_argument("--host", default=None,
                        help="MQTT broker host (omit to scrape the "
                             "in-process memory broker)")
    parser.add_argument("--port", type=int, default=1883)
    parser.add_argument("--wait", type=float, default=2.0,
                        help="seconds to collect before reporting")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--objective", type=float, default=0.99,
                        help="deadline-attainment objective per "
                             "tenant; any tenant below it exits 1")
    args = parser.parse_args(argv)

    runtime = scrape_runtime("slo_report", args.namespace, args.host,
                             args.port)
    try:
        documents = collect_snapshots(runtime, wait=args.wait)
        rows = report_rows(documents, objective=args.objective)
        print(render_report(rows, args.format, args.objective))
    finally:
        runtime.terminate()
    if not rows:
        print(f"no tenant SLO evidence found in namespace "
              f"{runtime.namespace!r}",
              file=sys.stderr)
        return 1
    return 0 if all(row["met"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
