# dump CLI: the rendered exposition on stdout is the product
# graft: disable-file=lint-print
# metrics_dump: scrape a namespace's retained metrics snapshots and
# print them as Prometheus text exposition or JSON.
#
# The port's copy of scripts/metrics_dump.py.  Every process running a
# MetricsPublisher leaves a RETAINED snapshot on
# {namespace}/{host}/{pid}/0/metrics: this CLI subscribes the namespace
# filter, waits for the broker to replay the retained documents (plus
# any fresh publishes inside the window), and prints the merged result.
# Prometheus output stamps each series with a `process="{topic_path}"`
# label so a fleet-wide scrape stays per-process attributable; JSON
# output is the raw snapshot documents keyed by topic_path.
#
# Usage:
#   python -m aiko_services_tpu_torch.scripts.metrics_dump --host mqtt.local
#   python -m aiko_services_tpu_torch.scripts.metrics_dump --wait 3
#   python -m aiko_services_tpu_torch.scripts.metrics_dump --format json \
#       --family serving
#
# Without --host the scrape runs over the in-process memory broker, which
# is only useful embedded (tests call collect_snapshots against a live
# runtime).

from __future__ import annotations

import argparse
import json
import sys

from ..observe.export import (METRICS_TOPIC_SUFFIX, parse_retained_json,
                              render_snapshot_prometheus)

__all__ = ["collect_snapshots", "render", "main"]


def collect_snapshots(runtime, wait: float = 2.0,
                      settle=None) -> dict:
    """Subscribe {namespace}/+/+/0/metrics on `runtime`, drive its
    engine for `wait` seconds, and return {topic_path: document}.
    Retained snapshots replay on subscribe, so even a silent fleet
    answers.  `settle` overrides the drive loop (tests pass a
    virtual-clock settle; the CLI uses run_until on the real clock)."""
    documents: dict[str, dict] = {}
    topic_filter = f"{runtime.namespace}/+/+/{METRICS_TOPIC_SUFFIX}"

    def handler(topic: str, payload) -> None:
        document = parse_retained_json(payload, require_key="snapshot")
        if document is not None:
            # one snapshot per topic path, bounded by fleet size over
            # one collection window — graft: disable=lint-unbounded-cache
            documents[str(document.get("topic_path", topic))] = document

    runtime.add_message_handler(handler, topic_filter)
    try:
        if settle is not None:
            settle(runtime.event, wait)
        else:
            runtime.event.run_until(lambda: False, timeout=wait)
    finally:
        runtime.remove_message_handler(handler, topic_filter)
    return documents


def render(documents: dict, fmt: str = "prom",
           family: str | None = None) -> str:
    """Render scraped documents: 'prom' = text exposition with a
    process label per source, 'json' = the documents verbatim.
    `family` filters metric families by substring."""
    if family:
        documents = {
            source: {**document, "snapshot": {
                name: entry
                for name, entry in document.get("snapshot", {}).items()
                if family in name}}
            for source, document in documents.items()}
    if fmt == "json":
        return json.dumps(documents, indent=2, default=str,
                          sort_keys=True)
    parts = []
    for source in sorted(documents):
        snapshot = documents[source].get("snapshot", {})
        parts.append(render_snapshot_prometheus(
            snapshot, extra_labels={"process": source}))
    return "".join(parts)


def scrape_runtime(name: str, namespace=None, host=None, port: int = 1883):
    """The scraper's ProcessRuntime: over MQTT when `host` names a
    broker, else over the in-process memory broker."""
    from ..process import ProcessRuntime
    transport_factory = None
    if host:
        from ..transport.mqtt import MQTTMessage

        def transport_factory(on_message, lwt_topic, lwt_payload,
                              lwt_retain):
            return MQTTMessage(
                on_message=on_message, host=host, port=port,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain)

    runtime = ProcessRuntime(name=name, namespace=namespace,
                             transport_factory=transport_factory)
    return runtime.initialize()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="scrape retained {topic}/0/metrics snapshots from "
                    "a namespace and print Prometheus text or JSON")
    parser.add_argument("--namespace", default=None,
                        help="namespace to scrape (default: "
                             "AIKO_NAMESPACE or 'aiko')")
    parser.add_argument("--host", default=None,
                        help="MQTT broker host (omit to scrape the "
                             "in-process memory broker)")
    parser.add_argument("--port", type=int, default=1883)
    parser.add_argument("--wait", type=float, default=2.0,
                        help="seconds to collect before printing")
    parser.add_argument("--format", choices=("prom", "json"),
                        default="prom")
    parser.add_argument("--family", default=None,
                        help="only families whose name contains this")
    args = parser.parse_args(argv)

    runtime = scrape_runtime("metrics_dump", args.namespace, args.host,
                             args.port)
    try:
        documents = collect_snapshots(runtime, wait=args.wait)
        print(render(documents, args.format, args.family), end="")
    finally:
        runtime.terminate()
    if not documents:
        print(f"no retained metrics snapshots found in namespace "
              f"{runtime.namespace!r}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
