#!/usr/bin/env python3
# measurement CLI: the console readout is the product
# graft: disable-file=lint-print
"""Measure the aloha-honua pass-through rate of an event loop's
mailboxes on this host: the port's copy of
tools/measure_reference_baseline.py.

The aloha example is one actor whose hot path is the event loop's
mailbox drain; its sustainable frames a second is that loop's message
throughput.  An open-loop poster thread keeps the mailbox full (bursts
of 256, a 1 ms pause) while the loop drains it for a fixed window; the
script counts the handled messages and prints one JSON line with the
host CPU's model beside the rate (the rate is the host's, not the
card's).

--ours drives the port's EventEngine mailboxes.  Without it the script
drives the reference aiko_services event loop (aiko_services/event.py:
drain mailboxes, then sleep 10 ms), imported from a checkout of the
reference named by --reference (its package __init__ is skipped: it
pulls in paho/mqtt, which the hot path never uses).

Usage:
    python -m aiko_services_tpu_torch.tools.measure_reference_baseline \\
        [--seconds 5] (--ours | --reference PATH)
"""

import argparse
import json
import os
import platform
import sys
import threading
import time
import types


def cpu_model() -> str:
    """The host CPU: its model name (/proc/cpuinfo on Linux, else what
    platform reports; a sandboxed kernel may report "unknown"), its
    architecture and the cores this process sees."""
    name = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as handle:
            for line in handle:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    name = name or platform.processor() or "unknown"
    return f"{name}, {platform.machine()}, {os.cpu_count()} cores"


def load_reference_event(reference: str):
    """Import aiko_services.event from the reference checkout WITHOUT
    executing the package __init__ (which pulls paho/mqtt)."""
    sys.path.insert(0, reference)
    package = types.ModuleType("aiko_services")
    package.__path__ = [os.path.join(reference, "aiko_services")]
    sys.modules["aiko_services"] = package
    import aiko_services.event as ref_event
    return ref_event


def _poster(put, stop: threading.Event):
    def post():
        # open-loop: keep the mailbox non-empty, as a busy pipeline
        # would; bounded bursts so memory stays flat
        while not stop.is_set():
            for _ in range(256):
                put("aloha", ("aloha", "Pele"))
            time.sleep(0.001)
    thread = threading.Thread(target=post, daemon=True)
    thread.start()
    return thread


def measure_reference(seconds: float, reference: str) -> dict:
    event = load_reference_event(reference)
    handled = [0]
    stop = threading.Event()

    def handler(name, item, time_posted):
        handled[0] += 1

    event.add_mailbox_handler(handler, "aloha")
    thread = _poster(event.mailbox_put, stop)

    def terminator():
        time.sleep(seconds)
        stop.set()
        event.terminate()

    threading.Thread(target=terminator, daemon=True).start()
    start = time.perf_counter()
    event.loop(loop_when_no_handlers=True)
    elapsed = time.perf_counter() - start
    thread.join(timeout=2.0)
    return {"which": "reference", "messages": handled[0],
            "seconds": round(elapsed, 3),
            "messages_per_sec": round(handled[0] / elapsed, 1),
            "cpu": cpu_model()}


def measure_ours(seconds: float) -> dict:
    from aiko_services_tpu_torch.event import EventEngine

    engine = EventEngine()
    handled = [0]
    stop = threading.Event()

    def handler(name, item, time_posted):
        handled[0] += 1

    engine.add_mailbox_handler(handler, "aloha")
    thread = _poster(engine.mailbox_put, stop)
    start = time.perf_counter()
    deadline = start + seconds
    engine.run_until(lambda: time.perf_counter() >= deadline,
                     timeout=seconds + 10)
    stop.set()
    elapsed = time.perf_counter() - start
    thread.join(timeout=2.0)
    return {"which": "aiko_services_tpu_torch", "messages": handled[0],
            "seconds": round(elapsed, 3),
            "messages_per_sec": round(handled[0] / elapsed, 1),
            "cpu": cpu_model()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--ours", action="store_true")
    parser.add_argument("--reference", default=None,
                        help="a checkout of the reference aiko_services")
    args = parser.parse_args(argv)
    if not args.ours and not args.reference:
        parser.error("pass --ours, or --reference PATH")
    result = measure_ours(args.seconds) if args.ours else \
        measure_reference(args.seconds, args.reference)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
