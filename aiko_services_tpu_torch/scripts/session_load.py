# smoke CLI: the console verdict is the product
# graft: disable-file=lint-print
# Session-load smoke: the open-loop arrival generator driving the sharded
# SessionTable through a real runtime across cardinality rungs, reporting
# sessions/s, lease churn, shard delta bytes, and handler-latency
# flatness.  The port's copy of scripts/session_load.py, over the port's
# state/loadgen.py.
#
#   python -m aiko_services_tpu_torch.scripts.session_load      # 1k→100k
#   python -m aiko_services_tpu_torch.scripts.session_load \
#       --rungs 1000,10000 --seed 7
#   python -m aiko_services_tpu_torch.scripts.session_load \
#       --lease 10 --touches 3 --shards 16
#
# Exit code 0 iff every verdict holds: flat p95 across rungs (no O(n)
# knee), per-tenant budgets enforced (flood tenant shed+demoted, polite
# tenants intact), and zero leaked sessions/timers at drain.  The full
# JSON report goes to stdout (--out FILE to also save it).

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..state.loadgen import LoadConfig, run_session_load

__all__ = ["main"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="open-loop session load generator")
    parser.add_argument("--rungs", default="1000,10000,100000",
                        help="comma-separated concurrency targets")
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--lease", type=float, default=20.0,
                        help="session lease (virtual seconds)")
    parser.add_argument("--touches", type=int, default=2,
                        help="lease extensions per session life")
    parser.add_argument("--shards", type=int, default=8)
    parser.add_argument("--payload-bytes", type=int, default=64)
    parser.add_argument("--snapshot-interval", type=float, default=0.0,
                        help="per-shard compacted snapshot cadence "
                             "(virtual seconds; 0 = lease-driven only)")
    parser.add_argument("--max-p95-ratio", type=float, default=4.0)
    parser.add_argument("--out", default="",
                        help="also write the JSON report here")
    args = parser.parse_args(argv)

    config = LoadConfig(
        seed=args.seed,
        rungs=tuple(int(r) for r in args.rungs.split(",") if r),
        lease_time=args.lease,
        touches=args.touches,
        num_shards=args.shards,
        payload_bytes=args.payload_bytes,
        snapshot_interval=args.snapshot_interval,
        max_p95_ratio=args.max_p95_ratio,
    )
    report = run_session_load(config)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n", encoding="utf-8")
    for rung in report["rungs"]:
        print(f"rung {rung['target']}: steady={rung['steady_sessions']} "
              f"p95={rung['handler_p95_ms']}ms "
              f"mean={rung['handler_mean_us']}us "
              f"ops/s={rung['ops_per_wall_s']} "
              f"delta_bytes={rung['delta_bytes']}", file=sys.stderr)
    print(f"verdicts: flat={report['flat']['ok']} "
          f"budgets={report['budgets']['ok']} "
          f"drain={report['drain']['ok']} ok={report['ok']}",
          file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
