# smoke CLI: the console verdict is the product
# graft: disable-file=lint-print
# Smoke for the disaggregated prefill/decode serving plane, the port's
# copy of scripts/disagg_smoke.py: the two-pool harness
# (serving_disagg.DisaggHarness) run as a colocated-vs-disaggregated A/B
# under one seeded workload:
#
#   colocated : one ContinuousDecoder takes decode streams AND cold
#               prompt bursts; the bursts' chunk extends ride its decode
#               rounds;
#   disagg    : a role-tagged PrefillRuntime computes the bursts' prompt
#               KV and ships it over the peer data plane as KV-transfer
#               envelopes; the decode decoder installs the chain and
#               prefills only the ragged suffix.
#
# The JSON report carries, per mode, the decode streams' ITL p50/p95
# with and without the concurrent burst, plus the disagg side's
# per-transfer cost (ms and bytes), handle-hit rate (chain blocks that
# crossed as indices because the decode side already held them), and
# fallback counters.  A greedy-parity probe runs first: the
# disaggregated tokens must be BIT-IDENTICAL to colocated.
#
# Acceptance (exit 0): parity holds, both modes lose ZERO requests,
# every transfer either lands or is counted into the local-prefill
# fallback ladder, and at least one transfer actually moved KV.  Latency
# comparisons are REPORTED, not gated: a shared host is too noisy to gate
# on wall-clock ratios.  Both decoders run on the card unless --device
# names another device; the decoders are dense (the harness's default),
# as in the repo script.
#
# Usage:  python -m aiko_services_tpu_torch.scripts.disagg_smoke \
#             [--window 6] [--preset tiny] [--device cpu]

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["run", "passed", "main"]


def run(preset: str = "tiny", window: float = 6.0, block: int = 32,
        seed: int = 11, kv: str = "", device=None, params=None) -> dict:
    """Both modes of the A/B; returns the report.  device: the
    decoders'; None means the card (raises when there is none).
    params: the weights (default: llama_init seeded 0 on the device)."""
    import dataclasses

    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.llama import LLAMA_PRESETS, llama_init
    from ..serving_disagg import DisaggHarness

    device = resolve_device(device)
    config = dataclasses.replace(LLAMA_PRESETS[preset], max_seq_len=1024)
    if params is None:
        params = llama_init(torch.Generator(device=device).manual_seed(0),
                            config, device=device)
    opts = {"kv_cache_dtype": kv} if kv else {}
    opts["device"] = device
    kwargs = dict(block_tokens=block, max_slots=16,
                  prefill_slots=4, steps_per_sync=4,
                  prefill_buckets=(64,), prefill_chunk=64,
                  transfer_timeout=60.0, decoder_opts=opts)
    probe = np.random.default_rng(7).integers(
        1, config.vocab, size=200).tolist()

    def run_mode(disagg: bool) -> dict:
        harness = DisaggHarness(params, config, disagg=disagg,
                                **kwargs)
        if disagg and not harness.wait_discovered(30.0):
            harness.stop()
            raise RuntimeError("prefill pool never discovered")
        done = {}
        harness.submit("probe", probe, 16,
                       lambda rid, t: done.update({rid: t}))
        harness.run_until(lambda: "probe" in done, timeout=300.0)
        out = harness.measure(window=window, seed=seed,
                              burst_every=0.4)
        out["probe_tokens"] = done.get("probe")
        if disagg:
            out["prefill_runtime"] = dict(harness.prefill.stats)
        harness.stop()
        return out

    coloc = run_mode(False)
    disagg = run_mode(True)
    parity = coloc["probe_tokens"] == disagg["probe_tokens"] and \
        coloc["probe_tokens"] is not None
    transfers = disagg.get("transfers", 0)
    return {
        "preset": preset,
        "parity_bit_identical": parity,
        "colocated": {k: v for k, v in coloc.items()
                      if k != "probe_tokens"},
        "disaggregated": {k: v for k, v in disagg.items()
                          if k != "probe_tokens"},
        "per_transfer": {
            "count": transfers,
            "bytes_total": disagg.get("transfer_bytes", 0),
            "bytes_mean": round(
                disagg.get("transfer_bytes", 0) / transfers, 1)
            if transfers else None,
            "p50_ms": disagg.get("transfer_p50_ms"),
            "p95_ms": disagg.get("transfer_p95_ms"),
            "handle_hit_rate": disagg.get("handle_hit_rate", 0.0),
        },
        "itl_under_burst": {
            "coloc_p95_ms": coloc.get("itl_p95_burst_ms"),
            "coloc_baseline_p95_ms": coloc.get("itl_p95_baseline_ms"),
            "disagg_p95_ms": disagg.get("itl_p95_burst_ms"),
            "disagg_baseline_p95_ms":
                disagg.get("itl_p95_baseline_ms"),
        },
    }


def passed(report: dict) -> bool:
    """The acceptance: parity, nothing lost, both drained, and at least
    one transfer."""
    coloc, disagg = report["colocated"], report["disaggregated"]
    return bool(report["parity_bit_identical"]
                and coloc["lost"] == 0 and disagg["lost"] == 0
                and coloc["drained"] and disagg["drained"]
                and report["per_transfer"]["count"] > 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="A/B the two-pool serving split: colocated vs "
                    "disaggregated prefill under one seeded workload")
    parser.add_argument("--preset", default="tiny",
                        help="llama preset (default tiny: CPU smoke)")
    parser.add_argument("--window", type=float, default=6.0,
                        help="measured seconds per mode (split "
                             "baseline/burst halves)")
    parser.add_argument("--block", type=int, default=32)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--kv", default="",
                        help="kv_cache_dtype ('int8' ships the "
                             "quantized layout; default native)")
    parser.add_argument("--device", default=None,
                        help="where the decoders run (default: the "
                             "card)")
    args = parser.parse_args(argv)
    report = run(args.preset, args.window, args.block, args.seed, args.kv,
                 args.device)
    print(json.dumps(report, indent=2))
    return 0 if passed(report) else 1


if __name__ == "__main__":
    sys.exit(main())
