"""The port's session load generator (state/loadgen.py) against the JAX
package's: the same LoadConfig drives each package's SessionTable,
SessionView, memory broker and virtual clock, and every count in virtual
time must be equal (sessions at steady state and peak, ops, lease churn,
view deltas, delta bytes, expiry batches, per-tenant sheds, the budget
and drain verdicts).  Handler latencies are wall time: reported, not
compared."""

import dataclasses

import pytest

from aiko_services_tpu.state import loadgen as JL
from aiko_services_tpu_torch.state import loadgen as TL

VIRTUAL = ("target", "steady_sessions", "peak_sessions", "ops",
           "lease_churn_per_virtual_s", "delta_bytes", "expiry_batches",
           "max_expiry_batch", "view_deltas", "stats", "per_tenant",
           "leaked_sessions", "leaked_timers")


def virtual_counts(report: dict) -> dict:
    return {"rungs": [{key: rung[key] for key in VIRTUAL}
                      for rung in report["rungs"]],
            **{key: report[key] for key in
               ("seed", "lease_time", "touches", "num_shards",
                "sustained_sessions", "budgets", "drain")}}


def test_defaults_equal_jax():
    assert dataclasses.asdict(TL.LoadConfig()) == \
        dataclasses.asdict(JL.LoadConfig())
    assert [dataclasses.asdict(t) for t in TL.DEFAULT_TENANTS] == \
        [dataclasses.asdict(t) for t in JL.DEFAULT_TENANTS]


@pytest.mark.parametrize("options", [
    {"rungs": (200, 1500), "lease_time": 8.0, "seed": 5},
    {"rungs": (300,), "lease_time": 5.0, "seed": 9, "touches": 1,
     "num_shards": 4, "snapshot_interval": 2.0, "view_tenant": "bulk"},
], ids=["two_rungs", "compacting"])
def test_virtual_time_counts_equal_jax(options):
    port = TL.run_session_load(TL.LoadConfig(**options))
    reference = JL.run_session_load(JL.LoadConfig(**options))
    assert virtual_counts(port) == virtual_counts(reference)
    assert port["budgets"]["ok"] and port["drain"]["ok"]
    for rung in port["rungs"]:
        assert rung["handler_count"] > 0 and rung["handler_p95_ms"] >= 0
        assert rung["ops"] > rung["target"]
    print({"handler_p95_ms": [r["handler_p95_ms"] for r in port["rungs"]],
           "jax_handler_p95_ms": [r["handler_p95_ms"]
                                  for r in reference["rungs"]]})
