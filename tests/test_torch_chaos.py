"""The chaos seam on the port held against the JAX package: FaultPlan
verdicts call for call from the same seed, ChaosBroker delivery sequences
(the mechanics of tests/test_chaos.py: seeded drops, per-recipient rules,
delay, duplicate, truncate, reorder, partitions, payload and count
windows, retained replays through the delivery seam), ChaosMessage on the
publish side, a remote hop recovered by retries over a chaos broker, and
examples/speech/pipeline_transcription_remote.json over TCP peer channels
under a seeded plan that drops requests and delays replies: every frame
completes, with the same faults, retries and tokens as JAX."""

import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu.transport import chaos as JC
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch.transport import chaos as TC
from aiko_services_tpu_torch.transport import memory as TM

import test_torch_peer as TPT
import test_torch_remote_speech as RS
from test_torch_remote_speech import weights  # noqa: F401  (a fixture)

PACKAGES = {"jax": (JE, JM, JC), "torch": (TE, TM, TC)}


def both(scenario):
    port, reference = scenario("torch"), scenario("jax")
    assert port == reference
    return port


class Bench:
    """One package's ChaosBroker on a virtual-clock engine, with named
    clients that record what they see."""

    def __init__(self, package, seed=7):
        event, self.memory, chaos = PACKAGES[package]
        self.engine = event.EventEngine(event.VirtualClock())
        self.plan = chaos.FaultPlan(seed=seed)
        self.broker = chaos.ChaosBroker(self.plan, self.engine)
        self.seen = []

    def client(self, name, topics=()):
        client = self.memory.MemoryMessage(
            on_message=lambda t, p: self.seen.append((name, t, p)),
            subscriptions=topics, broker=self.broker, client_id=name)
        client.connect()
        return client


def mechanics_same_seed(bench):
    bench.plan.drop(topic="t/#", probability=0.5)
    bench.client("rx", ["t/#"])
    tx = bench.client("tx")
    for index in range(40):
        tx.publish(f"t/{index}", f"m{index}")


def mechanics_per_recipient(bench):
    bench.plan.drop(topic="t/#", client="b")
    bench.client("a", ["t/#"])
    bench.client("b", ["t/#"])
    bench.client("tx").publish("t/1", "x")


def mechanics_delay(bench):
    bench.plan.delay(topic="t/#", delay=0.5)
    bench.client("rx", ["t/#"])
    bench.client("tx").publish("t/1", "x")
    bench.engine.step()
    bench.seen.append(("checkpoint", "", ""))
    bench.engine.clock.advance(0.6)
    bench.engine.step()


def mechanics_duplicate_truncate(bench):
    bench.plan.duplicate(topic="dup/#", copies=2)
    bench.plan.truncate(topic="cut/#", truncate_to=4)
    bench.client("rx", ["dup/#", "cut/#"])
    tx = bench.client("tx")
    tx.publish("dup/1", "payload")
    tx.publish("cut/1", b"0123456789")


def mechanics_reorder(bench):
    bench.plan.reorder(topic="t/#", count=1)
    bench.client("rx", ["t/#"])
    tx = bench.client("tx")
    tx.publish("t/1", "first")
    tx.publish("t/2", "second")
    bench.engine.step()


def mechanics_partition(bench):
    bench.plan.partition([["a*"], ["b*"]], start=1.0, stop=2.0)
    bench.client("b_rx", ["t/#"])
    bench.client("observer", ["t/#"])
    tx = bench.client("a_tx")
    tx.publish("t/1", "before")
    bench.engine.clock.advance(1.5)
    tx.publish("t/2", "during")
    bench.engine.clock.advance(1.0)
    tx.publish("t/3", "after")


def mechanics_payload_window(bench):
    bench.plan.drop(topic="t/#", payload_match="poison", count=1)
    bench.plan.delay(topic="t/#", after=1, count=1, delay=0.1)
    bench.client("rx", ["t/#"])
    tx = bench.client("tx")
    for text in ("fine", "poison pill", "poison again", "late", "last"):
        tx.publish("t/x", text)
    bench.engine.clock.advance(0.2)
    while bench.engine.step():
        pass


def mechanics_retained(bench):
    """Retained replays go through the broker's per-recipient delivery
    seam (sender None): a dropped retained announcement is testable."""
    bench.plan.drop(topic="boot/#", client="late", count=1)
    bench.client("tx").publish("boot/r", "(primary found)", retain=True)
    bench.client("late", ["boot/#"])
    bench.client("later", ["boot/#"])


@pytest.mark.parametrize("mechanics", [
    mechanics_same_seed, mechanics_per_recipient, mechanics_delay,
    mechanics_duplicate_truncate, mechanics_reorder, mechanics_partition,
    mechanics_payload_window, mechanics_retained])
def test_chaos_broker_delivery_sequences_match_jax(mechanics):
    def scenario(package):
        bench = Bench(package, seed=123)
        mechanics(bench)
        return bench.seen, dict(bench.plan.stats), \
            [(r.kind, r.seen, r.fired) for r in bench.plan.rules]
    seen, stats, _ = both(scenario)
    assert seen and sum(stats.values()) > 0


def test_fault_plan_verdicts_match_jax_call_for_call():
    """Three probabilistic rules over 400 decisions on random topics,
    senders and recipients: every verdict field equal, from one seed."""
    rng = np.random.default_rng(0)
    calls = [(f"{rng.choice(['a', 'b'])}/{rng.integers(4)}",
              str(rng.choice(["tx", "ty"])), str(rng.choice(["r1", "r2"])),
              "poison" if rng.random() < 0.2 else "fine",
              float(index) / 100.0) for index in range(400)]

    def scenario(package):
        plan = PACKAGES[package][2].FaultPlan(seed=11)
        plan.drop(topic="a/#", probability=0.3, client="r1")
        plan.delay(topic="+/1", probability=0.5, delay=0.25, after=3)
        plan.duplicate(topic="b/#", probability=0.4, copies=2, count=20)
        plan.truncate(payload_match="poison", probability=0.5,
                      truncate_to=2, start=1.0, stop=3.0)
        plan.partition([["tx"], ["r2"]], start=2.0, stop=2.5)
        verdicts = []
        for call in calls:
            v = plan.decide(*call)
            verdicts.append((v.drop, v.delay, v.copies, v.truncate_to,
                             v.reorder))
        return verdicts, dict(plan.stats), plan.injected()
    verdicts, stats, injected = both(scenario)
    assert injected == sum(stats.values()) > 0
    assert len(set(verdicts)) > 4
    with pytest.raises(ValueError, match="unknown fault kind"):
        TC.FaultRule("explode")


def test_chaos_message_applies_the_plan_on_the_publish_side():
    def scenario(package):
        event, memory, chaos = PACKAGES[package]
        engine = event.EventEngine(event.VirtualClock())
        broker = memory.MemoryBroker()
        seen = []
        rx = memory.MemoryMessage(on_message=lambda t, p: seen.append(p),
                                  subscriptions=["t/#"], broker=broker)
        rx.connect()
        plan = chaos.FaultPlan(seed=4)
        plan.drop(topic="t/drop", probability=0.5)
        plan.delay(topic="t/late", delay=0.3)
        tx = chaos.ChaosMessage(memory.MemoryMessage(broker=broker), plan,
                                engine=engine, client_id="tx")
        tx.connect()
        for index in range(12):
            tx.publish("t/drop", f"d{index}")
        tx.publish("t/late", "late")
        tx.publish("t/now", "now")
        engine.clock.advance(0.5)
        while engine.step():
            pass
        return seen, dict(plan.stats), tx.connected()
    seen, stats, connected = both(scenario)
    assert seen[-1] == "late" and "now" in seen and connected
    assert 0 < stats["drop"] < 12


def test_remote_hop_retry_recovers_a_dropped_request():
    """The broker path under a ChaosBroker: the first request envelope to
    the serving pipeline is dropped, the hop lease expires, the retry
    carries the frame."""
    def scenario(package):
        chaos = TPT.chaos(21, kind="drop", topic="test/+/serve_rt1/+/in",
                          count=1)
        return TPT.run(package, lambda system: (
            system.post(frames=1), system.settle_virtual(3.0),
            system.outcome())[-1], chaos_broker=chaos, caller_peer=False,
            serving_peer=False, retries=2, remote_timeout=1.0,
            failure_budget=2)
    outcome = both(scenario)
    assert len(outcome["done"]) == 1 and outcome["pending"] == 0
    assert outcome["recovery"]["retries"] == 1


# requests dropped on the caller's channel, replies delayed on the
# server's: the faults the remote example meets over TCP
CALLER_RULES = (("drop", {"topic": "{server}", "probability": 0.5}),)
SERVING_RULES = (("delay", {"topic": "{caller}", "probability": 0.5,
                            "delay": 0.2}),)


def test_remote_example_over_tcp_under_a_seeded_fault_plan(weights):
    """Every frame completes with the tokens of the clean run, and both
    packages meet the same faults and make the same retries.  A retried
    request reaches the server after later frames of its stream, and the
    server numbers frames as they arrive: a served frame is matched to
    the caller's by the mel it carried, not by frame id."""
    runs = {package: TPT.run_remote_peer(
                package, weights, CALLER_RULES, SERVING_RULES, retries=4,
                timeout=3.0)
            for package in ("torch", "jax")}
    clean = RS._tokens(RS.run_remote("torch", weights)[0])
    summary = {}
    for package, run in runs.items():
        done, served, caller = run[0], run[1], run[2]
        assert len(done) == RS.STREAMS * RS.FRAMES and not \
            caller._pending_remote
        tokens = RS._tokens(done)
        assert tokens.keys() == clean.keys()
        for frame in done:
            key = (frame.stream_id, frame.frame_id)
            np.testing.assert_array_equal(tokens[key], clean[key])
            mel = np.asarray(frame.swag["mel"])
            match, = [f for f in served
                      if np.array_equal(f.swag["mel"], mel)]
            np.testing.assert_array_equal(match.swag["tokens"], tokens[key])
        plans = run[5]
        summary[package] = (tokens, dict(plans[0].stats),
                            dict(plans[1].stats), dict(caller.recovery_stats))
    torch_summary, jax_summary = summary["torch"], summary["jax"]
    for key, value in torch_summary[0].items():
        np.testing.assert_array_equal(value, jax_summary[0][key])
    assert torch_summary[1:] == jax_summary[1:]
    caller_faults, serving_faults, recovery = torch_summary[1:]
    assert caller_faults["drop"] > 0 and serving_faults["delay"] > 0
    assert recovery["retries"] > 0 and recovery["frames_failed"] == 0
