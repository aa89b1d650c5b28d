"""Disaggregated prefill / decode serving on the port against the JAX
package (tests/test_disagg.py's parity, chaos, chunk-streaming, dedup,
role-tag and review-fix cases), on the dense slot cache, the JAX
default.  Each case runs the JAX DisaggHarness (or decoder) and the
port's on the same seeded tiny-preset f32 weights: greedy tokens must be
identical to each other and to llama_greedy_decode, and so must the
deterministic counters of PrefillRuntime.stats and PrefillClient.stats
(blocks shipped, handle blocks, installs, fallbacks; not bytes: the
layout field names each package's dtype).  The harnesses run on real
clocks, so a timing-dependent counter is compared only where the JAX
test asserts it.  The paged cases are in tests/test_torch_disagg_paged.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
import aiko_services_tpu.serving_disagg as JD
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch import serving_disagg as TD
from aiko_services_tpu_torch.models import llama as TL

from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=128)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
# chunked extends (and chunk streaming) engage past the largest bucket
# (64): 80 tokens are five 16-token chunks
LONG = (PROMPT * 3)[:80]
# the deterministic counters of each side of the split
CLIENT_STATS = ("transfers", "installs", "installed_blocks",
                "handle_blocks", "raw_blocks", "local_fallbacks",
                "local_short", "local_no_pool", "local_cached",
                "install_shed", "direct_installs", "layout_mismatch",
                "chunk_installs", "chunk_blocks", "chunk_dropped",
                "chunk_streamed", "batched_replies")
PREFILL_STATS = ("requests", "computed", "blocks_shipped", "handle_blocks",
                 "refused", "empty_ships", "chunks_shipped",
                 "chunk_blocks")
DECODER_STATS = ("prefix_admits", "tokens_prefill", "completed",
                 "prefill_chunks")
PACKAGES = ("jax", "torch")


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def oracle(params, prompt, max_new):
    out = jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=max_new))(
        params, prompt=jnp.asarray([prompt], jnp.int32))
    return [int(t) for t in np.asarray(out)[0]]


def make_harness(package, weights, disagg=True, **kwargs):
    """One package's DisaggHarness with tests/test_disagg.py's geometry;
    JAX paged decoders get fresh_table_scratch."""
    params, model = weights
    kwargs.setdefault("block_tokens", 8)
    kwargs.setdefault("max_slots", 4)
    kwargs.setdefault("prefill_slots", 2)
    kwargs.setdefault("prefill_chunk", 16)
    kwargs.setdefault("prefill_buckets", (64,))
    if package == "jax":
        harness = JD.DisaggHarness(params, J_CONFIG, disagg=disagg,
                                   **kwargs)
        for decoder in (harness.decoder, harness.prefill and
                        harness.prefill.decoder):
            if decoder and decoder.paged:
                fresh_table_scratch(decoder)
        return harness
    kwargs["decoder_opts"] = {**kwargs.get("decoder_opts", {}),
                              "device": "cpu"}
    return TD.DisaggHarness(model, T_CONFIG, disagg=disagg, **kwargs)


def run_one(harness, rid, prompt, max_new, timeout=120.0, **kwargs):
    done = {}
    harness.submit(rid, prompt, max_new,
                   lambda r, t: done.update({r: [int(x) for x in t]}),
                   **kwargs)
    assert harness.run_until(lambda: rid in done, timeout=timeout), \
        f"request {rid} never completed"
    return done[rid]


def counters(harness) -> dict:
    out = {f"decoder.{k}": harness.decoder.stats[k] for k in DECODER_STATS}
    if harness.client is not None:
        out.update({f"client.{k}": harness.client.stats[k]
                    for k in CLIENT_STATS})
    if harness.prefill is not None:
        out.update({f"prefill.{k}": harness.prefill.stats[k]
                    for k in PREFILL_STATS})
    return out


def scenario(weights, drive, disagg=True, **kwargs):
    """drive(harness) on both packages: {package: (drive's result,
    counters, harness)}, every harness stopped."""
    out = {}
    for package in PACKAGES:
        harness = make_harness(package, weights, disagg=disagg, **kwargs)
        try:
            if disagg:
                assert harness.wait_discovered(15.0)
            result = drive(harness)
            out[package] = (result, counters(harness), harness)
        finally:
            harness.stop()
    return out


class TestDisaggParity:
    def test_disagg_greedy_bit_identical_and_suffix_only(self, weights):
        """Remote-prefilled tokens equal the oracle's and JAX's, and the
        decode decoder prefilled only the ragged suffix."""
        def drive(harness):
            tokens = run_one(harness, "r1", PROMPT, 10)
            remote = harness.decoder.slo_sketch_stats(prefill="remote")
            cold = harness.decoder.slo_sketch_stats(prefill="cold")
            return tokens, remote["ttft_p50_ms"] is not None, \
                cold["ttft_p50_ms"] is None

        out = scenario(weights, drive)
        expect = oracle(weights[0], PROMPT, 10)
        assert out["torch"][0] == out["jax"][0] == (expect, True, True)
        assert out["torch"][1] == out["jax"][1]
        stats = out["torch"][1]
        # 40-token prompt, block 8: 5 blocks shipped; the decode side
        # prefills only the 8-token anchored suffix
        assert stats["client.installed_blocks"] == 5
        assert stats["client.installs"] == stats["client.transfers"] == 1
        assert stats["client.local_fallbacks"] == 0
        assert stats["decoder.prefix_admits"] == 1
        assert stats["decoder.tokens_prefill"] <= 16

    def test_second_turn_ships_handles_and_repeat_stays_local(self,
                                                              weights):
        """A second turn ships its shared prefix as handles; an
        identical repeat skips the remote hop (the decode side holds the
        whole chain)."""
        turn2 = PROMPT + [7, 9, 3, 5, 2, 8, 6, 1]

        def drive(harness):
            first = run_one(harness, "r1", PROMPT, 10)
            second = run_one(harness, "r2", turn2, 10)
            third = run_one(harness, "r3", PROMPT, 10)
            return first, second, third, harness.client.handle_hit_rate()

        out = scenario(weights, drive)
        assert out["torch"][0] == out["jax"][0]
        assert out["torch"][0][1] == oracle(weights[0], turn2, 10)
        assert out["torch"][1] == out["jax"][1]
        stats = out["torch"][1]
        assert stats["client.handle_blocks"] >= 5
        assert stats["client.local_cached"] == 1
        assert stats["client.transfers"] == 2      # r3 never went remote

    def test_int8_kv_ships_quantized_layout_bit_faithful(self, weights):
        """int8 decoders ship {"q", "s"} blocks: the disaggregated tokens
        equal a colocated int8 decoder's (the transfer carries the
        donor's stored bytes, no second rounding) and JAX's int8
        split."""
        opts = {"decoder_opts": {"kv_cache_dtype": "int8"}}
        harness = make_harness("torch", weights, disagg=False, **opts)
        try:
            colocated = run_one(harness, "c1", PROMPT, 10)
        finally:
            harness.stop()
        out = scenario(weights, lambda h: run_one(h, "r1", PROMPT, 10),
                       **opts)
        assert out["torch"][0] == colocated == out["jax"][0]
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][1]["client.transfers"] == 1

    def test_no_pool_prefills_locally(self, weights):
        """The colocated harness: the same tokens and no transfers; a
        client with no candidate falls straight to local prefill,
        counted."""
        out = scenario(weights, lambda h: run_one(h, "r1", PROMPT, 10),
                       disagg=False)
        assert out["torch"][0] == out["jax"][0] == \
            oracle(weights[0], PROMPT, 10)
        assert out["torch"][1] == out["jax"][1]
        seen = {}
        for package, serving, disagg in (("jax", JS, JD),
                                         ("torch", TS, TD)):
            harness = make_harness(package, weights)
            try:
                client = disagg.PrefillClient(
                    harness.decode_rt, harness.decoder, name="lonely")
                tokens = run_one(client_harness(harness, client), "r1",
                                 PROMPT, 6)
                seen[package] = (tokens, client.stats["local_no_pool"],
                                 client.stats["transfers"])
                client.stop()
            finally:
                harness.stop()
        assert seen["torch"] == seen["jax"]
        assert seen["torch"][1:] == (1, 0)


def client_harness(harness, client):
    """`harness` driven through another client's submit."""
    class Through:
        def submit(self, *args, **kwargs):
            return client.submit(*args, **kwargs)

        def run_until(self, predicate, timeout=30.0):
            return harness.run_until(predicate, timeout=timeout)
    return Through()


class TestTransferChaos:
    def test_dropped_transfers_retry_then_fall_back_local(self, weights):
        """Every KV-transfer reply dropped on the peer channel: the
        client times out, retries, times out again and prefills locally;
        the tokens are unchanged and nothing is lost."""
        from aiko_services_tpu.transport.chaos import FaultPlan as JPlan
        from aiko_services_tpu_torch.transport.chaos import FaultPlan

        seen = {}
        for package, plan_type in (("jax", JPlan), ("torch", FaultPlan)):
            plan = plan_type(seed=11)
            plan.drop(payload_match="kv_transfer")
            harness = make_harness(package, weights, fault_plan=plan,
                                   transfer_timeout=0.3, retries=1)
            try:
                assert harness.wait_discovered(15.0)
                tokens = run_one(harness, "r1", PROMPT, 10)
                stats = harness.client.stats
                assert stats["transfer_timeouts"] >= 2
                assert stats["retries"] >= 1
                seen[package] = (tokens, stats["local_fallbacks"],
                                 harness.client.pending_count())
            finally:
                harness.stop()
        assert seen["torch"] == seen["jax"] == \
            (oracle(weights[0], PROMPT, 10), 1, 0)

    def test_truncated_transfer_detected_then_recovered(self, weights):
        """A truncated transfer fails the schema check (counted corrupt,
        never installed) and the ladder still completes the request."""
        from aiko_services_tpu.transport.chaos import FaultPlan as JPlan
        from aiko_services_tpu_torch.transport.chaos import FaultPlan

        seen = {}
        for package, plan_type in (("jax", JPlan), ("torch", FaultPlan)):
            plan = plan_type(seed=7)
            plan.truncate(payload_match="kv_transfer", truncate_to=64,
                          count=2)
            harness = make_harness(package, weights, fault_plan=plan,
                                   transfer_timeout=0.4, retries=1)
            try:
                assert harness.wait_discovered(15.0)
                tokens = run_one(harness, "r1", PROMPT, 10)
                stats = harness.client.stats
                assert stats["transfer_corrupt"] >= 1
                assert stats["local_fallbacks"] + stats["installs"] >= 1
                seen[package] = (tokens, harness.client.pending_count())
            finally:
                harness.stop()
        assert seen["torch"] == seen["jax"] == \
            (oracle(weights[0], PROMPT, 10), 0)

    def test_prefill_kill_mid_transfer_loses_nothing(self, weights):
        """The prefill runtime dies with transfers in flight: every
        request rides the ladder to a local prefill, none dropped."""
        prompts = {f"r{i}": [p + i for p in PROMPT] for i in range(3)}

        def drive(harness):
            done = {}
            for rid, prompt in prompts.items():
                harness.submit(rid, prompt, 8, lambda r, t: done.update(
                    {r: [int(x) for x in t]}))
            assert harness.client.pending_count() >= 1
            harness.kill_prefill()
            assert harness.run_until(lambda: len(done) == len(prompts),
                                     timeout=120.0)
            assert harness.client.stats["local_fallbacks"] >= 1
            assert harness.client.pending_count() == 0
            return done

        out = scenario(weights, drive, transfer_timeout=0.5, retries=1)
        assert out["torch"][0] == out["jax"][0]
        for rid, prompt in prompts.items():
            assert out["torch"][0][rid] == oracle(weights[0], prompt, 8)


class TestChunkStreaming:
    def test_chunks_stream_during_prefill(self, weights):
        """Each finished chunk's blocks ship at once: the client installs
        them while the donor still prefills, the final envelope ships the
        remainder, and the tokens are unchanged."""
        def drive(harness):
            tokens = run_one(harness, "r1", LONG, 10)
            return tokens, harness.client.stats["transfer_overlap_s"] > 0

        out = scenario(weights, drive)
        assert out["torch"][0] == out["jax"][0] == \
            (oracle(weights[0], LONG, 10), True)
        assert out["torch"][1] == out["jax"][1]
        stats = out["torch"][1]
        # 80-token prompt, chunk 16, block 8: four mid-prefill chunks of
        # two blocks each stream ahead of the final
        assert (stats["prefill.chunks_shipped"],
                stats["prefill.chunk_blocks"],
                stats["client.chunk_installs"],
                stats["client.chunk_blocks"],
                stats["client.chunk_dropped"],
                stats["client.chunk_streamed"],
                stats["client.installs"],
                stats["client.local_fallbacks"]) == (4, 8, 4, 8, 0, 1, 1, 0)

    def test_chunk_stream_off_matches(self, weights):
        """chunk_stream=False: identical tokens, every block rides the
        single final envelope."""
        def drive(harness):
            tokens = run_one(harness, "r1", LONG, 10)
            return tokens, harness.client.stats["transfer_overlap_s"]

        out = scenario(weights, drive, chunk_stream=False)
        assert out["torch"][0] == out["jax"][0] == \
            (oracle(weights[0], LONG, 10), 0.0)
        assert out["torch"][1] == out["jax"][1]
        stats = out["torch"][1]
        assert (stats["prefill.chunks_shipped"],
                stats["client.chunk_installs"],
                stats["client.chunk_streamed"],
                stats["client.installs"]) == (0, 0, 0, 1)

    def test_corrupt_chunk_recovers_zero_lost(self, weights):
        """The first streamed chunk truncated in flight: dropped as
        corrupt, and later members and the ladder still complete the
        request with the same tokens."""
        from aiko_services_tpu.transport.chaos import FaultPlan as JPlan
        from aiko_services_tpu_torch.transport.chaos import FaultPlan

        seen = {}
        for package, plan_type in (("jax", JPlan), ("torch", FaultPlan)):
            plan = plan_type(seed=5)
            plan.truncate(payload_match="kv_transfer", truncate_to=64,
                          count=1)
            harness = make_harness(package, weights, fault_plan=plan,
                                   transfer_timeout=0.5, retries=1)
            try:
                assert harness.wait_discovered(15.0)
                tokens = run_one(harness, "r1", LONG, 10)
                stats = harness.client.stats
                assert stats["transfer_corrupt"] >= 1
                assert stats["installs"] + stats["local_fallbacks"] >= 1
                seen[package] = (tokens, harness.client.pending_count())
            finally:
                harness.stop()
        assert seen["torch"] == seen["jax"] == \
            (oracle(weights[0], LONG, 10), 0)


class TestDedupWindow:
    """The in-flight prefix dedup window, on the dense decoder with a
    prefix cache (the prefill runtime's own decoder shape)."""

    def decoders(self, weights, **kwargs):
        params, model = weights
        out = {}
        for package, serving, tree, config in (
                ("jax", JS, params, J_CONFIG),
                ("torch", TS, model, T_CONFIG)):
            cache = serving.PrefixKVCache(
                block_tokens=8, max_bytes=kwargs.get("max_bytes", 64 << 20),
                name=f"dedup.{package}.{len(kwargs)}")
            extra = {"device": "cpu"} if package == "torch" else {}
            out[package] = (serving.ContinuousDecoder(
                tree, config, max_slots=4, prefill_buckets=(64,),
                steps_per_sync=kwargs.get("steps_per_sync", 4),
                prefill_chunk=16, prefix_cache=cache, **extra), cache)
        return out

    @staticmethod
    def run(decoder, requests, rounds=500):
        done = {}
        for rid, (prompt, max_new) in requests.items():
            decoder.submit(rid, prompt, max_new, lambda r, t: done.update(
                {r: [int(x) for x in t]}))
        for _ in range(rounds):
            decoder.pump()
            if len(done) == len(requests):
                break
        assert len(done) == len(requests)
        return done

    @pytest.mark.parametrize("case", ["shared", "refused", "distinct"])
    def test_same_batch_duplicates(self, weights, case):
        """Two identical prompts together: the follower defers behind the
        leader's prefill and admits as a prefix hit (prefill paid once);
        a budget that refuses the leader's harvest sends the follower
        cold; distinct prompts never defer."""
        other = [(i * 7) % 50 + 3 for i in range(40)]
        requests = {"a": (PROMPT, 10),
                    "b": (other if case == "distinct" else PROMPT, 10)}
        kwargs = {"max_bytes": 1} if case == "refused" else {}
        seen = {}
        for package, (decoder, cache) in self.decoders(weights,
                                                       **kwargs).items():
            done = self.run(decoder, requests)
            seen[package] = (done, {k: decoder.stats[k] for k in (
                "dedup_deferred", "dedup_shared", "prefix_admits",
                "tokens_prefill")}, decoder._inflight_chains == {},
                all(n.refs == 0 for n in cache._nodes.values()))
        assert seen["torch"] == seen["jax"]
        done, stats, drained, unpinned = seen["torch"]
        for rid, (prompt, max_new) in requests.items():
            assert done[rid] == oracle(weights[0], prompt, max_new)
        assert drained and unpinned
        if case == "shared":
            assert stats["dedup_deferred"] >= 1
            assert stats["prefix_admits"] == 1
            assert stats["tokens_prefill"] <= len(PROMPT) + 16
        if case == "distinct":
            assert stats["dedup_deferred"] == 0

    def test_late_follower_shares_without_waiting_out_generation(
            self, weights):
        """A duplicate arriving after the leader's first token harvests
        the leader's prompt at its admit check and admits as a prefix
        hit while the leader still decodes."""
        seen = {}
        for package, (decoder, _) in self.decoders(
                weights, steps_per_sync=2).items():
            done = {}
            keep = (lambda r, t: done.update({r: [int(x) for x in t]}))
            decoder.submit("leader", PROMPT, 40, keep)
            leader = None
            for _ in range(200):
                decoder.pump()
                leader = next((r for r in decoder._slots if r is not None),
                              None)
                if leader is not None and leader.generated:
                    break
            assert leader is not None and len(leader.generated) < 30
            decoder.submit("dup", PROMPT, 8, keep)
            for _ in range(400):
                decoder.pump()
                if "dup" in done:
                    break
            while "leader" not in done:
                decoder.pump()
            seen[package] = (done, decoder.stats["prefix_admits"],
                             decoder.stats["dedup_shared"] >= 1,
                             decoder._inflight_chains == {})
        assert seen["torch"] == seen["jax"]
        assert seen["torch"][1:] == (1, True, True)
        assert seen["torch"][0]["dup"] == oracle(weights[0], PROMPT, 8)
        assert seen["torch"][0]["leader"] == oracle(weights[0], PROMPT, 40)


class TestRoleTags:
    def test_prefill_runtime_advertises_role_tag(self, weights):
        def drive(harness):
            return any("role=prefill" in fields.tags
                       for fields in harness._services_cache.services)

        out = scenario(weights, drive)
        assert out["torch"][0] is out["jax"][0] is True

    def test_role_tagged_pipeline_is_not_a_prefill_candidate(self,
                                                            weights):
        """A record tagged role=prefill without the prefill protocol (a
        pipeline's) is never routed transfers."""
        from aiko_services_tpu.service import Service as JService
        from aiko_services_tpu_torch.service import Service

        seen = {}
        for package, service in (("jax", JService), ("torch", Service)):
            harness = make_harness(package, weights)
            try:
                assert harness.wait_discovered(15.0)
                real = set(harness.client.loads)
                decoy = service(harness.decode_rt, "decoy", "pipeline",
                                tags=["role=prefill"])
                harness.decode_rt._register_service(decoy)
                harness.run_until(lambda: False, timeout=0.5)
                seen[package] = (decoy.topic_path in harness.client.loads,
                                 set(harness.client.loads) == real,
                                 len(real))
            finally:
                harness.stop()
        assert seen["torch"] == seen["jax"] == (False, True, 1)

    def test_tag_role_tags_and_reregisters(self):
        assert TD.role_tag(TD.ROLE_DECODE) == JD.role_tag(JD.ROLE_DECODE)
        assert (TD.ROLE_PREFILL, TD.ROLE_DECODE, TD.ROLE_COLOCATED) == \
            (JD.ROLE_PREFILL, JD.ROLE_DECODE, JD.ROLE_COLOCATED)
        assert str(TD.PROTOCOL_PREFILL) == str(JD.PROTOCOL_PREFILL)

        class Runtime:
            registrar = message = object()
            registered = []

            def _register_service(self, service):
                self.registered.append(service)

        class Service:
            runtime = Runtime()
            tags = []

            def add_tags(self, tags):
                self.tags.extend(tags)

        service = Service()
        TD.tag_role(service, "decode")
        assert service.tags == ["role=decode"]
        assert service.runtime.registered == [service]


class TestReviewFixes:
    def test_sync_shed_signals_exactly_once(self, weights):
        """A synchronous local-rung shed returns False without also
        firing on_refused."""
        import time as _time

        from aiko_services_tpu_torch.event import EventEngine
        from aiko_services_tpu_torch.process import ProcessRuntime
        runtime = ProcessRuntime(name="shed_rt",
                                 engine=EventEngine()).initialize()
        cache = TS.PrefixKVCache(block_tokens=8, name="shed_cache")
        decoder = TS.ContinuousDecoder(weights[1], T_CONFIG, max_slots=2,
                                       prefill_buckets=(64,),
                                       prefix_cache=cache, device="cpu")
        client = TD.PrefillClient(runtime, decoder, name="shed")
        refused = []
        decoder._round_ewma = 10.0
        ok = client.submit("r1", [1, 2, 3], 4, lambda *_: None,
                           deadline=_time.monotonic() - 1.0,
                           on_refused=refused.append)
        assert ok is False and refused == []
        assert client.stats["install_shed"] == 1
        assert client.stats["local_short"] == 1
        client.stop()
        runtime.terminate()

    def test_geometry_wrong_blocks_refused_before_any_row_lands(
            self, weights):
        """Schema-legal but geometry-wrong blocks are refused at install
        on both packages' caches, and no row lands."""
        for package, serving, tree, config in (
                ("jax", JS, weights[0], J_CONFIG),
                ("torch", TS, weights[1], T_CONFIG)):
            cache = serving.PrefixKVCache(block_tokens=8,
                                          name=f"geom.{package}")
            extra = {"device": "cpu"} if package == "torch" else {}
            serving.ContinuousDecoder(tree, config, max_slots=2,
                                      prefill_buckets=(64,),
                                      prefix_cache=cache, **extra)
            good = np.zeros((config.num_kv_heads, 8, config.head_dim),
                            np.float32)
            with pytest.raises(ValueError):
                cache.install_chain("t", list(range(8)), 0,
                                    [{"k": [good], "v": [good]}])
            bad = np.zeros((config.num_kv_heads + 1, 8, config.head_dim),
                           np.float32)
            with pytest.raises(ValueError):
                cache.install_chain("t", list(range(8)), 0, [{
                    "k": [bad] * config.num_layers,
                    "v": [bad] * config.num_layers}])
            assert len(cache) == 0, package
        with pytest.raises(ValueError, match="unbound"):
            TS.PrefixKVCache(block_tokens=8).install_chain(
                "t", list(range(8)), 0, [{"k": [good], "v": [good]}])

    def test_dense_install_chain_nodes_own_their_rows(self, weights):
        """A dense install copies each block into storage of its own
        (not a view of the wire payload) and the chain then serves a
        hit with the oracle's tokens."""
        cache = TS.PrefixKVCache(block_tokens=8, name="own")
        decoder = TS.ContinuousDecoder(weights[1], T_CONFIG, max_slots=2,
                                       prefill_buckets=(64,),
                                       prefill_chunk=16,
                                       prefix_cache=cache, device="cpu")
        donor_cache = TS.PrefixKVCache(block_tokens=8, name="donor")
        donor = TS.ContinuousDecoder(weights[1], T_CONFIG, max_slots=2,
                                     prefill_buckets=(64,),
                                     prefill_chunk=16,
                                     prefix_cache=donor_cache,
                                     device="cpu")
        done = {}
        donor.submit("d", PROMPT, 1, lambda r, t: done.update({r: t}))
        while "d" not in done:
            donor.pump()
        keys, hit = donor_cache.match("", PROMPT)
        assert hit == 40
        rows = TD._chain_wire_blocks(donor_cache, keys)
        assert rows.ready() and len(rows.blocks) == 5
        from aiko_services_tpu_torch.transport import wire
        payload = wire.encode_kv_transfer(
            "x", "", PROMPT, 0, 8, donor_cache.wire_layout(), rows.blocks)
        out = wire.decode_kv_transfer(payload)
        assert cache.install_chain("", out["tokens"], 0,
                                   TD._landing(out["blocks"])) == 5
        for node, sent in zip(cache.nodes(keys), rows.blocks):
            for layer, leaf in enumerate(node.k_rows):
                assert torch.equal(leaf, sent[layer]["k"])
                assert leaf.untyped_storage().nbytes() == \
                    leaf.numel() * leaf.element_size()
        decoder.submit("h", PROMPT, 10, lambda r, t: done.update({r: t}))
        while "h" not in done:
            decoder.pump()
        assert [int(t) for t in done["h"]] == \
            oracle(weights[0], PROMPT, 10)
        assert decoder.stats["prefix_admits"] == 1

    def test_long_prompt_past_bucket_still_ships_blocks(self, weights):
        """A PrefillRuntime without an explicit prefill_chunk still
        prefills and ships prompts past its largest bucket, each chain
        block exactly once across the chunk envelopes and the final."""
        long_prompt = [(i * 7) % 90 + 1 for i in range(40)]
        seen = {}
        for package in PACKAGES:
            if package == "jax":
                from aiko_services_tpu.event import EventEngine
                from aiko_services_tpu.process import ProcessRuntime
                from aiko_services_tpu.transport import wire
                extra, runtime_model = {}, (weights[0], J_CONFIG)
                disagg = JD
            else:
                from aiko_services_tpu_torch.event import EventEngine
                from aiko_services_tpu_torch.process import ProcessRuntime
                from aiko_services_tpu_torch.transport import wire
                extra, runtime_model = {"decoder_opts": {"device": "cpu"}}, \
                    (weights[1], T_CONFIG)
                disagg = TD
            runtime = ProcessRuntime(name=f"long_pf_{package}",
                                     engine=EventEngine()).initialize()
            prefill = disagg.PrefillRuntime(
                runtime, "long_pf", params=runtime_model[0],
                config=runtime_model[1], block_tokens=8, max_slots=2,
                prefill_buckets=(16,), pump_period=0, **extra)
            got = []
            reply_topic = f"{runtime.topic_path}/0/reply"
            runtime.add_message_handler(lambda t, p: got.append(p),
                                        reply_topic, binary=True)
            prefill.prefill("t1", reply_topic, "", "0",
                            {"tokens": np.asarray(long_prompt, np.int32)})
            assert runtime.event.run_until(
                lambda: got and wire.decode_kv_transfer(got[-1])["final"],
                timeout=60.0)
            outs = [wire.decode_kv_transfer(p) for p in got]
            assert all(not o["final"] for o in outs[:-1])
            assert [int(t) for t in outs[-1]["tokens"]] == long_prompt
            seen[package] = (
                [(o["start_block"], len(o["blocks"])) for o in outs],
                {k: prefill.stats[k] for k in PREFILL_STATS},
                outs[-1]["first_token"])
            prefill.stop()
            runtime.terminate()
        assert seen["torch"] == seen["jax"]
        assert sum(n for _, n in seen["torch"][0]) == 5   # 40 tok / 8
        assert seen["torch"][1]["empty_ships"] == 0
        assert seen["torch"][1]["chunks_shipped"] >= 1

    def test_client_stop_unregisters_its_reply_topic(self, weights):
        """A stopped client's reply topic leaves the peer negotiation
        records, so later redials do not re-pin it."""
        harness = make_harness("torch", weights)
        try:
            assert harness.wait_discovered(15.0)
            run_one(harness, "r1", PROMPT, 8)
            host = harness.decode_rt.peer
            topic = harness.client.reply_topic
            assert any(topic in record.get("reply_topics", ())
                       for record in host._negotiations.values())
            harness.client.stop()
            assert not any(topic in record.get("reply_topics", ())
                           for record in host._negotiations.values())
            assert not any(key[1] == topic for key in host._attached)
            harness.client = None
        finally:
            harness.stop()

