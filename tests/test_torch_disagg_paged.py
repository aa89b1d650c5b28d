"""Disaggregated serving over a paged decode pool, the port against the
JAX package (tests/test_disagg.py's TestPagedDisagg, and the direct
slot-table install of tests/test_paged_kv.py): shipped KV lands once
(wire -> pool, one index copy per layer and plane), the admit is a table
edit, bursts coalesce into batch envelopes, and a cacheless paged pool
installs by install_shipped_blocks and submit's kv_blocks.  Tiny preset,
f32: tokens must equal JAX's and llama_greedy_decode's, and the
deterministic counters of both sides of the split must agree.  The JAX
paged decoders get fresh_table_scratch; the port's run the paged
kernel's plain version."""

import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
import aiko_services_tpu.serving_disagg as JD
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch import serving_disagg as TD

from test_torch_disagg import (J_CONFIG, LONG, PROMPT, T_CONFIG,  # noqa
                               make_harness, oracle, run_one, scenario,
                               weights)
from test_torch_paged_chunked import fresh_table_scratch

torch.set_num_threads(1)

PAGED = {"decoder_opts": {"paged_kv": True}}


def cacheless(package, weights, **kwargs):
    params, model = weights
    kwargs = {"max_slots": 4, "prefill_buckets": (64,), "steps_per_sync": 4,
              "prefill_chunk": 16, "paged_kv": True, "kv_block": 8,
              **kwargs}
    if package == "jax":
        decoder = JS.ContinuousDecoder(params, J_CONFIG, name="cacheless",
                                       **kwargs)
        fresh_table_scratch(decoder)
        return decoder
    return TS.ContinuousDecoder(model, T_CONFIG, name="cacheless",
                                device="cpu", **kwargs)


class TestPagedDisagg:
    @pytest.mark.parametrize("kv", ["native", "int8"])
    def test_paged_install_lands_once_bit_identical(self, weights, kv):
        """The transfer's pool write is the only landing: the admit
        copies no KV bytes, and the pool installed the 5 blocks."""
        opts = {"decoder_opts": {"paged_kv": True, **(
            {"kv_cache_dtype": "int8"} if kv == "int8" else {})}}

        def drive(harness):
            tokens = run_one(harness, "r1", PROMPT, 10)
            return tokens, harness.decoder.stats["prefix_copy_bytes"], \
                harness.decoder.pool.stats["install_blocks"]

        out = scenario(weights, drive, **opts)
        assert out["torch"][0] == out["jax"][0]
        assert out["torch"][0][1:] == (0, 5)
        assert out["torch"][1] == out["jax"][1]
        stats = out["torch"][1]
        assert (stats["client.installs"], stats["client.local_fallbacks"],
                stats["decoder.prefix_admits"]) == (1, 0, 1)
        if kv == "native":
            assert out["torch"][0][0] == oracle(weights[0], PROMPT, 10)

    def test_chunk_streamed_paged_install(self, weights):
        """Chunk streaming into a paged cache: four streamed chunks and
        the final land as pool blocks, tokens unchanged."""
        out = scenario(weights, lambda h: run_one(h, "r1", LONG, 10),
                       **PAGED)
        assert out["torch"][0] == out["jax"][0] == \
            oracle(weights[0], LONG, 10)
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][1]["client.chunk_installs"] == 4

    def test_burst_coalesces_into_batch_envelopes(self, weights):
        """Transfers to one destination inside the batch window ride one
        kv_transfer_batch envelope; every request installs and completes
        with the same tokens as JAX's."""
        rng = np.random.default_rng(3)
        prompts = {f"b{i}": rng.integers(1, J_CONFIG.vocab,
                                         size=40).tolist()
                   for i in range(6)}

        def drive(harness):
            done = {}
            for rid, prompt in prompts.items():
                harness.submit(rid, prompt, 4, lambda r, t: done.update(
                    {r: [int(x) for x in t]}))
            assert harness.run_until(lambda: len(done) == 6,
                                     timeout=300.0)
            stats = harness.prefill.stats
            assert stats["batched_envelopes"] >= 1
            assert stats["envelopes"] < 6
            assert harness.client.stats["batched_replies"] >= 1
            return done

        out = scenario(weights, drive, max_slots=8, prefill_slots=4,
                       batch_window=0.05, **PAGED)
        assert out["torch"][0] == out["jax"][0]
        for stats in (out["torch"][1], out["jax"][1]):
            assert (stats["client.installs"],
                    stats["client.local_fallbacks"]) == (6, 0)
        from aiko_services_tpu_torch.observe.metrics import \
            default_registry
        assert default_registry().value(
            "disagg_transfer_batched_total",
            {"runtime": "disagg_prefill"}) >= 2

    @pytest.mark.parametrize("prompt", ["short", "long"])
    def test_cacheless_decode_pool_direct_install(self, weights, prompt):
        """A paged decoder without a prefix cache rides the split:
        shipped blocks land in its pool (streamed chunks first, for the
        long prompt) and alias into the request's slot table; nothing
        survives the request."""
        tokens_in = PROMPT if prompt == "short" else LONG
        seen = {}
        for package, disagg in (("jax", JD), ("torch", TD)):
            harness = make_harness(package, weights, **PAGED)
            try:
                assert harness.wait_discovered(15.0)
                decoder = cacheless(package, weights)
                harness.engine.add_flatout_handler(decoder.pump)
                client = disagg.PrefillClient(harness.decode_rt, decoder,
                                              name=f"cacheless.{package}",
                                              transfer_timeout=60.0)
                client.add_candidate(harness.prefill.topic_path)
                done = {}
                client.submit("c1", tokens_in, 10,
                              lambda r, t: done.update(
                                  {r: [int(x) for x in t]}))
                assert harness.run_until(lambda: "c1" in done,
                                         timeout=300.0)
                assert harness.run_until(lambda: decoder.idle,
                                         timeout=60.0)
                seen[package] = (
                    done["c1"], {k: client.stats[k] for k in (
                        "direct_installs", "local_fallbacks",
                        "chunk_installs", "chunk_blocks", "chunk_dropped",
                        "installed_blocks", "installs")},
                    decoder.stats["prefix_admits"],
                    decoder.stats["tokens_prefill"],
                    decoder.pool.used_blocks())
                client.stop()
                harness.engine.remove_flatout_handler(decoder.pump)
            finally:
                harness.stop()
        assert seen["torch"] == seen["jax"]
        tokens, stats, admits, _, used = seen["torch"]
        assert tokens == oracle(weights[0], tokens_in, 10)
        assert (stats["direct_installs"], stats["local_fallbacks"],
                admits, used) == (1, 0, 1, 0)
        if prompt == "long":
            assert stats["chunk_installs"] == 4


class TestDirectInstall:
    """install_shipped_blocks and submit(kv_blocks=...) on the decoder
    alone, both packages: the installed blocks alias into the slot, a
    whole-prompt cover drops its final block, a truncated prompt drops
    the install (install_misaligned) and prefills cold."""

    def donor_blocks(self, weights, prompt):
        cache = TS.PrefixKVCache(block_tokens=8, name="donor")
        donor = TS.ContinuousDecoder(weights[1], T_CONFIG, max_slots=2,
                                     prefill_buckets=(64,),
                                     prefill_chunk=16, prefix_cache=cache,
                                     paged_kv=True, kv_block=8,
                                     device="cpu")
        done = {}
        donor.submit("d", prompt, 1, lambda r, t: done.update({r: t}))
        while "d" not in done:
            donor.pump()
        keys, _ = cache.match("", prompt)
        rows = TD._chain_wire_blocks(cache, keys)
        # the JAX decoder takes numpy rows, the port's the host tensors
        jax_blocks = [{side: [np.asarray(layer[side]) for layer in block]
                       for side in ("k", "v")} for block in rows.blocks]
        return TD._landing(rows.blocks), jax_blocks

    @pytest.mark.parametrize("case", ["partial", "whole", "truncated"])
    def test_kv_blocks_alias_into_the_slot(self, weights, case):
        prompt = {"partial": PROMPT, "whole": PROMPT[:32],
                  "truncated": PROMPT}[case]
        port_blocks, jax_blocks = self.donor_blocks(weights, prompt)
        seen = {}
        for package in ("jax", "torch"):
            kwargs = {"prefill_chunk": None, "prefill_buckets": (32,)} \
                if case == "truncated" else {}
            decoder = cacheless(package, weights, **kwargs)
            blocks = port_blocks if package == "torch" else jax_blocks
            covered, ids = decoder.install_shipped_blocks(
                prompt, 0, blocks)
            done = {}
            assert decoder.submit("r", prompt, 6, lambda r, t: done.update(
                {r: [int(x) for x in t]}), kv_blocks=(covered, ids))
            while "r" not in done:
                decoder.pump()
            seen[package] = (covered, len(ids), done["r"], {
                k: decoder.stats[k] for k in (
                    "prefix_admits", "tokens_prefill",
                    "install_misaligned")},
                decoder.pool.used_blocks())
        assert seen["torch"] == seen["jax"]
        covered, count, tokens, stats, used = seen["torch"]
        assert used == 0
        if case == "truncated":
            assert stats["install_misaligned"] == 1
            assert stats["prefix_admits"] == 0
            assert tokens == oracle(weights[0], prompt[-32:], 6)
        else:
            assert stats["prefix_admits"] == 1
            assert tokens == oracle(weights[0], prompt, 6)
        if case == "whole":
            # a whole-prompt cover keeps one suffix token: the last block
            # goes back to the pool and prefills here
            assert (covered, count, stats["tokens_prefill"]) == (32, 4, 8)

    def test_geometry_and_form_refused(self, weights):
        decoder = cacheless("torch", weights)
        good = np.zeros((T_CONFIG.num_kv_heads, 8, T_CONFIG.head_dim),
                        np.float32)
        with pytest.raises(ValueError):
            decoder.install_shipped_blocks(list(range(8)), 0,
                                           [{"k": [good], "v": [good]}])
        with pytest.raises(ValueError, match="negative"):
            decoder.install_shipped_blocks(list(range(8)), -1, [])
        assert decoder.install_shipped_blocks(list(range(4)), 0, []) == \
            (0, [])
        assert decoder.pool.used_blocks() == 0
        dense = TS.ContinuousDecoder(weights[1], T_CONFIG, max_slots=2,
                                     device="cpu")
        with pytest.raises(ValueError, match="paged"):
            dense.install_shipped_blocks(list(range(8)), 0, [])
        with pytest.raises(ValueError, match="paged"):
            dense.submit("r", PROMPT, 2, lambda *_: None,
                         kv_blocks=(8, [1]))
        assert decoder.kv_wire_layout() == tuple(
            str(f) for f in decoder._kv_layout)
