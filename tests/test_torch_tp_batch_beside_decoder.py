"""A batched program and a ContinuousDecoder on one mesh of two gloo
ranks, in one process each, as the parallel assistant example runs a
batched ASR beside a continuous agent.

Both agree across the ranks: the decoder in its round note (a blocking
gather at the top of its round), the runtime in its batch exchange
(compute.py `_agree_batches`: asynchronous gathers polled at each drive
tick, so the event loop never waits there).  Each rank submits its batch
items and its decoder requests at engine steps of its own, so the two
agreements interleave differently on each rank; a blocking batch gather
would pair against the other rank's note gather and hang.  Tolerance:
every item's sum and every request's tokens equal the unsharded
decoder's (f32); the ranks run the same batches and round plans."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
from aiko_services_tpu_torch.serving import ContinuousDecoder

import torch_spmd_cases as cases
from torch_spmd import run_ranks

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
PROMPTS = {f"r{k}": [(k * 7 + i) % 90 + 3 for i in range(5 + 2 * k)]
           for k in range(6)}
MAX_NEW = 8
ITEMS = [[k, 2 * k, 3, k % 5] for k in range(12)]


@functools.cache
def flat():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(cases.batched_beside_decoder, 2,
                     tmp_path_factory.mktemp("beside"), flat(), FIELDS,
                     PROMPTS, MAX_NEW, ITEMS, timeout=180.0)


def test_both_agreements_complete_beside_each_other(ranks):
    config = TL.LlamaConfig(**FIELDS)
    decoder = ContinuousDecoder(
        bridge.params_from_numpy(flat(), config, device="cpu"), config,
        device="cpu", max_slots=2, prefill_buckets=(16,), steps_per_sync=2,
        registry=MetricsRegistry())
    done = {}
    for rid, prompt in PROMPTS.items():
        decoder.submit(rid, prompt, MAX_NEW, lambda r, t: done.update(
            {r: [int(x) for x in t]}))
    for _ in range(400):
        if len(done) == len(PROMPTS):
            break
        decoder.pump()
    for rank in ranks:
        assert rank["sums"] == {k: sum(item) for k, item in
                                enumerate(ITEMS)}
        assert rank["tokens"] == done


def test_the_ranks_run_the_same_batches_and_rounds(ranks):
    assert ranks[0]["plans"] and ranks[0]["batches"]
    assert ranks[1]["plans"] == ranks[0]["plans"]
    assert ranks[1]["batches"] == ranks[0]["batches"]
