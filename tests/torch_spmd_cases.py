"""Rank bodies of the port's multi-process CPU tests.

Each function runs on every rank of a gloo group (tests/torch_spmd.py
`run_ranks`) and returns what its test compares, as numpy arrays and
plain values.  This module imports neither jax nor the JAX package: the
ranks are fresh interpreters that need only the port."""

import os

import numpy as np
import torch


def _spec(tensor, mesh):
    """A DTensor's spec: the mesh axis sharding each tensor dimension
    (None where none does); a plain tensor's is all None."""
    from torch.distributed.tensor import DTensor, Shard

    spec = [None] * tensor.ndim
    if isinstance(tensor, DTensor):
        for name, placement in zip(mesh.mesh_dim_names, tensor.placements):
            if isinstance(placement, Shard):
                spec[placement.dim] = name
    return tuple(spec)


def _placements_of(module, mesh):
    return {name: (_spec(param, mesh), tuple(param.to_local().shape))
            for name, param in module.named_parameters()}


# -- tests/test_torch_mesh_sharding.py ---------------------------------------

def placements(rank, world):
    """Whisper-tiny, Llama-tiny and the tiny MoE placed on {data: 2,
    model: 2} (and {data: 2, expert: 2}) by their logical axes, the
    ComputeRuntime's placement on the same mesh, and the mesh helpers."""
    import copy

    from torch.distributed.tensor import DTensor

    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.models.layers import tree_leaves
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.models import moe as TM
    from aiko_services_tpu_torch.models import whisper as TW
    from aiko_services_tpu_torch.parallel import (
        collectives as C, create_mesh, named_sharding, shard_pytree)
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    generator = torch.Generator().manual_seed(0)
    mesh = create_mesh({"data": 2, "model": 2}, device="cpu")
    whisper = TW.whisper_init(generator, TW.WHISPER_PRESETS["tiny"],
                              device="cpu")
    shard_pytree(whisper, TW.whisper_axes(whisper.config), mesh)
    llama_config = TL.LLAMA_PRESETS["tiny"]
    llama = TL.llama_init(generator, llama_config, device="cpu")
    full = {name: p.detach().clone() for name, p in llama.named_parameters()}

    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name=f"rank{rank}", engine=EventEngine(VirtualClock()),
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    compute = ComputeRuntime(runtime, "compute", mesh=mesh)
    # the training placement (DTensors, parallel.shard_pytree) of a copy
    # gives the specs; the runtime's serving placement gives this rank's
    # shards as plain tensors, the DTensors' local tensors
    placed = shard_pytree(copy.deepcopy(llama), TL.llama_axes(llama_config),
                          mesh)
    gathered_equal = all(torch.equal(p.full_tensor(), full[name])
                         for name, p in placed.named_parameters())
    shards = dict(placed.named_parameters())
    local = compute.place_params(llama, TL.llama_axes(llama_config))
    local_equal = all(
        not isinstance(leaf, DTensor) and
        torch.equal(leaf, shards[".".join(map(str, path))].to_local())
        for path, leaf in tree_leaves(local))
    # serving on the mesh: a placement without axes replicates, and the
    # runtime takes programs and runs them
    whole = compute.place_params(llama)
    compute.register_program("f", lambda x: x + 1)
    scheduler = compute.register_batched(
        "g", lambda b, x: x, [8], lambda b, p: p, lambda r, n: r)
    served = [all(torch.equal(p, full[name])
                  for name, p in whole.named_parameters()),
              compute.run("f", 1) == 2,
              compute.programs["g"].scheduler is scheduler]
    share = (compute.ec_producer.get("mesh"),
             compute.ec_producer.get("device_count"), str(compute.device))
    runtime.terminate()

    moe_mesh = create_mesh({"data": 2, "expert": 2}, device="cpu")
    moe_config = TL.LLAMA_PRESETS["tiny_moe"].moe_config()
    moe = TM.MoE(moe_config, device="cpu")
    for module in moe.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    x = torch.randn((2, 8, moe_config.dim), generator=generator)
    expected, _ = TM.moe_forward(moe, moe_config, x)
    shard_pytree(moe, TM.moe_axes(), moe_mesh)
    gathered = {"router": {"w": moe.router.w.full_tensor()},
                "w_in": moe.w_in.full_tensor(),
                "w_out": moe.w_out.full_tensor()}
    got, _ = TM.moe_forward(gathered, moe_config, x)

    x16 = torch.ones((8, 16), dtype=torch.bfloat16)
    return {
        "whisper": _placements_of(whisper, mesh),
        "llama": _placements_of(placed, mesh),
        "llama_gathered_equal": gathered_equal,
        "llama_local_equal": local_equal,
        "moe": _placements_of(moe, moe_mesh),
        "moe_max_err": float((got - expected).abs().max()),
        "served": served,
        "share": share,
        "named": [named_sharding(mesh, *axes).spec for axes in (
            ("batch", "embed"), ("batch", "sequence", "heads"))],
        "fabric": C.mesh_fabric_report(mesh),
        "resharded": _spec(C.reshard(x16, mesh, ("data", "model")), mesh),
        "bytes": [C.collective_bytes(x16, "model", mesh, op)
                  for op in ("all_gather", "reduce_scatter", "psum",
                             "ppermute")],
    }


# -- tests/test_torch_collectives.py ------------------------------------------

def collectives(rank, world, x, y):
    """Each collective over the ranks of a 1-D mesh {"x": world}, and
    over the model axis of {data: 2, model: 2}; rank r holds x[r]."""
    from aiko_services_tpu_torch.parallel import collectives as C
    from aiko_services_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"x": world}, device="cpu")
    local = torch.from_numpy(x[rank])
    kw = {"mesh": mesh}
    out = {
        "psum": C.psum(local, "x", **kw),
        "pmean": C.pmean(local, "x", **kw),
        "pmax": C.pmax(local, "x", **kw),
        "all_gather": C.all_gather(local, "x", **kw),
        "all_gather_axis1": C.all_gather(local, "x", axis=1, **kw),
        "all_gather_stacked": C.all_gather(local, "x", tiled=False, **kw),
        "reduce_scatter": C.reduce_scatter(local, "x", **kw),
        "reduce_scatter_axis1": C.reduce_scatter(local, "x", axis=1, **kw),
        "ring": C.ppermute_ring(local, "x", world, **kw),
        "ring_reverse": C.ppermute_ring(local, "x", world, reverse=True,
                                        **kw),
        "index": torch.tensor(C.axis_index("x", **kw)),
        "size": torch.tensor(C.axis_size("x", **kw)),
    }
    out = {key: value.numpy() for key, value in out.items()}
    grid = create_mesh({"data": 2, "model": 2}, device="cpu")
    local = torch.from_numpy(y[rank])
    out["model_psum"] = C.psum(local, "model", mesh=grid).numpy()
    out["data_ring"] = C.ppermute_ring(local, "data", 2, mesh=grid).numpy()
    return out


# -- tests/test_torch_ring_attention.py ---------------------------------------

def ring(rank, world, cases):
    """ring_attention over {seq: 4} and {data: 2, seq: 2} for each case
    (q, k, v full arrays, causal); every rank returns the gathered
    output."""
    from aiko_services_tpu_torch.parallel import create_mesh, ring_attention

    results = {}
    for axes in ({"seq": 4}, {"data": 2, "seq": 2}):
        mesh = create_mesh(axes, device="cpu")
        for name, (q, k, v, causal) in cases.items():
            out = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 mesh, causal=causal)
            results[(tuple(axes), name)] = out.full_tensor().numpy()
    return results


# -- tests/test_torch_train.py ------------------------------------------------

def _count_all_gathers():
    """Count every all-gather this process makes (torch.distributed's,
    the functional collectives' that DTensor redistributes with, and
    DTensor.full_tensor) until the returned undo is called: (counts,
    undo)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    counts = {"n": 0}
    patched = [(dist, "all_gather"), (dist, "all_gather_into_tensor"),
               (funcol, "all_gather_tensor"),
               (funcol, "all_gather_tensor_autograd"),
               (DTensor, "full_tensor")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in patched
             if hasattr(owner, name)]

    def counting(real):
        def wrapper(*args, **kwargs):
            counts["n"] += 1
            return real(*args, **kwargs)
        return wrapper

    for owner, name, real in saved:
        setattr(owner, name, counting(real))

    def undo():
        for owner, name, real in saved:
            setattr(owner, name, real)
    return counts, undo


def dp_tp_train(rank, world, flat, config_fields, batch, mask, steps,
                directory, loss_inputs):
    """Whisper's AdamW steps on {data: 2, model: 2} from the parameters
    `flat` ('/'-joined paths → arrays), tensor-parallel (the model and
    the loss called with the mesh on the step's local shards), three
    ways: the plain mean loss with a checkpoint saved after step 3; a
    fresh sharded state restored from that checkpoint and run to the
    last step; and the masked loss (cross_entropy_sum) with `mask`.
    Each: losses and the gathered parameters, moments and placements
    after the last step, the shapes of the tree loss_fn was handed, and
    the all-gathers the steps made.  Then the vocab-parallel loss of
    `loss_inputs` (logits [B, S, V] with an odd V, targets, mask): each
    rank's chunk of the logits, padded with -inf as the model's forward
    pads it, through cross_entropy_loss and cross_entropy_sum with the
    mesh."""
    import numpy as np

    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import whisper as TW
    from aiko_services_tpu_torch.parallel import (
        TrainState, checkpoint, create_mesh, train)
    from aiko_services_tpu_torch.parallel.sharding import padded_chunk

    config = TW.WhisperConfig(**config_fields)
    mesh = create_mesh({"data": 2, "model": 2}, device="cpu")
    seen = {}

    def fresh():
        model = bridge.params_from_numpy(flat, config, device="cpu")
        return train.init_train_state(model, train.adamw(1e-2), mesh,
                                      TW.whisper_axes(config))

    def record(params):
        seen.setdefault("q_w", tuple(
            params["enc_blocks"][0]["attn"]["q"]["w"].shape))
        seen.setdefault("mlp_in_w", tuple(
            params["dec_blocks"][0]["mlp_in"]["w"].shape))
        seen.setdefault("table", tuple(params["tok_embed"]["table"].shape))

    def loss_fn(params, batch):
        record(params)
        logits = TW.forward(params, config, batch["mel"], batch["tokens"],
                            mesh=mesh)
        seen.setdefault("logits", tuple(logits.shape))
        return train.cross_entropy_loss(logits, batch["targets"],
                                        mesh=mesh)

    def masked_loss_fn(params, batch):
        logits = TW.forward(params, config, batch["mel"], batch["tokens"],
                            mesh=mesh)
        return train.cross_entropy_sum(logits, batch["targets"],
                                       batch["mask"], mesh=mesh)

    def run(state, step, batch, first, last, save_at=None):
        losses = []
        for index in range(first, last):
            if index == save_at:
                saved.append(checkpoint.save_checkpoint(directory, {
                    "params": state.params, "opt_state": state.opt_state,
                    "step": int(state.step)}, step=int(state.step)))
            state, loss = step(state, batch)
            losses.append(float(loss))
        opt = state.opt_state
        q_w = state.params.enc_blocks[0].attn.q.w
        return {"losses": losses, "step": state.step,
                "params": {name: p.full_tensor().detach().numpy()
                           for name, p in state.params.named_parameters()},
                "moments": {name: opt.state[p]["exp_avg"].full_tensor().
                            numpy()
                            for name, p in state.params.named_parameters()},
                "q_spec": _spec(q_w, mesh),
                "q_local": tuple(q_w.to_local().shape)}

    # count the writes this rank makes: only global rank 0 may write
    writes = []
    savez = np.savez
    np.savez = lambda *args, **kw: (writes.append(rank), savez(*args, **kw))
    saved = []
    batch = {key: torch.from_numpy(value) for key, value in batch.items()}
    step = train.make_train_step(loss_fn, mesh=mesh)
    state = fresh()
    gathers, undo = _count_all_gathers()
    try:
        state, _ = step(state, batch)
    finally:
        undo()
    out = {"gathers": gathers["n"], "seen": dict(seen),
           "plain": run(fresh(), step, batch, 0, steps, save_at=3)}
    template = fresh()
    loaded = checkpoint.restore_checkpoint(saved[0], {
        "params": template.params, "opt_state": template.opt_state,
        "step": 0})
    out["resumed"] = run(TrainState(loaded["params"], loaded["opt_state"],
                                    loaded["step"]), step, batch, 3, steps)
    out["resumed"]["restored_step"] = loaded["step"]
    masked = dict(batch, mask=torch.from_numpy(mask))
    out["masked"] = run(fresh(), train.make_train_step(masked_loss_fn,
                                                       mesh=mesh),
                        masked, 0, steps)
    out["writes"] = len(writes)
    logits, targets, loss_mask = (torch.from_numpy(x) for x in loss_inputs)
    vocab = logits.shape[-1]
    chunk = padded_chunk(vocab, 2)
    index = mesh.get_local_rank("model")
    mine = logits[..., index * chunk:(index + 1) * chunk]
    mine = torch.cat([mine, torch.full(
        (*mine.shape[:-1], chunk - mine.shape[-1]), float("-inf"))], -1)
    total, count = train.cross_entropy_sum(mine, targets, loss_mask,
                                           mesh=mesh)
    out["vocab_parallel"] = {
        "chunk": tuple(mine.shape),
        "mean": float(train.cross_entropy_loss(mine, targets, mesh=mesh)),
        "masked": float(train.cross_entropy_loss(mine, targets, loss_mask,
                                                 mesh=mesh)),
        "sum": (float(total), float(count))}
    return out


# -- tests/test_torch_pipeline_parallel.py ------------------------------------

def gpipe(rank, world, weights, microbatches):
    """gpipe_spmd over {stage: world}: stage s applies tanh(x @ w[s]);
    the stacked weights are passed full and as DTensors sharded over the
    stage axis."""
    from aiko_services_tpu_torch.parallel import create_mesh, gpipe_spmd
    from aiko_services_tpu_torch.parallel.collectives import reshard

    mesh = create_mesh({"stage": world}, device="cpu")

    def stage_fn(params, x):
        return torch.tanh(x @ params["w"])

    step = gpipe_spmd(stage_fn, mesh, microbatches.shape[0])
    w = torch.from_numpy(weights)
    x = torch.from_numpy(microbatches)
    full = step({"w": w}, x)
    sharded = step({"w": reshard(w, mesh, ("stage",))}, x)
    return full.numpy(), sharded.numpy()


# -- tests/test_torch_llama_sp.py ---------------------------------------------

def llama_sp(rank, world, flat, config_fields, tokens):
    """llama_forward_sp over {seq: 4} and {data: 2, seq: 2}: the gathered
    logits on every rank."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import create_mesh

    config = TL.LlamaConfig(**config_fields)
    model = bridge.params_from_numpy(flat, config, device="cpu")
    tokens = torch.from_numpy(tokens)
    out = {}
    with torch.no_grad():
        for axes in ({"seq": 4}, {"data": 2, "seq": 2}):
            mesh = create_mesh(axes, device="cpu")
            logits = TL.llama_forward_sp(model, config, tokens, mesh)
            out[tuple(axes)] = logits.full_tensor().numpy()
    return out


# -- tests/test_torch_tp_serving.py, tests/test_torch_ep_serving.py -----------

def _serve(decoder, prompts, max_new):
    """Submit every prompt in order and pump to completion: {id: tokens}."""
    done = {}
    for request_id, prompt in prompts.items():
        decoder.submit(request_id, prompt, max_new,
                       lambda rid, tokens: done.update(
                           {rid: [int(t) for t in tokens]}))
    for _ in range(400):
        if len(done) == len(prompts):
            break
        decoder.pump()
    return done


def _serve_staggered(decoder, prompts, max_new, rank):
    """Submit the prompts at rank-dependent rounds and in a rank-dependent
    order (even ranks in order, odd ranks reversed; the k-th joins
    before this rank's local pump 2k + 3 * rank), as ranks pumped from
    their own timers see their frames, and pump to completion."""
    order = list(prompts) if rank % 2 == 0 else list(reversed(prompts))
    due = {2 * k + 3 * rank: request_id
           for k, request_id in enumerate(order)}
    done = {}
    for pump in range(600):
        if pump in due:
            decoder.submit(due[pump], prompts[due[pump]], max_new,
                           lambda rid, tokens: done.update(
                               {rid: [int(t) for t in tokens]}))
        if len(done) == len(prompts):
            break
        decoder.pump()
    return done


SHIPPED_PROMPT = [(7 * i) % 200 + 3 for i in range(21)]


def _shipped_serving(full, params, config, mesh, max_new):
    """submit(kv_blocks=...) on a paged decoder over `mesh`: an unsharded
    decoder with a prefix cache computes SHIPPED_PROMPT's blocks, whose
    rows (every KV head) every rank hands to install_shipped_blocks; the
    request then admits on the installed blocks (this rank's heads of
    them) and only the suffix prefills.  Returns the tokens, the same
    prompt's tokens served cold on another decoder over the mesh, the
    request's prefix hit, the plans, and whether each installed block's
    rows are byte-equal to this rank's head slice of the shipped rows."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_disagg import (_chain_wire_blocks,
                                                        _landing)

    base = {"max_slots": 2, "prefill_buckets": (32,), "paged_kv": True,
            "kv_block": 8}
    cache = PrefixKVCache(block_tokens=8, registry=MetricsRegistry())
    donor = ContinuousDecoder(full, config, device="cpu",
                              prefix_cache=cache,
                              registry=MetricsRegistry(), **base)
    _serve(donor, {"donor": SHIPPED_PROMPT}, 1)
    keys = cache.keys_for("", SHIPPED_PROMPT[:16])
    rows = _chain_wire_blocks(cache, keys).blocks
    blocks = _landing([[{"k": layer["k"].numpy(), "v": layer["v"].numpy()}
                        for layer in block] for block in rows])
    decoder = ContinuousDecoder(params, config, mesh=mesh,
                                registry=MetricsRegistry(), **base)
    decoder.plan_digests = []
    covered, ids = decoder.install_shipped_blocks(SHIPPED_PROMPT, 0, blocks)
    first, stop, _ = decoder.kv_heads
    pool = decoder.pool
    equal = all(
        pool.k_pools[layer][block_id].numpy().tobytes() ==
        blocks[j]["k"][layer][first:stop].tobytes() and
        pool.v_pools[layer][block_id].numpy().tobytes() ==
        blocks[j]["v"][layer][first:stop].tobytes()
        for j, block_id in enumerate(ids)
        for layer in range(config.num_layers))
    done = {}
    decoder.submit("shipped", SHIPPED_PROMPT, max_new,
                   lambda rid, tokens: done.update(
                       {rid: [int(t) for t in tokens]}),
                   kv_blocks=(covered, ids))
    hit = decoder._arrivals[0].prefix_hit
    _pump_until(decoder, done, 1)
    cold = ContinuousDecoder(params, config, mesh=mesh,
                             registry=MetricsRegistry(), **base)
    return {"tokens": done.get("shipped"),
            "cold": _serve(cold, {"cold": SHIPPED_PROMPT},
                           max_new)["cold"],
            "hit": hit, "covered": covered, "plans": decoder.plan_digests,
            "rows_equal": equal, "heads": (first, stop),
            "pool_used": pool.used_blocks()}


def _refusals(decoder, params, config, mesh):
    """What a decoder on a mesh of more than one rank refuses: each
    entry the ValueError's message, or None where nothing was raised
    (drain, a deadline, a host tier and watch_decoder are agreed in the
    round note and raise nothing; the drain and the submissions are
    queued on the note and never pumped here)."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.ops.admission import AdmissionGate
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_tiered import HostBlockStore

    def message(call):
        try:
            call()
        except ValueError as exc:
            return str(exc)
        return None

    cache = PrefixKVCache(block_tokens=8, max_bytes=1 << 20,
                          registry=MetricsRegistry())
    ContinuousDecoder(params, config, mesh=mesh, max_slots=2,
                      prefill_buckets=(16,), prefill_chunk=8, paged_kv=True,
                      kv_block=8, prefix_cache=cache,
                      registry=MetricsRegistry())
    decoder.submit("twice", [1, 2], 2, lambda *_: None)
    return {
        "drain": message(decoder.drain),
        "deadline": message(lambda: decoder.submit(
            "late", [1], 2, lambda *_: None, deadline=1e9)),
        "duplicate": message(lambda: decoder.submit(
            "twice", [1, 2], 2, lambda *_: None)),
        "host_tier": message(lambda: cache.attach_host_store(
            HostBlockStore(max_bytes=1 << 20))),
        "watch_decoder": message(lambda: AdmissionGate(
            registry=MetricsRegistry()).watch_decoder(decoder)),
    }


def sharded_serving(rank, world, mesh_axes, flat, config_fields, variants,
                    prompts, max_new):
    """Each variant's ContinuousDecoder (kwargs in `variants`) on this
    rank's shards of the JAX tree `flat` over create_mesh(mesh_axes):
    tokens, every round's plan digest, the MoE's dropped assignments,
    the KV bytes and the rank-local widths; then the same with the
    prompts submitted at other rounds on each rank (_serve_staggered),
    and what a sharded decoder refuses."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.models import moe as TM
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = TL.LlamaConfig(**config_fields)
    mesh = create_mesh(mesh_axes, device="cpu")
    full = bridge.params_from_numpy(flat, config, device="cpu")
    params, local = local_shards(full, TL.llama_axes(config), mesh,
                                 config=config)
    out = {"local": (local.num_heads, local.num_kv_heads, local.ffn_dim,
                     local.vocab, local.num_experts, local.head_dim),
           "moe_w_in": tuple(params["layers"][0]["moe"]["w_in"].shape)
           if config.num_experts else None}
    for name, kwargs in variants.items():
        TM.drop_counts = []
        try:
            decoder = ContinuousDecoder(params, config, mesh=mesh,
                                        registry=MetricsRegistry(),
                                        **kwargs)
            decoder.plan_digests = []
            tokens = _serve(decoder, prompts, max_new)
            drops = [int(count) for count in TM.drop_counts]
        finally:
            TM.drop_counts = None
        out[name] = {"tokens": tokens, "plans": decoder.plan_digests,
                     "drops": drops, "kv_bytes": decoder.kv_cache_bytes(),
                     "config": (decoder.config.num_heads,
                                decoder.config.num_kv_heads)}
        decoder = ContinuousDecoder(params, config, mesh=mesh,
                                    registry=MetricsRegistry(), **kwargs)
        decoder.plan_digests = []
        out[name]["staggered"] = {
            "tokens": _serve_staggered(decoder, prompts, max_new, rank),
            "plans": decoder.plan_digests}
    if mesh.size() > 1 and not config.num_experts:
        out["refusals"] = _refusals(decoder, params, config, mesh)
        out["shipped"] = _shipped_serving(full, params, config, mesh,
                                          max_new)
    return out


def sharded_greedy(rank, world, mesh_axes, flat, config_fields, prompt,
                   max_tokens):
    """llama_greedy_decode and llama_forward on this rank's shards: the
    tokens and the gathered logits, the same on every rank; and the
    sharded pick's tie rule on logits with the maximum on every rank."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import collectives as C
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards

    config = TL.LlamaConfig(**config_fields)
    mesh = create_mesh(mesh_axes, device="cpu")
    full = bridge.params_from_numpy(flat, config, device="cpu")
    params, local = local_shards(full, TL.llama_axes(config), mesh,
                                 config=config)
    prompt = torch.from_numpy(prompt)
    tokens = TL.llama_greedy_decode(params, local, prompt,
                                    max_tokens=max_tokens, mesh=mesh)
    with torch.no_grad():
        logits = TL.llama_forward(params, local, prompt, mesh=mesh)
    # every rank's shard holds its maximum 7.0 at local index 1, and rank
    # 1's shard at 0 as well: the pick is rank 0's index 1
    shard = torch.zeros((2, 8))
    shard[:, 1] = 7.0
    if C.axis_index("model", mesh=mesh) == 1:
        shard[:, 0] = 7.0
    ties = C.greedy_pick(shard, "model", mesh=mesh)
    return {"tokens": tokens.numpy(), "logits": logits.numpy(),
            "ties": ties.numpy()}


def tp_case(rank, world, geometries, flat, config_fields, variants,
            prompts, max_new, greedy_prompt):
    """sharded_serving and sharded_greedy on each mesh of `geometries`
    (name → axes, each filling the group), in one spawn."""
    out = {}
    for name, mesh_axes in geometries.items():
        out[name] = sharded_serving(rank, world, mesh_axes, flat,
                                    config_fields, variants, prompts,
                                    max_new)
        out[name]["greedy"] = sharded_greedy(rank, world, mesh_axes, flat,
                                             config_fields, greedy_prompt,
                                             max_new)
    return out


# -- tests/test_torch_parallel_example.py --------------------------------------

def parallel_example(rank, world, definition, whisper_npz, agent_flat,
                     agent_fields, stream_parameters):
    """examples/speech/pipeline_assistant_parallel.json (a copy naming
    the ASR weights) built as `pipeline create --mesh expert=4 --device
    cpu` builds it (cli.build_pipeline), the agent's llama_init returning
    the JAX tree `agent_flat`, the ASR switched to f32 after its setup;
    driven on a virtual clock to one completed frame.  Returns the
    frame's ASR and agent outputs, the agent's MoE leaf shapes and what
    its setup refuses on the mesh."""
    import dataclasses
    import json

    from aiko_services_tpu_torch import bridge, cli
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.models import llama as TL

    def seeded(generator, config, device=None):
        return bridge.params_from_numpy(agent_flat, config, device=device)

    TL.llama_init = seeded
    engine = EventEngine(VirtualClock())
    runtime, pipeline = cli.build_pipeline(
        definition, stream_id="s0",
        stream_parameters=json.dumps(stream_parameters), device="cpu",
        engine=engine, mesh_spec="expert=4")
    done = []
    pipeline.add_frame_handler(done.append)
    asr = pipeline.graph.node("PE_WhisperASR").element
    asr.config = dataclasses.replace(asr.config, dtype=torch.float32)
    asr.params = bridge.load_flat_npz(asr.params.float(), whisper_npz)
    asr._stage_params = tuple({key: asr.params[key] for key in stage}
                              for stage in asr._stage_params)
    for _ in range(3000):
        if done:
            break
        engine.clock.advance(0.01)
        engine.step()
    agent = pipeline.graph.node("PE_LlamaAgent").element
    layer = agent.decoder.params["layers"][0]["moe"]
    swag = done[0].swag if done else {}
    out = {"frames": len(done),
           "text": swag.get("text"),
           "tokens": np.asarray(swag.get("tokens")).tolist(),
           "response": swag.get("response"),
           "response_tokens": np.asarray(
               swag.get("response_tokens")).tolist(),
           "w_in": tuple(layer["w_in"].shape),
           "router": tuple(layer["router"]["w"].shape),
           "mesh": runtime.service_by_name("compute").ec_producer.get(
               "mesh")}
    # what the agent refuses on four ranks (nothing): set up again with
    # each option, and serve the frame's text in batched mode and with
    # disagg (no prefill pool: rank 0's client decides local_no_pool)
    refused = {}
    # the batched mode pads each prompt to prompt_length: 16, within
    # tiny_moe's positions with the answer's
    agent.definition.parameters["prompt_length"] = 16
    for name, value in (("sessions", True), ("mode", "batched"),
                        ("disagg", True)):
        agent.definition.parameters[name] = value
        if name == "disagg":
            # the shipped KV lands in the paged pool (no prefix cache)
            agent.definition.parameters["paged"] = True
        agent._setup_done = False
        try:
            agent._setup()
        except ValueError as exc:
            refused[name] = str(exc)
        if name == "mode" and not refused:
            out["batched"] = _served_batched(agent, engine, swag)
        if name == "disagg" and not refused:
            out["disagg"] = _served_disagg(agent, swag)
        agent.definition.parameters.pop(name)
    agent.mode, agent._setup_done = "continuous", True
    out["refused"] = refused
    runtime.terminate()
    return out


def _served_batched(agent, engine, swag) -> dict:
    """The frame's text through the agent's batched program (the cut
    agreed over the mesh), against llama_greedy_decode on the whole
    model in this process."""
    from aiko_services_tpu_torch.models import llama as TL
    config = TL.LLAMA_PRESETS[str(agent.get_parameter("preset")[0])]
    prompt = agent._pad_prompt(swag.get("text", ""))
    box = {}
    agent.compute.submit(agent._program, "s0", prompt, len(prompt),
                         lambda _sid, result: box.setdefault("r", result))
    for _ in range(2000):
        if "r" in box:
            break
        engine.clock.advance(0.01)
        engine.step()
    whole = TL.llama_init(None, config, device="cpu")
    unsharded = TL.llama_greedy_decode(
        whole, config, torch.from_numpy(prompt[None]),
        max_tokens=agent.max_tokens)
    return {"tokens": box.get("r"), "unsharded": unsharded[0].tolist(),
            "agreed": agent.compute.programs[agent._program]
            .scheduler.agreed}


def _served_disagg(agent, swag) -> dict:
    """The frame's text through the agent's PrefillClient on its new
    (paged) decoder over the mesh: with no prefill pool every rank
    prefills it locally (a prompt under a block on every rank at once,
    a longer one at the round note that applies rank 0's decision);
    then the same text submitted to that decoder directly."""
    done = {}
    tokens = agent.tokenizer(swag.get("text", "")) or [1]
    client = agent._prefill_client
    client.submit("disagg", tokens, agent.max_tokens,
                  lambda rid, generated: done.update(
                      {rid: [int(t) for t in generated]}))
    _pump_until(agent.decoder, done, 1)
    agent.decoder.submit("direct", tokens, agent.max_tokens,
                         lambda rid, generated: done.update(
                             {rid: [int(t) for t in generated]}))
    _pump_until(agent.decoder, done, 2)
    return {"tokens": done.get("disagg"), "direct": done.get("direct"),
            "local": (client.stats["local_short"],
                      client.stats["local_no_pool"]),
            "transfers": client.stats["transfers"]}


# -- tests/test_torch_tp_serving_ops.py ---------------------------------------

class _SkewedTime:
    """The time module with monotonic() offset by `offset` seconds: a
    rank whose clock runs apart from the others'."""

    def __init__(self, offset: float):
        self.offset = float(offset)

    def monotonic(self) -> float:
        import time
        return time.monotonic() + self.offset

    def __getattr__(self, name):
        import time
        return getattr(time, name)


def _skewed(rank: int, staggered: bool):
    """Patch the serving modules' clock by a per-rank offset when
    staggered (undone by the returned function)."""
    import time

    from aiko_services_tpu_torch import serving as TS
    if staggered:
        TS.time = _SkewedTime(1000.0 * rank + 7.25 * rank * rank)
    return lambda: setattr(TS, "time", time)


def _descriptor(entry: dict) -> tuple:
    return (entry["request_id"], list(entry["prompt"]),
            list(entry["generated"]), int(entry["max_new_tokens"]),
            entry["deadline"], entry["tenant"])


def _pump_until(decoder, done, count, rounds=400):
    for _ in range(rounds):
        if len(done) >= count:
            return
        decoder.pump()


def _submit_phase(decoder, requests, done, rank, staggered, refused=None,
                  deadlines=None):
    """Submit `requests` ({id: (prompt, max_new)}) and pump until they
    are answered (tokens or a refusal): at once, or when staggered at
    this rank's own pumps (the k-th before local pump 2k + 3 * rank, odd
    ranks in reverse order).  `deadlines` maps ids to seconds from this
    rank's now."""
    import time as clock

    from aiko_services_tpu_torch import serving as TS
    refused = {} if refused is None else refused
    deadlines = deadlines or {}
    order = list(requests)
    if staggered and rank % 2:
        order.reverse()
    due = {(2 * k + 3 * rank) if staggered else 0: [rid]
           for k, rid in enumerate(order)} if staggered else {0: order}

    def keep(rid, tokens):
        done[rid] = [int(t) for t in tokens]

    for pump in range(600):
        for rid in due.get(pump, ()):
            prompt, max_new = requests[rid]
            deadline = None if rid not in deadlines else \
                getattr(TS, "time", clock).monotonic() + deadlines[rid]
            decoder.submit(rid, prompt, max_new, keep, deadline=deadline,
                           on_refused=lambda r, why: refused.update(
                               {r: why}))
        if pump >= max(due) and all(rid in done or rid in refused
                                    for rid in requests):
            return
        decoder.pump()
    raise AssertionError(f"unanswered: {set(requests) - set(done)}")


def tp_ops_weight_quant(rank, params, config, mesh, base, prompts, max_new,
                        staggered):
    """weight_quant on the mesh: tokens, plans, and layer 0's quantized
    o, down and q as this rank holds them."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    decoder = ContinuousDecoder(params, config, mesh=mesh,
                                weight_quant=True,
                                registry=MetricsRegistry(), **base)
    decoder.plan_digests = []
    done = {}
    _submit_phase(decoder, {rid: (prompt, max_new)
                            for rid, prompt in prompts.items()}, done, rank,
                  staggered)
    layer = decoder.params["layers"][0]
    leaves = {name: {key: leaf[key].numpy() for key in ("w8", "s")}
              for name, leaf in (("o", layer["attn"]["o"]),
                                 ("q", layer["attn"]["q"]),
                                 ("down", layer["down"]))}
    return {"tokens": done, "plans": decoder.plan_digests,
            "leaves": leaves}


def tp_ops_drain(rank, params, config, mesh, base, prompts, max_new,
                 staggered, deadline):
    """Four requests on two slots, a drain after this rank's second
    round (its fourth when staggered) with `deadline`, pumped until
    drained; then resume and one more request."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    decoder = ContinuousDecoder(params, config, mesh=mesh,
                                registry=MetricsRegistry(), **base)
    decoder.plan_digests = []
    done, checkpointed = {}, []
    requests = {rid: (prompt, max_new) for rid, prompt in prompts.items()}

    def keep(rid, tokens):
        done[rid] = [int(t) for t in tokens]

    order = list(requests)
    if staggered and rank % 2:
        order.reverse()
    # idle pumps: nothing to agree, so no note
    for _ in range(3 * rank if staggered else 0):
        decoder.pump()
    for rid in order:
        decoder.submit(rid, *requests[rid], keep)
        if staggered:
            decoder.pump()
    for _ in range(2 + (2 * rank if staggered else 0)):
        decoder.pump()
    evacuated = decoder.drain(deadline=deadline,
                              on_evacuate=checkpointed.append)
    for _ in range(200):
        if decoder.drained:
            break
        decoder.pump()
    drained = decoder.drained
    decoder.resume()
    first = next(iter(prompts))
    _submit_phase(decoder, {"after": (prompts[first], max_new)}, done, rank,
                  staggered)
    return {"tokens": done, "plans": decoder.plan_digests,
            "evacuated": [_descriptor(e) for e in evacuated],
            "checkpointed": [_descriptor(e) for e in checkpointed],
            "stats": {key: decoder.stats[key] for key in (
                "drain_evacuated", "drain_checkpoints", "drain_refused",
                "completed")},
            "drained": drained, "draining": decoder.draining}


def tp_ops_deadlines(rank, params, config, mesh, base, prompts, max_new,
                     staggered):
    """A warm request, then decisive deadlines (seconds from each rank's
    own now: -1 passed, 1e9 not): half through an AdmissionGate watching
    the decoder, half straight to submit.  The shed set, the tokens and
    the gate's estimate after the drive."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.ops.admission import AdmissionGate
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    decoder = ContinuousDecoder(params, config, mesh=mesh,
                                registry=MetricsRegistry(), **base)
    decoder.plan_digests = []
    gate = AdmissionGate(registry=MetricsRegistry())
    gate.watch_decoder(decoder)
    done, refused = {}, {}
    first = next(iter(prompts))
    _submit_phase(decoder, {"warm": (prompts[first], max_new)}, done, rank,
                  staggered)
    remaining = {f"{rid}_late": -1.0 for rid in prompts} | \
        {f"{rid}_ok": 1e9 for rid in prompts}
    gated = sorted(remaining)[::2]
    gate_shed = sorted(rid for rid in gated
                       if gate.shed_early(remaining[rid])[0])
    requests = {rid: (prompts[rid.rsplit("_", 1)[0]], max_new)
                for rid in remaining if rid not in gate_shed}
    _submit_phase(decoder, requests, done, rank, staggered, refused,
                  deadlines=remaining)
    return {"tokens": done, "plans": decoder.plan_digests,
            "shed": sorted(gate_shed + [rid for rid, why in refused.items()
                                        if why == "shed"]),
            "refused": refused, "gate_wait": gate.estimated_wait(),
            "stats": {key: decoder.stats[key] for key in (
                "admission_shed", "completed")}}


def tp_ops_tier(rank, params, config, mesh, base, prompt, other, max_new,
                staggered):
    """The host tier under LRU pressure: one conversation, a device
    budget of three blocks that demotes its chain as another request's
    harvest lands, then the conversation again (promoted).  Budgets in
    this rank's blocks."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_tiered import HostBlockStore

    registry = MetricsRegistry()
    cache = PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                          registry=registry, name=f"tier{rank}")
    store = HostBlockStore(max_bytes=64 << 20, name=f"tier{rank}h",
                           registry=registry)
    cache.attach_host_store(store)
    decoder = ContinuousDecoder(params, config, mesh=mesh, paged_kv=True,
                                kv_block=8, prefix_cache=cache,
                                registry=registry, **base)
    decoder.plan_digests = []
    done = {}
    _submit_phase(decoder, {"a": (prompt, max_new)}, done, rank, staggered)
    cache.max_bytes = 3 * decoder.pool.block_nbytes
    _submit_phase(decoder, {"c": (other, max_new)}, done, rank, staggered)
    cache.max_bytes = 64 << 20
    _submit_phase(decoder, {"a2": (prompt, max_new)}, done, rank, staggered)
    node = next(iter(store._nodes.values()), None)
    return {"tokens": done, "plans": decoder.plan_digests,
            "cache": {key: cache.stats[key] for key in (
                "demoted", "promoted", "evictions", "hit_tokens")},
            "store": {key: store.stats[key] for key in (
                "demoted", "promoted", "evicted", "refused")},
            "host_heads": None if node is None else
            tuple(next(iter(node.k_host.values())).shape)}


def tp_ops(rank, world, geometries, flat, config_fields, base, prompts,
           max_new, tier):
    """Every scenario of tests/test_torch_tp_serving_ops.py on each mesh
    of `geometries` (name → axes filling the group), each driven in
    lockstep and staggered (requests at other rounds on each rank, each
    rank's clock skewed)."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards

    config = TL.LlamaConfig(**config_fields)
    full = bridge.params_from_numpy(flat, config, device="cpu")
    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        params, _ = local_shards(full, TL.llama_axes(config), mesh,
                                 config=config)
        results = {"model_rank": mesh.get_local_rank("model")}
        for staggered in (False, True):
            undo = _skewed(rank, staggered)
            try:
                args = (rank, params, config, mesh, base, prompts, max_new,
                        staggered)
                results[("weight_quant", staggered)] = \
                    tp_ops_weight_quant(*args)
                for deadline in (0.0, None):
                    results[("drain", deadline, staggered)] = \
                        tp_ops_drain(*args, deadline)
                results[("deadlines", staggered)] = tp_ops_deadlines(*args)
                results[("tier", staggered)] = tp_ops_tier(
                    rank, params, config, mesh, tier["base"],
                    tier["prompt"], tier["other"], tier["max_new"],
                    staggered)
            finally:
                undo()
        out[name] = results
    return out


# -- tests/test_torch_tp_agent_sessions.py -----------------------------------

def _agent_definition(module, parameters):
    return module.parse_pipeline_definition({
        "version": 0, "name": "p_agent", "runtime": "jax",
        "graph": ["(PE_LlamaAgent)"],
        "parameters": {f"PE_LlamaAgent.{key}": value for key, value in {
            "preset": "tiny", "max_tokens": 6, "prompt_length": 16,
            **parameters}.items()},
        "elements": [{
            "name": "PE_LlamaAgent", "input": [{"name": "text"}],
            "output": [{"name": "response"},
                       {"name": "response_tokens"}],
            "parameters": {}}]})


def _await_staging(agent, timeout: float = 30.0) -> None:
    """Wait until the host tier's promoter has staged every job it was
    kicked for, so that which round a promotion lands in (the first
    note after every rank staged it) does not hang on thread timing."""
    import time

    cache = agent.prefix_cache
    if cache is None or not cache.tiered:
        return
    deadline = time.monotonic() + timeout
    for job in list(cache.promoter._jobs.values()):
        job.done.wait(max(0.0, deadline - time.monotonic()))


def _agent_run(rank, mesh_axes, parameters, texts, staggered, settle):
    """One agent pipeline on this rank's ComputeRuntime over the mesh:
    every stream's turns one after another (staggered: each next turn
    posted 3 * rank engine steps late, the engine clock and the serving
    clock offset per rank); then the clock settled `settle` s, in which
    the idle decoder's round notes apply rank 0's lease expiries, and
    one more stream's frame."""
    from aiko_services_tpu_torch import pipeline as TP
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import (EventEngine, VirtualClock,
                                               settle_virtual)
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    undo = _skewed(rank, staggered)
    engine = EventEngine(VirtualClock(250.0 * rank if staggered else 0.0))
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name=f"agent{rank}", engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    ComputeRuntime(runtime, "compute",
                   mesh=create_mesh(mesh_axes, device="cpu"))
    pipeline = TP.Pipeline(runtime, _agent_definition(TP, parameters),
                           stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream_id in list(texts) + ["s9"]:
        pipeline.create_stream(stream_id, lease_time=0)
    agent = next(node.element for node in pipeline.graph.nodes()
                 if node.name == "PE_LlamaAgent")
    agent.decoder.plan_digests = []
    lag = 3 * rank if staggered else 0
    turn_of = {stream_id: 0 for stream_id in texts}
    posts = [(lag, stream_id, turns[0]) for stream_id, turns in
             texts.items()]
    responses, seen = {}, 0
    total = sum(len(turns) for turns in texts.values())
    try:
        for step in range(20000):
            for frame in done[seen:]:
                stream_id = frame.stream_id
                responses[(stream_id, turn_of[stream_id])] = [
                    int(t) for t in frame.swag["response_tokens"]]
                turn_of[stream_id] += 1
                if turn_of[stream_id] < len(texts[stream_id]):
                    posts.append((step + lag, stream_id,
                                  texts[stream_id][turn_of[stream_id]]))
            seen = len(done)
            for due, stream_id, text in [p for p in posts if p[0] <= step]:
                pipeline.post("process_frame", stream_id, {"text": text})
            posts = [p for p in posts if p[0] > step]
            if len(responses) == total:
                break
            engine.clock.advance(0.002)
            _await_staging(agent)
            engine.step()
        settle_virtual(engine, settle)
        sessions_settled = len(agent._session_table)
        pipeline.post("process_frame", "s9", {"text": "one more"})
        for _ in range(20000):
            if len(done) > seen:
                break
            engine.clock.advance(0.002)
            _await_staging(agent)
            engine.step()
        responses[("s9", 0)] = [int(t) for t in
                                done[-1].swag["response_tokens"]]
        cache = agent.prefix_cache
        out = {"responses": responses,
               "plans": agent.decoder.plan_digests,
               "cache": {key: cache.stats[key] for key in (
                   "demoted", "promoted", "hit_tokens", "session_handles",
                   "session_released")},
               "sessions": (sessions_settled, len(agent._session_table)),
               "host_max": cache.host_store.max_bytes,
               "cache_max": cache.max_bytes}
    finally:
        runtime.terminate()
        undo()
    return out


def agent_sessions(rank, world, mesh_axes, agent_flat, parameters, texts,
                   settle):
    """PE_LlamaAgent with sessions and a host tier on this rank of
    `mesh_axes`, its llama_init returning the JAX tree `agent_flat`:
    the conversation in lockstep, then staggered with skewed clocks."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL

    def seeded(generator, config, device=None):
        return bridge.params_from_numpy(agent_flat, config, device=device)

    TL.llama_init = seeded
    return {staggered: _agent_run(rank, mesh_axes, parameters, texts,
                                  staggered, settle)
            for staggered in (False, True)}


# -- tests/test_torch_tp_agent_batched.py, test_torch_tp_agent_disagg.py ------

def _agent_pipeline(rank, mesh, parameters, streams, staggered):
    """A one-element PE_LlamaAgent pipeline on this rank's ComputeRuntime
    over `mesh`, its engine clock offset by 250 s a rank when staggered:
    (runtime, engine, pipeline, agent, the completed frames)."""
    from aiko_services_tpu_torch import pipeline as TP
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    engine = EventEngine(VirtualClock(250.0 * rank if staggered else 0.0))
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name=f"agent{rank}", engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    ComputeRuntime(runtime, "compute", mesh=mesh)
    pipeline = TP.Pipeline(runtime, _agent_definition(TP, parameters),
                           stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for stream_id in streams:
        pipeline.create_stream(stream_id, lease_time=0)
    agent = next(node.element for node in pipeline.graph.nodes()
                 if node.name == "PE_LlamaAgent")
    return runtime, engine, pipeline, agent, done


def _agent_turns(engine, pipeline, done, texts, lag, before_step=None):
    """Every stream's turns one after another, each next turn posted
    `lag` engine steps after the stream's previous turn came back:
    {(stream, turn): response tokens}."""
    turn_of = {stream_id: 0 for stream_id in texts}
    posts = [(lag, stream_id, turns[0]) for stream_id, turns in
             texts.items()]
    responses, seen = {}, 0
    total = sum(len(turns) for turns in texts.values())
    for step in range(20000):
        for frame in done[seen:]:
            stream_id = frame.stream_id
            responses[(stream_id, turn_of[stream_id])] = [
                int(t) for t in frame.swag["response_tokens"]]
            turn_of[stream_id] += 1
            if turn_of[stream_id] < len(texts[stream_id]):
                posts.append((step + lag, stream_id,
                              texts[stream_id][turn_of[stream_id]]))
        seen = len(done)
        for _, stream_id, text in [p for p in posts if p[0] <= step]:
            pipeline.post("process_frame", stream_id, {"text": text})
        posts = [p for p in posts if p[0] > step]
        if len(responses) == total:
            return responses
        engine.clock.advance(0.002)
        if before_step is not None:
            before_step()
        engine.step()
    raise AssertionError(f"{len(responses)} of {total} turns answered")


def agent_batched(rank, world, geometries, agent_flat, config_fields,
                  parameters, texts):
    """PE_LlamaAgent in batched mode on each mesh of `geometries` (name →
    axes filling the group), its preset the config `config_fields` and
    its llama_init the JAX tree `agent_flat`: the conversation in
    lockstep, then staggered (each next turn posted 3 * rank engine
    steps late, the engine clock offset per rank), then in sync mode in
    lockstep (each frame's item run at once by the forced drain).
    Returns each drive's responses and the batches the rank ran, in
    order (each the items' (stream, sequence) keys)."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import create_mesh

    config = TL.LlamaConfig(**config_fields)
    TL.LLAMA_PRESETS["tiny"] = config

    def seeded(generator, config, device=None):
        return bridge.params_from_numpy(agent_flat, config, device=device)

    TL.llama_init = seeded
    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        for staggered in (False, True, "sync"):
            runtime, engine, pipeline, agent, done = _agent_pipeline(
                rank, mesh, {**parameters, "mode": "sync"}
                if staggered == "sync" else parameters, texts,
                staggered is True)
            agent._setup()
            scheduler = agent.compute.programs[agent._program].scheduler
            batches = []
            dispatch = scheduler._dispatch

            def recorded(bucket, batch, now, _dispatch=dispatch,
                         _batches=batches):
                _batches.append([list(item.key) for item in batch])
                return _dispatch(bucket, batch, now)

            scheduler._dispatch = recorded
            try:
                responses = _agent_turns(engine, pipeline, done, texts,
                                         3 * rank if staggered is True
                                         else 0)
            finally:
                runtime.terminate()
            out[(name, staggered)] = {
                "responses": responses, "batches": batches,
                "agreed": scheduler.agreed,
                "vocab_shard": tuple(agent.params["lm_head"]["w"].shape)}
    return out


def _replaying_donor(shipped):
    """Make the port's prefill side ship the JAX donor's rows for every
    chain key the JAX run shipped (`shipped`: key -> [per layer (k, v)]
    host arrays): each rank then installs its KV heads of JAX's block
    bytes.  Returns the undo."""
    from aiko_services_tpu_torch import serving_disagg as TD

    real = TD._chain_wire_blocks

    def replay(cache, keys):
        if keys and all(key in shipped for key in keys):
            return TD._HostRows([
                [{"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
                 for k, v in shipped[key]] for key in keys])
        return real(cache, keys)

    TD._chain_wire_blocks = replay
    return lambda: setattr(TD, "_chain_wire_blocks", real)


def _installed_rows(agent, keys) -> dict:
    """key -> [per layer (k, v)] of this rank's pool rows of each cached
    chain block of `keys`."""
    cache = agent.prefix_cache
    present = [key for key in keys if cache.has(key)]
    out = {}
    for key, node in zip(present, cache.nodes(present)):
        k_rows, v_rows = cache.block_rows(node)
        out[key] = [(k.numpy().copy(), v.numpy().copy())
                    for k, v in zip(k_rows, v_rows)]
    return out


def _prefill_side_on_the_mesh(runtime, agent) -> dict:
    """The prefill side on the agent's mesh: a PrefillRuntime handed a
    decoder sharded alike (the agent's shards, config and mesh, a prefix
    cache of its own), and a SessionMigrator on that cache.  Each is
    built and stopped; returns each one's ValueError message, or None,
    and whether each serves through its link (the sharded prefill side
    is driven in tests/test_torch_tp_prefill.py)."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_disagg import (PrefillRuntime,
                                                        SessionMigrator)
    decoder = agent.decoder
    cache = PrefixKVCache(block_tokens=8, max_bytes=1 << 20,
                          registry=MetricsRegistry())
    sharded = ContinuousDecoder(decoder.params, decoder.config,
                                mesh=decoder.mesh, max_slots=2,
                                prefill_buckets=(16,), prefill_chunk=16,
                                prefix_cache=cache,
                                registry=MetricsRegistry())
    out = {}
    for name, build in (
            ("prefill", lambda: PrefillRuntime(runtime, "sharded_prefill",
                                               decoder=sharded)),
            ("migrate", lambda: SessionMigrator(runtime, cache,
                                                decoder=sharded))):
        try:
            side = build()
            out[name] = None
            out[f"{name}_linked"] = side._link is not None
            side.stop()
        except ValueError as exc:
            out[name] = str(exc)
    return out


def agent_disagg(rank, world, geometries, agent_flat, config_fields,
                 parameters, texts, shipped, timeout_parameters,
                 cacheless_parameters):
    """PE_LlamaAgent with disagg on each mesh of `geometries`: rank 0
    alone hosts a PrefillRuntime (unsharded, the whole model, its ship
    replaying the JAX donor's rows `shipped`) and its client alone sends
    (a prefill side sharded over the mesh is built beside it, and
    stopped);
    the conversation in lockstep, then staggered with skewed clocks.
    Then with `timeout_parameters` and a prefill candidate that never
    answers: every transfer times out, retries and falls back.  Then with
    `cacheless_parameters` (no prefix cache: the blocks land in the
    pool, the prefill side in the decoder's 32-token blocks).  Returns
    each drive's responses, plan digests, client counters, the rounds at
    which requests were submitted to the decoder, and this rank's
    installed rows of every shipped key."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import kv_head_range
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.serving_disagg import PrefillRuntime
    from aiko_services_tpu_torch.transport import MemoryMessage

    config = TL.LlamaConfig(**config_fields)
    TL.LLAMA_PRESETS["tiny"] = config

    def seeded(generator, config, device=None):
        return bridge.params_from_numpy(agent_flat, config, device=device)

    TL.llama_init = seeded
    undo_donor = _replaying_donor(shipped)
    out = {}
    try:
        for name, mesh_axes in geometries.items():
            mesh = create_mesh(mesh_axes, device="cpu")
            out[(name, "heads")] = kv_head_range(config, mesh)
            drives = [(False, parameters, True), (True, parameters, True),
                      (False, timeout_parameters, False),
                      (False, cacheless_parameters, True)]
            for index, (staggered, agent_parameters, answers) in \
                    enumerate(drives):
                undo = _skewed(rank, staggered)
                runtime, engine, pipeline, agent, done = _agent_pipeline(
                    rank, mesh, agent_parameters, texts, staggered)
                try:
                    agent._setup()
                    client = agent._prefill_client
                    decoder = agent.decoder
                    decoder.plan_digests = []
                    submitted = []
                    submit = decoder.submit

                    def recording(request_id, *args, _submit=submit,
                                  _decoder=decoder, _log=submitted,
                                  **kwargs):
                        _log.append((request_id, _decoder.stats["rounds"]))
                        return _submit(request_id, *args, **kwargs)

                    decoder.submit = recording
                    prefill = None
                    if rank == 0:
                        if answers:
                            prefill = PrefillRuntime(
                                ProcessRuntime(
                                    name=f"prefill{index}", engine=engine,
                                    transport_factory=lambda on_message, *_:
                                    MemoryMessage(on_message=on_message,
                                                  broker=runtime.message
                                                  .broker)).initialize(),
                                "prefill", params=bridge.params_from_numpy(
                                    agent_flat, config, device="cpu"),
                                config=config, block_tokens=agent_parameters
                                .get("prefix_block", 32), max_slots=2,
                                prefill_buckets=(16,), prefill_chunk=16,
                                decoder_opts={"device": "cpu"})
                            client.add_candidate(prefill.topic_path)
                        else:
                            client.add_candidate(f"{runtime.topic_path}/"
                                                 f"nobody")
                    if index == 0:
                        out[(name, "prefill_side")] = \
                            _prefill_side_on_the_mesh(runtime, agent)
                    responses = _agent_turns(engine, pipeline, done, texts,
                                             3 * rank if staggered else 0)
                    stats = {key: client.stats[key] for key in (
                        "transfers", "installs", "installed_blocks",
                        "local_fallbacks", "transfer_timeouts", "retries",
                        "install_shed", "direct_installs")}
                    rows = _installed_rows(agent, list(shipped)) \
                        if agent.prefix_cache is not None else {}
                    out[(name, index)] = {
                        "responses": responses,
                        "plans": decoder.plan_digests,
                        "client": stats, "submitted": submitted,
                        "prefix_admits": decoder.stats["prefix_admits"],
                        "rows": rows}
                    if prefill is not None:
                        prefill.stop()
                finally:
                    runtime.terminate()
                    undo()
    finally:
        undo_donor()
    return out


def batched_beside_decoder(rank, world, flat, config_fields, prompts,
                           max_new, items):
    """A ComputeRuntime over {model: world} holding a batched program
    (each item's payload summed: no collective) and, on the same engine,
    a ContinuousDecoder on this rank's shards pumped by its timer: each
    rank submits its batch items and its decoder requests at engine steps
    of its own (offset by rank), so the runtime's batch exchange and the
    decoder's round-note gather interleave differently on each rank.
    Returns the batch results, the decoder's tokens and plan digests,
    and the batches this rank ran."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    config = TL.LlamaConfig(**config_fields)
    mesh = create_mesh({"model": world}, device="cpu")
    params, _ = local_shards(bridge.params_from_numpy(flat, config,
                                                      device="cpu"),
                             TL.llama_axes(config), mesh, config=config)
    engine = EventEngine(VirtualClock(100.0 * rank))
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name=f"beside{rank}", engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    compute = ComputeRuntime(runtime, "compute", mesh=mesh)
    batches = []

    def run(_bucket, batch):
        batches.append(batch.tolist())
        return batch.sum(dim=1)

    compute.register_batched(
        "sum", run, [4], lambda _bucket, payloads: torch.from_numpy(
            np.stack(payloads)), lambda results, count: [
            int(results[i]) for i in range(count)], max_batch=3,
        max_wait=0.004)
    decoder = ContinuousDecoder(params, config, mesh=mesh, max_slots=2,
                                prefill_buckets=(16,), steps_per_sync=2,
                                registry=MetricsRegistry())
    decoder.plan_digests = []
    decoder.attach(engine, period=0.002)
    sums, tokens = {}, {}
    item_due = {2 * k + rank: k for k in range(len(items))}
    request_due = {3 * k + 2 * rank: rid for k, rid in enumerate(prompts)}
    try:
        for step in range(4000):
            if step in item_due:
                k = item_due[step]
                compute.submit("sum", f"s{k % 2}",
                               np.asarray(items[k], np.int64), 4,
                               lambda _sid, total, k=k: sums.update(
                                   {k: total}))
            if step in request_due:
                rid = request_due[step]
                decoder.submit(rid, prompts[rid], max_new,
                               lambda r, t: tokens.update(
                                   {r: [int(x) for x in t]}))
            if len(sums) == len(items) and len(tokens) == len(prompts):
                break
            engine.clock.advance(0.002)
            engine.step()
    finally:
        decoder.detach(engine)
        runtime.terminate()
    return {"sums": sums, "tokens": tokens, "plans": decoder.plan_digests,
            "batches": batches}


# -- tests/test_torch_tp_whisper.py -------------------------------------------

def _expanded(tree):
    """A param tree of zero-stride zeros shaped like `tree`'s leaves (a
    meta-device model's): local_shards copies only a rank's cut slices."""
    if isinstance(tree, dict):
        return {key: _expanded(value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_expanded(value) for value in tree]
    return torch.zeros((), dtype=tree.dtype).expand(tree.shape)


def _odd_vocab_training(flat, config, batch, steps, directory):
    """Whisper's SGD steps with an odd vocabulary on {data: 2, model:
    2}, tensor-parallel (the step pads the last rank's vocabulary chunk),
    beside the unsharded step in this process; then a checkpoint of the
    sharded state, restored into a fresh one.  Returns both runs'
    losses and parameters, the checkpoint's table shape and whether
    the restored parameters equal the saved ones."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import whisper as TW
    from aiko_services_tpu_torch.parallel import (checkpoint, create_mesh,
                                                  train)

    mesh = create_mesh({"data": 2, "model": 2}, device="cpu")

    def loss(on):
        def fn(params, batch):
            logits = TW.forward(params, config, batch["mel"],
                                batch["tokens"], mesh=on)
            return train.cross_entropy_loss(logits, batch["targets"],
                                            mesh=on)
        return fn

    def state(on):
        return train.init_train_state(
            bridge.params_from_numpy(flat, config, device="cpu"),
            train.sgd(0.5), on,
            None if on is None else TW.whisper_axes(config))

    plain, sharded = state(None), state(mesh)
    plain_step = train.make_train_step(loss(None))
    sharded_step = train.make_train_step(loss(mesh), mesh=mesh)
    losses = {"plain": [], "sharded": []}
    for _ in range(steps):
        plain, value = plain_step(plain, batch)
        losses["plain"].append(float(value))
        sharded, value = sharded_step(sharded, batch)
        losses["sharded"].append(float(value))
    saved = {name: p.full_tensor().detach().clone()
             for name, p in sharded.params.named_parameters()}
    path = checkpoint.save_checkpoint(directory, {
        "params": sharded.params, "opt_state": sharded.opt_state,
        "step": int(sharded.step)})
    fresh = state(mesh)
    loaded = checkpoint.restore_checkpoint(path, {
        "params": fresh.params, "opt_state": fresh.opt_state, "step": 0})
    with np.load(os.path.join(path, "state.npz")) as arrays:
        table = [tuple(arrays[key].shape) for key in arrays.files
                 if key.endswith("tok_embed/table")]
    return {"losses": losses,
            "plain": {name: p.detach().numpy()
                      for name, p in plain.params.named_parameters()},
            "sharded": {name: value.numpy()
                        for name, value in saved.items()},
            "table": table,
            "restored": all(
                torch.equal(p.full_tensor(), saved[name])
                for name, p in loaded["params"].named_parameters()),
            "local_table": tuple(sharded.params.tok_embed.table.to_local()
                                 .shape)}


def tp_whisper(rank, world, geometries, flat, config_fields, mel, tokens,
               max_tokens, train_batch=None, directory=None):
    """Whisper on each mesh of `geometries` from the JAX tree `flat`, in
    f32, each rank on its shards (ComputeRuntime.place_params with
    whisper_axes: parallel.local_shards): the teacher-forced forward's
    logits gathered over the model axis (the padding cut off), the same
    forward under autograd, greedy_decode_scored's tokens, lengths and
    scores, and the shapes of this rank's leaves; then which leaves of
    Whisper-small a rank of {model: 2} holds, and its heads."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.models import layers as TL
    from aiko_services_tpu_torch.models import whisper as TW
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.collectives import all_gather
    from aiko_services_tpu_torch.parallel.sharding import local_shards
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    config = TW.WhisperConfig(**config_fields)
    mel, tokens = torch.from_numpy(mel), torch.from_numpy(tokens)
    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        runtime = ProcessRuntime(
            name=f"rank{rank}", engine=EventEngine(VirtualClock()),
            transport_factory=lambda on_message, *_: MemoryMessage(
                on_message=on_message, broker=MemoryBroker())).initialize()
        compute = ComputeRuntime(runtime, "compute", mesh=mesh)
        params = compute.place_params(
            bridge.params_from_numpy(flat, config, device="cpu"),
            TW.whisper_axes(config))

        def gathered(logits):
            whole = all_gather(logits.detach(), "model", axis=-1, mesh=mesh)
            return whole[..., :config.n_vocab].numpy()
        with torch.no_grad():
            logits = TW.forward(params, config, mel, tokens, mesh=mesh)
        trained = TW.forward(params, config, mel, tokens, mesh=mesh)
        decoded = TW.greedy_decode_scored(params, config, mel,
                                          max_tokens=max_tokens, mesh=mesh)
        out[name] = {
            "logits": gathered(logits), "autograd": gathered(trained),
            "chunk": tuple(logits.shape),
            "decoded": [x.numpy() for x in decoded],
            "q": tuple(params["dec_blocks"][0]["attn"]["q"]["w"].shape),
            "o": tuple(params["dec_blocks"][0]["cross"]["o"]["w"].shape),
            "mlp_in": tuple(params["enc_blocks"][0]["mlp_in"]["w"].shape),
            "table": tuple(params["tok_embed"]["table"].shape),
            "padding": float(params["tok_embed"]["table"][
                config.n_vocab - mesh.get_local_rank("model") *
                params["tok_embed"]["table"].shape[0]:].abs().sum())
            if "model" in mesh.mesh_dim_names else 0.0}
        runtime.terminate()
    if train_batch is not None:
        out["training"] = _odd_vocab_training(
            flat, config, {key: torch.from_numpy(value)
                           for key, value in train_batch.items()}, 3,
            directory)
    small = TW.WHISPER_PRESETS["small"]
    meta = TL.as_tree(TW.Whisper(small, device="meta"))
    tree = _expanded({"enc_blocks": [meta["enc_blocks"][0]],
                      "tok_embed": meta["tok_embed"]})
    mesh = create_mesh({"data": world // 2, "model": 2}, device="cpu")
    shards, _ = local_shards(tree, TW.whisper_axes(small), mesh)
    block = shards["enc_blocks"][0]
    out["small"] = {"heads": TW.local_heads(small, mesh),
                    "q": tuple(block["attn"]["q"]["w"].shape),
                    "o": tuple(block["attn"]["o"]["w"].shape),
                    "mlp_in": tuple(block["mlp_in"]["w"].shape),
                    "mlp_out": tuple(block["mlp_out"]["w"].shape),
                    "table": tuple(shards["tok_embed"]["table"].shape)}
    return out


def tp_transcription(rank, world, definition, npz, streams, frequencies,
                     presets):
    """examples/speech/pipeline_transcription.json (a copy naming the
    weights and its overrides) built as `pipeline create --mesh model=2
    --device cpu` builds it (cli.build_pipeline), with the Whisper
    presets `presets` (name -> (base preset, field overrides)) added,
    its ASR switched to f32 on this rank's shards of the npz, driven on
    a virtual clock until every stream's frames complete.  Returns each
    frame's tokens and text, the ASR's leaf shapes and its batch
    statistics."""
    import dataclasses
    import json

    from aiko_services_tpu_torch import bridge, cli
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.models import whisper as TW

    for name, (base, fields) in presets.items():
        TW.WHISPER_PRESETS[name] = dataclasses.replace(
            TW.WHISPER_PRESETS[base], **fields)

    engine = EventEngine(VirtualClock())
    runtime, pipeline = cli.build_pipeline(
        definition, stream_id="s0",
        stream_parameters=json.dumps(dict(streams, **{
            "PE_MicrophoneSim.frequency": frequencies[0]})),
        device="cpu", engine=engine, mesh_spec=f"model={world}")
    for index, frequency in enumerate(frequencies[1:], start=1):
        pipeline.create_stream(f"s{index}", parameters=dict(
            streams, **{"PE_MicrophoneSim.frequency": frequency}))
    done = []
    pipeline.add_frame_handler(done.append)
    asr = pipeline.graph.node("PE_WhisperASR").element
    asr.config = dataclasses.replace(asr.config, dtype=torch.float32)
    whole = TW.whisper_init(torch.Generator().manual_seed(0), asr.config,
                            device="cpu")
    asr.params = asr.compute.place_params(
        bridge.load_flat_npz(whole, npz), TW.whisper_axes(asr.config))
    expected = len(frequencies) * int(streams["PE_MicrophoneSim.limit"])
    for _ in range(6000):
        if len(done) >= expected:
            break
        engine.clock.advance(0.01)
        engine.step()
    scheduler = asr.compute.programs[asr._program].scheduler
    out = {"frames": {(frame.stream_id, frame.frame_id):
                      (np.asarray(frame.swag["tokens"]).tolist(),
                       frame.swag["text"]) for frame in done},
           "q": tuple(asr.params["enc_blocks"][0]["attn"]["q"]["w"].shape),
           "table": tuple(asr.params["tok_embed"]["table"].shape),
           "mesh": asr.compute.ec_producer.get("mesh"),
           "agreed": scheduler.agreed,
           "batches": scheduler.stats["batches"]}
    runtime.terminate()
    return out


# -- tests/test_torch_tp_prefill.py -------------------------------------------

def _recording_ships():
    """Record every KV-transfer envelope this process encodes: (records
    [(tokens, start block, [per block [per layer (k, v) bytes]],
    layout)], undo)."""
    from aiko_services_tpu_torch.transport import wire

    records = []
    real = wire.encode_kv_transfer

    def leaf_bytes(leaf):
        if isinstance(leaf, dict):
            return b"".join(leaf_bytes(leaf[key]) for key in ("q", "s"))
        return np.ascontiguousarray(np.asarray(leaf)).tobytes()

    def recording(transfer_id, tenant, tokens, start_block, block, layout,
                  blocks, *args, **kwargs):
        records.append(([int(t) for t in tokens], int(start_block), [
            [(leaf_bytes(layer["k"]), leaf_bytes(layer["v"]))
             for layer in one] for one in blocks], tuple(layout)))
        return real(transfer_id, tenant, tokens, start_block, block,
                    layout, blocks, *args, **kwargs)

    wire.encode_kv_transfer = recording
    return records, lambda: setattr(wire, "encode_kv_transfer", real)


def _prefill_plane(rank, mesh, params, config, engine, broker, tag):
    """A PrefillRuntime (its decoder dense, prefix blocks of 8, chunks of
    16) on `mesh` (None: unsharded) over `params`."""
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_disagg import PrefillRuntime
    from aiko_services_tpu_torch.transport import MemoryMessage

    registry = MetricsRegistry()
    runtime = ProcessRuntime(
        name=f"{tag}{rank}", engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    cache = PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                          name=f"{tag}.cache", registry=registry)
    decoder = ContinuousDecoder(
        params, config, mesh=mesh, max_slots=2, prefill_buckets=(16,),
        prefill_chunk=16, prefix_cache=cache, name=tag, registry=registry,
        **({} if mesh is not None else {"device": "cpu"}))
    return runtime, PrefillRuntime(runtime, tag, decoder=decoder)


def _decode_plane(params, config, engine, broker, tag, prefill_topic):
    """The decode side in one process: an unsharded decoder with a
    prefix cache and a PrefillClient whose one candidate is
    `prefill_topic` (None: no client), pumped from the engine."""
    from types import SimpleNamespace

    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_disagg import (PrefillClient,
                                                        SessionMigrator)
    from aiko_services_tpu_torch.state.sessions import SessionTable
    from aiko_services_tpu_torch.transport import MemoryMessage

    registry = MetricsRegistry()
    runtime = ProcessRuntime(
        name=tag, engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    cache = PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                          name=f"{tag}.cache", registry=registry)
    decoder = ContinuousDecoder(
        params, config, max_slots=2, prefill_buckets=(16,),
        prefill_chunk=16, prefix_cache=cache, name=tag, registry=registry,
        device="cpu")
    decoder.attach(engine, period=0.002)
    client = None
    if prefill_topic is not None:
        client = PrefillClient(runtime, decoder, name=tag, registry=registry,
                               transfer_timeout=30.0)
        client.add_candidate(prefill_topic)
    table = SessionTable(SimpleNamespace(runtime=runtime,
                                         topic_path=runtime.topic_path),
                         num_shards=1)
    migrator = SessionMigrator(runtime, cache, table=table, name=tag,
                               transfer_timeout=30.0, registry=registry)
    return SimpleNamespace(runtime=runtime, cache=cache, decoder=decoder,
                           client=client, table=table, migrator=migrator)


def _step(engine, until, steps=20000):
    for _ in range(steps):
        if until():
            return True
        engine.clock.advance(0.002)
        engine.step()
    return until()


def _chain_rows(cache, tokens) -> list:
    """[per block [per layer (k, v) bytes]] of the cached chain of
    `tokens` in `cache` (dense rows)."""
    keys, hit = cache.match("default", tokens)
    out = []
    for node in cache.nodes(keys[:hit // cache.block_tokens]):
        k_rows, v_rows = cache.block_rows(node)
        out.append([(k.numpy().tobytes(), v.numpy().tobytes())
                    for k, v in zip(k_rows, v_rows)])
    return out


def sharded_prefill(rank, world, geometries, flat, config_fields, prompts,
                    max_new, session):
    """A prefill side sharded over each mesh of `geometries`: a
    PrefillRuntime on every rank over its shards of the JAX tree `flat`;
    rank 0's is the side's address, and rank 0 alone also hosts the
    decode side (unsharded, its PrefillClient sending each of `prompts`
    there).  Every envelope rank 0 encodes is recorded.  Then the
    session `session` (a history whose chain the prefill side cached)
    is pinned on every rank and migrated by the sharded cache's
    SessionMigrator (the lead sending) to an unsharded destination on
    rank 0.  On rank 0 also the same prompts through an unsharded
    prefill side, and the same session migrated from its cache, for the
    byte comparison."""
    from types import SimpleNamespace

    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards
    from aiko_services_tpu_torch.serving_disagg import SessionMigrator
    from aiko_services_tpu_torch.state.sessions import SessionTable
    from aiko_services_tpu_torch.transport import MemoryBroker

    config = TL.LlamaConfig(**config_fields)
    full = bridge.params_from_numpy(flat, config, device="cpu")

    def drive(mesh, tag):
        """One prefill side (on `mesh`, or unsharded on rank 0 alone),
        its ships recorded; then the session migrated from its cache."""
        engine, broker = EventEngine(VirtualClock()), MemoryBroker()
        params = full if mesh is None else local_shards(
            full, TL.llama_axes(config), mesh, config=config)[0]
        runtime, prefill = _prefill_plane(rank, mesh, params, config,
                                          engine, broker, f"{tag}p")
        records, undo = _recording_ships()
        lead = rank == 0
        try:
            decode = _decode_plane(full, config, engine, broker,
                                   f"{tag}d", prefill.topic_path) \
                if lead else None
            done = {}
            if lead:
                for request_id, prompt in prompts.items():
                    decode.client.submit(
                        request_id, prompt, max_new,
                        lambda rid, tokens: done.update(
                            {rid: [int(t) for t in tokens]}))
                finished = _step(engine, lambda: len(done) == len(prompts))
            else:
                # until this rank's decoder is idle, which the lead's is
                # in the same round: a rank that stopped pumping a busy
                # decoder would leave the lead's next round note alone
                finished = _step(engine, lambda: prefill.stats["computed"]
                                 == len(prompts) and
                                 not prefill._outbox._queue and
                                 prefill.decoder.idle)
            prefill_envelopes = len(records)
            # this rank's own rows (its KV heads) of every prompt's chain
            cache = prefill.cache
            own = {rid: _chain_rows(cache, prompt)
                   for rid, prompt in prompts.items()}
            # the session: its chain is cached on every rank alike
            table = SessionTable(SimpleNamespace(
                runtime=runtime, topic_path=runtime.topic_path),
                num_shards=1)
            leaf, kv_tokens = cache.session_store("default", "sid", session)
            session_rows = _chain_rows(cache, session[:kv_tokens])
            table.create("default", "sid", {"history": session,
                                            "kv": leaf or "",
                                            "kv_tokens": kv_tokens})
            source = SessionMigrator(runtime, cache, table=table,
                                     name=f"{tag}m", transfer_timeout=30.0,
                                     decoder=prefill.decoder)
            # a fresh destination: the decode side's cache holds the
            # shipped chains already, and would take them as handles
            dest = _decode_plane(full, config, engine, broker, f"{tag}t",
                                 None) if lead else None
            settled = []
            sent = source.migrate(dest.migrator.topic if lead else "",
                                  settled.append)
            migrated = _step(engine, lambda: bool(settled))
            out = {"finished": finished, "migrated": migrated,
                   "offers": sent, "own_rows": own,
                   "prefill_envelopes": prefill_envelopes,
                   "session_rows": session_rows,
                   "source": {key: source.stats[key] for key in (
                       "acks", "chunks", "shipped_blocks", "migrated")},
                   "pinned": table.get("default", "sid") is not None,
                   "prefill": {key: prefill.stats[key] for key in (
                       "requests", "computed", "blocks_shipped",
                       "envelopes", "chunks_shipped", "refused")}}
            if lead:
                out |= {
                    "responses": done,
                    "client": {key: decode.client.stats[key] for key in (
                        "transfers", "installs", "installed_blocks",
                        "local_fallbacks")},
                    "landed": dest.migrator.stats["landed"],
                    "migrated_rows": _chain_rows(dest.cache,
                                                 session[:kv_tokens]),
                    "kv_tokens": kv_tokens}
            source.stop()
            prefill.stop()
            if lead:
                for plane in (decode, dest):
                    plane.migrator.stop()
                    if plane.client is not None:
                        plane.client.stop()
                    plane.decoder.detach(engine)
                    plane.runtime.terminate()
        finally:
            undo()
        out["ships"] = records
        runtime.terminate()
        return out

    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        out[name] = drive(mesh, name)
        # this rank's place in the lead's model group (None: outside it)
        lead_group = all(index == 0 for axis, index in
                         zip(mesh.mesh_dim_names, mesh.get_coordinate())
                         if axis != "model")
        out[name]["model_index"] = mesh.get_local_rank("model") \
            if lead_group else None
    if rank == 0:
        out["unsharded"] = drive(None, "plain")
    return out


# -- tests/test_torch_tp_migrate.py -------------------------------------------

def _recording_replies():
    """Record the command of every migrate ack or done this process
    encodes: (commands, undo)."""
    from aiko_services_tpu_torch.transport import wire

    commands = []
    real = wire.encode_kv_migrate_reply

    def recording(command, *args, **kwargs):
        commands.append(command)
        return real(command, *args, **kwargs)

    wire.encode_kv_migrate_reply = recording
    return commands, lambda: setattr(wire, "encode_kv_migrate_reply", real)


def _migrate_side(params, config, engine, broker, tag, mesh, host_mb=None,
                  max_sessions=None, timeout=30.0):
    """One serving side of a migration: a paged decoder (blocks of 8) on
    `mesh` (None: unsharded, on the CPU) over `params`, its prefix cache
    (a host tier of host_mb MiB when given), a session table and a
    SessionMigrator, pumped from the engine's timer."""
    from types import SimpleNamespace

    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    from aiko_services_tpu_torch.serving_disagg import SessionMigrator
    from aiko_services_tpu_torch.serving_tiered import HostBlockStore
    from aiko_services_tpu_torch.state.sessions import (SessionTable,
                                                        TenantBudget)
    from aiko_services_tpu_torch.transport import MemoryMessage

    registry = MetricsRegistry()
    runtime = ProcessRuntime(
        name=tag, engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    cache = PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                          name=f"{tag}.cache", registry=registry)
    if host_mb:
        cache.attach_host_store(HostBlockStore(max_bytes=host_mb << 20,
                                               name=f"{tag}.host"))
    decoder = ContinuousDecoder(
        params, config, mesh=mesh, paged_kv=True, kv_block=8,
        prefix_cache=cache, max_slots=2, prefill_buckets=(64,),
        steps_per_sync=4, name=tag, registry=registry,
        **({} if mesh is not None else {"device": "cpu"}))
    decoder.attach(engine, period=0.002)
    budget = TenantBudget(max_sessions=max_sessions) \
        if max_sessions else None
    table = SessionTable(SimpleNamespace(runtime=runtime,
                                         topic_path=runtime.topic_path),
                         num_shards=1, default_budget=budget)
    migrator = SessionMigrator(runtime, cache, table=table, name=tag,
                               chunk_blocks=2, transfer_timeout=timeout,
                               registry=registry,
                               decoder=decoder if mesh is not None
                               else None)
    return SimpleNamespace(runtime=runtime, cache=cache, decoder=decoder,
                           table=table, migrator=migrator)


def _turns(engine, side, prompts, max_new) -> dict:
    """Every prompt submitted at once to the side's decoder, stepped to
    completion: {id: tokens}."""
    done = {}
    for request_id, prompt in prompts.items():
        side.decoder.submit(request_id, prompt, max_new,
                            lambda rid, tokens: done.update(
                                {rid: [int(t) for t in tokens]}))
    if not _step(engine, lambda: len(done) == len(prompts)):
        raise AssertionError(f"{len(done)} of {len(prompts)} turns")
    return done


def _lagging(link, lag: int) -> None:
    """Another rank's link polls only every `lag`-th time: the lead's
    envelopes and expiries reach it rounds late."""
    poll, calls = link.poll, [0]

    def late():
        calls[0] += 1
        if calls[0] % lag == 0:
            poll()
    link.poll = late


def _migration(rank, mesh, full, shards, config, sessions, turns, extra,
               max_new, case):
    """One migration to a destination on `mesh`: the source on rank 0
    alone (unsharded) or on the mesh (case "sharded"); its sessions'
    turns 1 and 2, their histories pinned; migrate; then turn 3 on the
    destination (cases "plain", "sharded", "staggered", "tiered").  Case
    "tiered": the destination holds the histories' chains demoted to a
    host tier before the offer; "shed": its table is at its session
    budget; "expiry": the source never ships after the ack."""
    import torch.distributed as dist

    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.transport import MemoryBroker

    engine, broker = EventEngine(VirtualClock()), MemoryBroker()
    lead = rank == 0
    sharded_source = case == "sharded"
    records, undo_ships = _recording_ships()
    replies, undo_replies = _recording_replies()
    out = {}
    try:
        source = None
        if lead or sharded_source:
            source = _migrate_side(
                shards if sharded_source else full, config, engine, broker,
                f"src{rank}", mesh if sharded_source else None,
                timeout={"shed": 1.0, "expiry": 2.0}.get(case, 30.0))
        dest = _migrate_side(
            shards, config, engine, broker, f"dst{rank}", mesh,
            host_mb=8 if case == "tiered" else None,
            max_sessions=1 if case == "shed" else None,
            timeout=0.5 if case == "expiry" else 30.0)
        if case == "shed":
            assert dest.table.create("default", "other", {"history": []})
        if case == "staggered" and dest.migrator._link is not None and \
                not lead:
            _lagging(dest.migrator._link, 2 * rank + 1)
        histories = None
        if source is not None:
            first = _turns(engine, source, dict(zip(sessions, turns)),
                           max_new)
            second = _turns(engine, source, {
                sid: turns[i] + first[sid] + extra[i]
                for i, sid in enumerate(sessions)}, max_new)
            histories = {sid: turns[i] + first[sid] + extra[i] +
                         second[sid] for i, sid in enumerate(sessions)}
            pinned = {}
            for sid, history in histories.items():
                leaf, kv_tokens = source.cache.session_store(
                    "default", sid, history)
                assert source.table.create("default", sid, {
                    "history": history, "kv": leaf or "",
                    "kv_tokens": kv_tokens})
                pinned[sid] = kv_tokens
            out["turns"] = {"first": first, "second": second,
                            "pinned": pinned}
        box = [histories]
        dist.broadcast_object_list(box, src=0)
        histories = box[0]
        if case == "tiered":
            # the destination served these histories once, and its host
            # tier holds their chains: the offer promotes them
            _turns(engine, dest, {f"warm.{sid}": history
                                  for sid, history in histories.items()},
                   1)
            out["demoted"] = dest.cache.purge()
        if case == "expiry" and lead:
            source.migrator._on_ack = lambda *args: None
        dist.barrier()
        dest.decoder.plan_digests = []
        settled = []
        sent = 0
        if source is not None:
            sent = source.migrator.migrate(dest.migrator.topic
                                           if lead else "", settled.append)
        count = len(sessions)
        key = {"shed": "refused", "expiry": "expired"}.get(case, "landed")

        def finished():
            if dest.migrator.stats[key] < count or \
                    dest.migrator.pending_count():
                return False
            return source is None or bool(settled)
        out["migrated"] = _step(engine, finished)
        dist.barrier()
        stats = dest.migrator.stats
        out["dest"] = {name: stats[name] for name in (
            "received", "installed_blocks", "landed", "refused", "expired",
            "dropped_chunks", "corrupt")}
        out["pending"] = dest.migrator.pending_count()
        out["offers"] = sent
        if source is not None:
            out["source"] = {name: source.migrator.stats[name] for name in (
                "acks", "chunks", "shipped_blocks", "handle_blocks",
                "migrated", "expired")}
            out["source_sessions"] = len(source.table)
        out["dest_sessions"] = sorted(dest.cache.sessions())
        out["records"] = len(dest.table)
        out["promoted"] = dest.cache.stats["promoted"]
        out["kv_heads"] = dest.decoder.kv_heads
        if key == "landed":
            out["rows"] = {sid: _chain_rows(dest.cache, history[:(
                len(history) // 8) * 8]) for sid, history in
                histories.items()}
            hits = dest.cache.stats["hit_tokens"]
            admits = dest.decoder.stats["prefix_admits"]
            out["third"] = _turns(engine, dest, {
                sid: history + extra[i] for i, (sid, history) in
                enumerate(histories.items())}, max_new)
            out["hit_tokens"] = dest.cache.stats["hit_tokens"] - hits
            out["prefix_admits"] = dest.decoder.stats["prefix_admits"] - \
                admits
        out["plans"] = dest.decoder.plan_digests
        out["histories"] = histories
        dist.barrier()
        for side in (source, dest):
            if side is not None:
                side.migrator.stop()
                side.table.stop()
                side.decoder.detach(engine)
                side.runtime.terminate()
    finally:
        undo_ships()
        undo_replies()
    out["ships"] = records
    out["replies"] = replies
    return out


def sharded_destination(rank, world, geometries, flat, config_fields,
                        sessions, turns, extra, max_new, cases):
    """A migration destination sharded over each mesh of `geometries`,
    in each of `cases` (name -> the geometries it runs on): from an
    unsharded source on rank 0 and from a source sharded over the same
    mesh, in lockstep and with the lead's envelopes reaching the other
    ranks late, promoting at the offer from a host tier, shed by its
    table, and left waiting by a source that never ships.  The weights
    are the JAX tree `flat`."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models import llama as TL
    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards

    config = TL.LlamaConfig(**config_fields)
    full = bridge.params_from_numpy(flat, config, device="cpu")
    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        shards = local_shards(full, TL.llama_axes(config), mesh,
                              config=config)[0]
        for case, names in cases.items():
            if name in names:
                out[(name, case)] = _migration(
                    rank, mesh, full, shards, config, sessions, turns,
                    extra, max_new, case)
    return out


# -- tests/test_torch_tp_tts.py, tests/test_torch_tp_vision.py ----------------

def _one_element(rank, mesh, element, parameters, inputs, outputs):
    """A one-element pipeline of `element` on this rank's ComputeRuntime
    over `mesh`, on a virtual clock, with one stream "s0": (runtime,
    engine, pipeline, the element, the completed frames)."""
    from aiko_services_tpu_torch import pipeline as TP
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    engine = EventEngine(VirtualClock())
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name=f"{element}{rank}", engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    ComputeRuntime(runtime, "compute", mesh=mesh)
    pipeline = TP.Pipeline(runtime, TP.parse_pipeline_definition({
        "version": 0, "name": f"p_{element}", "runtime": "jax",
        "graph": [f"({element})"],
        "parameters": {f"{element}.{key}": value
                       for key, value in parameters.items()},
        "elements": [{"name": element,
                      "input": [{"name": name} for name in inputs],
                      "output": [{"name": name} for name in outputs]}]}),
        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s0", lease_time=0)
    node = next(node for node in pipeline.graph.nodes()
                if node.name == element)
    return runtime, engine, pipeline, node.element, done


def _frames_through(engine, pipeline, done, name, values) -> list:
    """Each of `values` posted as input `name` on stream "s0", in order,
    stepped until every frame completes (within 120 s of wall time: the
    runtime's agreed batch cut is an exchange between the ranks that
    completes in wall time, whatever the virtual clock says): their
    swags in frame order."""
    import time

    for value in values:
        pipeline.post("process_frame", "s0", {name: value})
    deadline = time.monotonic() + 120.0
    while len(done) < len(values) and time.monotonic() < deadline:
        engine.clock.advance(0.01)
        engine.step()
        time.sleep(0.0005)
    assert len(done) == len(values), f"{len(done)} of {len(values)} frames"
    return [frame.swag for frame in sorted(done,
                                           key=lambda f: f.frame_id)]


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def tp_tts(rank, world, geometries, tts_npz, vocoder_npz, texts):
    """PE_NeuralTTS (preset test, f32, batched, Griffin-Lim of 4 rounds,
    then the vocoder) on each mesh of `geometries`, its weights the JAX
    checkpoints: every text's audio; the acoustic model's mel and frame
    totals on the element's shards and collated tokens; the shapes of
    this rank's leaves; whether the vocoder stays the whole module."""
    from aiko_services_tpu_torch.models.tts import tts_forward
    from aiko_services_tpu_torch.parallel import create_mesh

    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        for leg in ("griffin_lim", "vocoder"):
            parameters = {"preset": "test", "weights": tts_npz,
                          "gl_iters": 4, "max_batch": 8}
            if leg == "vocoder":
                parameters["vocoder_weights"] = vocoder_npz
            runtime, engine, pipeline, element, done = _one_element(
                rank, mesh, "PE_NeuralTTS", parameters, ["text"],
                ["audio", "sample_rate"])
            try:
                swags = _frames_through(engine, pipeline, done, "text",
                                        texts)
                run = {"audio": [np.asarray(swag["audio"])
                                 for swag in swags]}
                if leg == "griffin_lim":
                    tokens = np.zeros((len(texts), element.max_tokens),
                                      np.int32)
                    for i, text in enumerate(texts):
                        ids = element.tokenizer.encode(text)[
                            :element.max_tokens] or [32]
                        tokens[i, :len(ids)] = ids
                    mel, total = tts_forward(element.params, element.config,
                                             torch.from_numpy(tokens),
                                             mesh=mesh)
                    block = element.params["blocks"][0]
                    run |= {"mel": mel.numpy(), "total": total.numpy(),
                            "tokens": tokens,
                            "embed": _shape(element.params["embed"]["table"]),
                            "q": _shape(block["attn"]["q"]["w"]),
                            "o": _shape(block["attn"]["o"]["w"]),
                            "mlp_in": _shape(block["mlp_in"]["w"]),
                            "mlp_out": _shape(block["mlp_out"]["w"]),
                            "mel_head": _shape(element.params["mel_head"]["w"]),
                            "dur_head": _shape(element.params["dur_head"]["w"])}
                else:
                    run["vocoder_module"] = isinstance(element.vocoder,
                                                       torch.nn.Module)
                out[(name, leg)] = run
            finally:
                runtime.terminate()
    return out


def tp_vision(rank, world, geometries, resnet_flat, detector_flat,
              classify_frames, detect_frames, size):
    """PE_ImageClassify (ResNet-18) and PE_Detect (detector_test) at
    `size` on each mesh of `geometries`, batched, their weights the JAX
    trees placed by their axes through the runtime: every frame's class
    and confidence, and detections; the shapes of this rank's head, and
    whether the backbone and the detector stay whole."""
    from aiko_services_tpu_torch import bridge
    from aiko_services_tpu_torch.models.detector import detector_axes
    from aiko_services_tpu_torch.models.resnet import resnet_axes
    from aiko_services_tpu_torch.parallel import create_mesh

    out = {}
    for name, mesh_axes in geometries.items():
        mesh = create_mesh(mesh_axes, device="cpu")
        runtime, engine, pipeline, element, done = _one_element(
            rank, mesh, "PE_ImageClassify",
            {"preset": "resnet18", "image_size": size, "max_batch": 4},
            ["image"], ["class_id", "confidence"])
        try:
            element._setup()
            whole = bridge.params_from_numpy(resnet_flat, element.config,
                                             device="cpu")
            element.params = element.compute.place_params(
                whole, resnet_axes(whole))
            swags = _frames_through(engine, pipeline, done, "image",
                                    classify_frames)
            out[(name, "classify")] = {
                "class_id": [swag["class_id"] for swag in swags],
                "confidence": [swag["confidence"] for swag in swags],
                "head_w": _shape(element.params["head"]["w"]),
                "head_b": _shape(element.params["head"]["b"]),
                "stem": _shape(element.params["stem"])}
        finally:
            runtime.terminate()
        runtime, engine, pipeline, element, done = _one_element(
            rank, mesh, "PE_Detect",
            {"preset": "detector_test", "image_size": size,
             "score_threshold": 0.0, "max_batch": 4},
            ["image"], ["boxes", "scores", "classes"])
        try:
            element._setup()
            whole = bridge.params_from_numpy(detector_flat, element.config,
                                             device="cpu")
            element.params = element.compute.place_params(
                whole, detector_axes(whole))
            swags = _frames_through(engine, pipeline, done, "image",
                                    detect_frames)
            out[(name, "detect")] = {
                "detections": [{key: swag[key] for key in (
                    "boxes", "scores", "classes")} for swag in swags],
                "module": isinstance(element.params, torch.nn.Module)}
        finally:
            runtime.terminate()
    return out
