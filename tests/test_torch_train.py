"""The port's training path against the JAX package's.

* cross_entropy_loss, with and without a mask, against JAX's.
* Five AdamW steps of tests/test_parallel.py's small Whisper (8 mels,
  dim 16, 4 heads, one encoder and one decoder layer, vocabulary 32) on
  one seeded batch: the port's init_train_state / make_train_step with
  train.adamw(1e-2) (optax.adamw's defaults written out) against JAX's
  with optax.adamw(1e-2), the same starting parameters, in f32.  Losses
  agree within rtol 1e-5 (measured: 2.4e-6 absolute on ~3.0), every
  parameter within atol 5e-5: torch and optax order the Adam update
  differently, and where a gradient is near zero the normalised update
  m/(sqrt(v) + eps) turns f32 rounding into up to a few thousandths of
  one step's size lr = 1e-2 (measured: 1.53e-5 after five steps, in
  enc_blocks/0/mlp_in/w; the limit is ~3x that).
* The same five steps on four gloo ranks as DP 2 x TP 2 (batch over
  data, parameters and moments sharded over model, and the compute
  too: the model and the loss are called with the mesh on the step's
  local shards, whose shapes are recorded, and the steps make no
  all-gather): losses equal to the
  port's unsharded run within rtol 1e-6, parameters and first moments
  within atol 1e-5, a thousandth of one step's size (each data shard's
  products sum over half the batch, and the sum over the data axis adds
  in another order; Adam's normalised update amplifies that where a
  gradient is near zero; measured: 2.0e-7 and 2.6e-6 in two runs).  The
  same group, in the one spawn: a masked loss (cross_entropy_sum) whose
  mask puts 16 tokens on one data shard and 4 on the other, equal to the
  unsharded step on the global masked mean within the same limits; and
  a checkpoint of the sharded state after step 3, written by rank 0
  alone, restored into a fresh sharded state whose last two steps equal
  the unsharded run; and the vocab-parallel loss of seeded logits over
  an odd vocabulary (33, padded to two chunks of 17), equal to the
  unsharded cross_entropy_loss and cross_entropy_sum within rtol 1e-6.
* Checkpoints (tests/test_parallel.py's round trip, retention and SGD
  resume, and an AdamW resume), and both directions across packages: a
  checkpoint JAX wrote after three steps resumes in the port, whose next
  two steps equal JAX's uninterrupted run; one the port wrote resumes in
  JAX the same way."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.parallel import checkpoint as JC
from aiko_services_tpu.parallel import train as JT
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import layers as TL
from aiko_services_tpu_torch.models import whisper as TW
from aiko_services_tpu_torch.parallel import checkpoint as TC
from aiko_services_tpu_torch.parallel import train as TT

import torch_spmd_cases as cases
from torch_spmd import run_ranks

torch.set_num_threads(1)
J_CONFIG = JW.WhisperConfig(n_mels=8, n_audio_ctx=8, n_text_ctx=8,
                            n_vocab=32, dim=16, num_heads=4, enc_layers=1,
                            dec_layers=1)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
T_CONFIG = TW.WhisperConfig(**FIELDS)
_rng = np.random.default_rng(0)
BATCH = {"mel": _rng.standard_normal((8, 16, 8)).astype(np.float32),
         "tokens": _rng.integers(0, 32, (8, 4)).astype(np.int32),
         "targets": _rng.integers(0, 32, (8, 4)).astype(np.int32)}
# one data shard (rows 0-3) counts 16 target tokens, the other 4
MASK = np.concatenate([np.ones((4, 4), np.float32),
                       np.repeat([[1, 0, 0, 0]], 4, 0).astype(np.float32)])
# seeded logits over an odd vocabulary, each target's id spread over
# both chunks (the vocab-parallel loss)
_loss_rng = np.random.default_rng(2)
LOSS_INPUTS = (_loss_rng.standard_normal((3, 5, 33)).astype(np.float32),
               _loss_rng.integers(0, 33, (3, 5)).astype(np.int64),
               (_loss_rng.random((3, 5)) < 0.6).astype(np.float32))
STEPS = 5
TOL = dict(rtol=1e-5, atol=1e-6)             # losses
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)       # parameters


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _j_loss(params, batch):
    logits = JW.forward(params, J_CONFIG, batch["mel"], batch["tokens"])
    return JT.cross_entropy_loss(logits, batch["targets"])


def _t_loss(params, batch):
    logits = TW.forward(params, T_CONFIG, batch["mel"], batch["tokens"])
    return TT.cross_entropy_loss(logits, batch["targets"])


@functools.cache
def _j_start():
    return jax.jit(functools.partial(JW.whisper_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))


def _j_run(state, steps):
    optimizer = optax.adamw(1e-2)
    step = JT.make_train_step(_j_loss, optimizer, donate=False)
    batch = jax.tree.map(jnp.asarray, BATCH)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's five steps, with a checkpoint written after the third."""
    directory = str(tmp_path_factory.mktemp("jax_ckpt"))
    optimizer = optax.adamw(1e-2)
    state = JT.init_train_state(_j_start(), optimizer)
    state, first = _j_run(state, 3)
    path = JC.save_checkpoint(directory, {
        "params": state.params, "opt_state": state.opt_state,
        "step": int(state.step)})
    state, rest = _j_run(state, 2)
    return {"losses": first + rest, "params": _flat(state.params),
            "path": path, "step": int(state.step)}


def _t_state():
    model = bridge.params_from_numpy(_flat(_j_start()), T_CONFIG,
                                     device="cpu")
    return TT.init_train_state(model, TT.adamw(1e-2))


def _t_masked_loss(params, batch):
    logits = TW.forward(params, T_CONFIG, batch["mel"], batch["tokens"])
    return TT.cross_entropy_loss(logits, batch["targets"], batch["mask"])


def _t_run(state, steps, loss_fn=_t_loss, batch=BATCH):
    step = TT.make_train_step(loss_fn)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


@pytest.fixture(scope="module")
def port_run():
    state, losses = _t_run(_t_state(), STEPS)
    return state, losses


def _params(module) -> dict:
    return {name.replace(".", "/"): p.detach().numpy()
            for name, p in module.named_parameters()}


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32) if masked else None
    want = JT.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                 None if mask is None else jnp.asarray(mask))
    got = TT.cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(targets),
                                None if mask is None else
                                torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked:                    # an empty mask divides by 1, not by 0
        zero = torch.zeros(3, 5)
        assert float(TT.cross_entropy_loss(torch.from_numpy(logits),
                                           torch.from_numpy(targets),
                                           zero)) == 0.0


def test_adamw_states_optax_defaults():
    optimizer = TT.adamw(1e-2).init(TL.Linear(2, 3))
    group = optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == \
        ((0.9, 0.999), 1e-8, 1e-4)
    assert group["param_names"] == ["w", "b"]


def test_adamw_steps_match_jax(jax_run, port_run):
    state, losses = port_run
    np.testing.assert_allclose(losses, jax_run["losses"], **TOL)
    assert losses[-1] < losses[0] and state.step == STEPS
    got = _params(state.params)
    assert got.keys() == jax_run["params"].keys()
    for key, want in jax_run["params"].items():
        np.testing.assert_allclose(got[key], want, err_msg=key,
                                   **PARAM_TOL)


@pytest.fixture(scope="module")
def dp_tp_ranks(tmp_path_factory):
    """The DP 2 x TP 2 runs of torch_spmd_cases.dp_tp_train, one spawn."""
    directory = tmp_path_factory.mktemp("dp_tp")
    return run_ranks(cases.dp_tp_train, 4, directory, _flat(_j_start()),
                     FIELDS, BATCH, MASK, STEPS, str(directory / "ckpt"),
                     LOSS_INPUTS, timeout=240.0)


def _assert_like_unsharded(result, state, losses):
    np.testing.assert_allclose(result["losses"], losses, rtol=1e-6)
    assert result["step"] == STEPS
    assert result["q_spec"] == (None, "model")
    assert result["q_local"] == (16, 8)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(result["params"][name],
                                   p.detach().numpy(), rtol=1e-6,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(result["moments"][name],
                                   state.opt_state.state[p]["exp_avg"].
                                   numpy(), rtol=1e-6, atol=1e-5,
                                   err_msg=name)


def test_dp_tp_step_equals_the_unsharded_step(port_run, dp_tp_ranks):
    state, losses = port_run
    for result in dp_tp_ranks:
        _assert_like_unsharded(result["plain"], state, losses)


def test_dp_tp_step_computes_on_local_shards_and_gathers_nothing(
        dp_tp_ranks):
    """loss_fn is handed each rank's shards (4 heads of dim 4 over two:
    q's 8 of 16 columns, the FFN's 32 of 64, 16 of 32 vocabulary rows),
    the forward's logits are the rank's vocabulary chunk, and a step
    makes no all-gather of any kind."""
    for result in dp_tp_ranks:
        assert result["gathers"] == 0
        assert result["seen"] == {"q_w": (16, 8), "mlp_in_w": (16, 32),
                                  "table": (16, 16), "logits": (4, 4, 16)}


def test_vocab_parallel_loss_equals_the_unsharded_loss(dp_tp_ranks):
    logits, targets, mask = (torch.from_numpy(x) for x in LOSS_INPUTS)
    want = {"mean": float(TT.cross_entropy_loss(logits, targets)),
            "masked": float(TT.cross_entropy_loss(logits, targets, mask))}
    total, count = TT.cross_entropy_sum(logits, targets, mask)
    for result in dp_tp_ranks:
        got = result["vocab_parallel"]
        assert got["chunk"] == (3, 5, 17)
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-6)
        np.testing.assert_allclose(got["masked"], want["masked"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["sum"], (float(total), float(count)),
                                   rtol=1e-6)


def test_masked_dp_tp_step_equals_the_global_masked_mean(dp_tp_ranks):
    """Unequal mask sums per data shard: the sharded step still takes
    the global batch's masked mean, as the unsharded step does."""
    assert MASK[:4].sum() != MASK[4:].sum()
    state, losses = _t_run(_t_state(), STEPS, _t_masked_loss,
                           dict(BATCH, mask=MASK))
    for result in dp_tp_ranks:
        _assert_like_unsharded(result["masked"], state, losses)


def test_dp_tp_checkpoint_resumes_sharded(port_run, dp_tp_ranks):
    """A checkpoint of DP 2 x TP 2 state: one writer, and a fresh sharded
    state restored from it runs on like the unsharded run."""
    state, losses = port_run
    assert sum(result["writes"] for result in dp_tp_ranks) == 1
    assert dp_tp_ranks[0]["writes"] == 1
    for result in dp_tp_ranks:
        resumed = result["resumed"]
        assert resumed["restored_step"] == 3
        _assert_like_unsharded(resumed, state, losses[3:])


def test_checkpoint_roundtrip(tmp_path):
    tree = {"layers": [{"w": torch.arange(6.0).reshape(2, 3),
                        "b": torch.zeros(3)}], "step": 7}
    path = TC.save_checkpoint(str(tmp_path), tree, step=7)
    restored = TC.restore_checkpoint(path, tree)
    assert torch.equal(restored["layers"][0]["w"], tree["layers"][0]["w"])
    assert restored["step"] == 7
    # the JAX package reads the same files back
    jax_restored = JC.restore_checkpoint(path, {
        "layers": [{"w": np.zeros((2, 3), np.float32),
                    "b": np.zeros(3, np.float32)}], "step": 0})
    np.testing.assert_array_equal(jax_restored["layers"][0]["w"],
                                  np.arange(6.0).reshape(2, 3))


def test_checkpoint_manager_retention(tmp_path):
    manager = TC.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.ones(2)}
    for step in (1, 2, 3, 4):
        manager.save(tree, step)
    assert manager._steps() == [3, 4]
    restored, step = manager.restore_latest(tree)
    assert step == 4 and torch.equal(restored["x"], torch.ones(2))
    assert TC.CheckpointManager(str(tmp_path / "none")).restore_latest(
        tree) == (None, None)


def _resume(tmp_path, optimizer, loss_fn, model_fn, batch, continue_fn):
    """Train 3 steps, save, train 2 more; restore into a fresh state and
    train 2: returns (uninterrupted state, resumed state)."""
    state = TT.init_train_state(model_fn(), optimizer)
    step = TT.make_train_step(loss_fn)
    for _ in range(3):
        state, _ = step(state, batch)
    path = TC.save_checkpoint(str(tmp_path), {
        "params": state.params, "opt_state": state.opt_state,
        "step": int(state.step)})
    for _ in range(2):
        state, _ = step(state, batch)
    fresh = TT.init_train_state(model_fn(), optimizer)
    loaded = TC.restore_checkpoint(path, {
        "params": fresh.params, "opt_state": fresh.opt_state, "step": 0})
    resumed = TT.TrainState(loaded["params"], loaded["opt_state"],
                            loaded["step"])
    for _ in range(2):
        resumed, _ = step(resumed, batch)
    return state, resumed


def test_checkpoint_resume_training(tmp_path):
    """tests/test_parallel.py's SGD resume: the resumed run equals the
    uninterrupted one."""
    def model():
        linear = TL.Linear(3, 1, bias=False, device="cpu")
        with torch.no_grad():
            linear.w.fill_(1.0)
        return linear

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()

    batch = {"x": torch.ones(4, 3), "y": torch.zeros(4, 1)}
    state, resumed = _resume(tmp_path, TT.sgd(0.1), loss_fn, model, batch,
                             None)
    np.testing.assert_allclose(resumed.params.w.detach().numpy(),
                               state.params.w.detach().numpy(), rtol=1e-6)
    assert resumed.step == state.step == 5


def test_checkpoint_resume_adamw_restores_the_moments(tmp_path):
    batch = {k: torch.from_numpy(v) for k, v in BATCH.items()}
    state, resumed = _resume(
        tmp_path, TT.adamw(1e-2), _t_loss,
        lambda: bridge.params_from_numpy(_flat(_j_start()), T_CONFIG,
                                         device="cpu"), batch, None)
    assert resumed.step == state.step == 5
    for (name, p), q in zip(state.params.named_parameters(),
                            resumed.params.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-6, err_msg=name)
        for moment in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(
                resumed.opt_state.state[q][moment].numpy(),
                state.opt_state.state[p][moment].numpy(), rtol=1e-6)
        assert float(resumed.opt_state.state[q]["step"]) == 5.0


def test_a_jax_checkpoint_resumes_in_the_port(jax_run):
    fresh = _t_state()
    loaded = TC.restore_checkpoint(jax_run["path"], {
        "params": fresh.params, "opt_state": fresh.opt_state, "step": 0})
    assert loaded["step"] == 3
    state = TT.TrainState(loaded["params"], loaded["opt_state"],
                          loaded["step"])
    state, losses = _t_run(state, 2)
    np.testing.assert_allclose(losses, jax_run["losses"][3:], **TOL)
    assert state.step == jax_run["step"] == 5
    got = _params(state.params)
    for key, want in jax_run["params"].items():
        np.testing.assert_allclose(got[key], want, err_msg=key,
                                   **PARAM_TOL)


def test_a_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    state, _ = _t_run(_t_state(), 3)
    path = TC.save_checkpoint(str(tmp_path), {
        "params": state.params, "opt_state": state.opt_state,
        "step": int(state.step)})
    template = JT.init_train_state(_j_start(), optax.adamw(1e-2))
    loaded = JC.restore_checkpoint(path, {
        "params": template.params, "opt_state": template.opt_state,
        "step": 0})
    resumed = JT.TrainState(loaded["params"], loaded["opt_state"],
                            loaded["step"])
    resumed, losses = _j_run(resumed, 2)
    np.testing.assert_allclose(losses, jax_run["losses"][3:], **TOL)
    assert int(resumed.step) == 5
    for key, value in _flat(resumed.params).items():
        np.testing.assert_allclose(value, jax_run["params"][key],
                                   err_msg=key, **PARAM_TOL)
