"""The port's detector (models/detector.py) against the JAX package's, on
the same weights (JAX init → numpy → bridge.params_from_numpy):
detector_forward and detect at detector_test, and at detector_r18's
geometry (four stages, 80 classes, K = 32) at width 8.  Classes are
exactly equal; boxes, scores and the forward's maps within max abs ≤
1e-4 × max |reference| (boxes: 1e-3 pixels plus that).  Thresholds that
zero every row, and a heatmap built to tie at saturated peaks: the port's
order is JAX's (lower flat index first)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import detector as JD
from aiko_services_tpu.models import resnet as JR
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import detector as TD

torch.set_num_threads(1)

CONFIGS = {
    "detector_test": JD.DETECTOR_PRESETS["detector_test"],
    "r18_width8": dataclasses.replace(
        JD.DETECTOR_PRESETS["detector_r18"],
        backbone=JR.ResNetConfig(stage_sizes=(2, 2, 2, 2), num_classes=1,
                                 width=8),
        head_channels=8),
}
RTOL = 1e-4


def port_config(config):
    return TD.DetectorConfig(**{field.name: getattr(config, field.name)
                                for field in dataclasses.fields(config)})


@functools.lru_cache(maxsize=None)
def pair(name):
    config = CONFIGS[name]
    params = jax.jit(functools.partial(JD.detector_init, config=config))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     port_config(config), device="cpu")
    return config, params, model


def frames(size, batch=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (batch, size, size, 3)).astype(np.float32)


def close(got, want, atol=0.0):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= atol + RTOL * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("size", [64, 72])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, size):
    config, params, model = pair(name)
    x = frames(size)
    want = jax.jit(functools.partial(JD.detector_forward, config=config))(
        params, images=jnp.asarray(x))
    with torch.no_grad():
        got = TD.detector_forward(model, port_config(config),
                                  torch.from_numpy(x))
    for port, ref in zip(got, want):
        close(port.numpy(), ref)


def run_both(name, x, threshold):
    config, params, model = pair(name)
    want = jax.jit(functools.partial(JD.detect, config=config,
                                     score_threshold=threshold))(
        params, images=jnp.asarray(x))
    with torch.no_grad():
        got = TD.detect(model, port_config(config), torch.from_numpy(x),
                        score_threshold=threshold)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("threshold", [0.0, 0.3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_detect_matches_jax(name, threshold):
    want, got = run_both(name, frames(64, batch=3, seed=1), threshold)
    (boxes, scores, classes), (t_boxes, t_scores, t_classes) = want, got
    k = CONFIGS[name].max_detections
    assert t_boxes.shape == (3, k, 4) and t_scores.shape == (3, k)
    assert t_boxes.dtype == np.float32 and t_classes.dtype == np.int32
    np.testing.assert_array_equal(t_classes, classes)
    close(t_scores, scores)
    close(t_boxes, boxes, atol=1e-3)
    assert (t_scores > 0).sum() == (scores > 0).sum()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_thresholds_that_zero_every_row(name):
    want, (boxes, scores, classes) = run_both(name, frames(64, seed=2),
                                              1.1)
    assert np.all(scores == 0.0) and np.all(boxes == 0.0)
    assert np.all(classes == -1)
    for port, ref in zip((boxes, scores, classes), want):
        np.testing.assert_array_equal(port, ref)


def test_tied_saturated_peaks_keep_jaxs_order():
    """A heatmap whose peaks all saturate to 1.0 in f32: the head's bias
    pushes every class logit past 30 at chosen cells, so the top-k sees
    ties; the port must return JAX's cells and classes in JAX's order."""
    name = "detector_test"
    config, params, model = pair(name)
    tree = jax.tree.map(np.asarray, params)
    heat = np.zeros_like(tree["head_heat"])
    # class c's logit = 40 * (feature channel c % 8) via the 3x3 kernel's
    # centre tap: every cell of every positive channel saturates
    for c in range(heat.shape[-1]):
        heat[1, 1, c % heat.shape[2], c] = 40.0
    tree["head_heat"] = heat
    t_model = bridge.params_from_numpy(tree, port_config(config),
                                       device="cpu")
    x = frames(64, batch=2, seed=3)
    want = jax.jit(functools.partial(JD.detect, config=config,
                                     score_threshold=0.0))(
        jax.tree.map(jnp.asarray, tree), images=jnp.asarray(x))
    with torch.no_grad():
        got = TD.detect(t_model, port_config(config), torch.from_numpy(x),
                        score_threshold=0.0)
    scores = np.asarray(want[1])
    assert (scores == 1.0).sum() >= 2, "the constructed peaks must tie"
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), scores)
    close(got[0].numpy(), want[0], atol=1e-3)


def test_top_k_stable_puts_the_lower_index_first():
    values = torch.tensor([[0.5, 1.0, 0.2, 1.0, 1.0, 0.0, 0.5]])
    scores, index = TD.top_k_stable(values, 5)
    ref_scores, ref_index = jax.lax.top_k(jnp.asarray(values.numpy()), 5)
    np.testing.assert_array_equal(index.numpy(), np.asarray(ref_index))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    assert index.tolist() == [[1, 3, 4, 0, 6]]


def test_presets_are_the_jax_geometries():
    for name, config in JD.DETECTOR_PRESETS.items():
        port = TD.DETECTOR_PRESETS[name]
        assert port == port_config(config)


def test_weights_cross_by_name():
    config, params, model = pair("r18_width8")
    flat = bridge.flatten_tree(params)
    named = dict(model.named_parameters())
    assert {name.replace(".", "/") for name in named} == set(flat)
    assert tuple(model.head_heat.shape) == (3, 3, 8, 80)
    del flat["neck"]
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(flat, port_config(config), device="cpu")
