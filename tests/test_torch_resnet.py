"""The port's ResNet (models/resnet.py) against the JAX package's, on the
same weights (JAX init → numpy → bridge.params_from_numpy): the backbone
features and the classifier logits at small widths, f32, at image sizes
whose SAME padding is even (64) and uneven (72 and 57: a stride-2 pad of
0 low and 1 high, the 7x7 stem's 2 and 3, odd sizes).  Tolerance: max
abs ≤ 1e-4 × max |reference|."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aiko_services_tpu.models import resnet as JR
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import resnet as TR

torch.set_num_threads(1)

CONFIGS = {
    "two_stages": JR.ResNetConfig(stage_sizes=(1, 1), num_classes=10,
                                  width=8),
    "r18_geometry": JR.ResNetConfig(stage_sizes=(2, 2, 2, 2),
                                    num_classes=10, width=8),
}
RTOL = 1e-4


def port_config(config):
    return TR.ResNetConfig(**{field.name: getattr(config, field.name)
                              for field in dataclasses.fields(config)})


@functools.lru_cache(maxsize=None)
def pair(name):
    config = CONFIGS[name]
    params = jax.jit(functools.partial(JR.resnet_init, config=config))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     port_config(config), device="cpu")
    return config, params, model


def images(size, batch=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (batch, size, size, 3)).astype(np.float32)


def assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= RTOL * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("size", [64, 72, 57])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_features_match_jax(name, size):
    config, params, model = pair(name)
    x = images(size)
    want = jax.jit(JR.resnet_features)(params, jnp.asarray(x))
    with torch.no_grad():
        got = TR.resnet_features(model, torch.from_numpy(x))
    # the port's map is NCHW (channels_last); JAX's NHWC
    assert_close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("size", [64, 57])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax(name, size):
    config, params, model = pair(name)
    x = images(size, batch=3, seed=1)
    want = jax.jit(functools.partial(JR.resnet_forward, config=config))(
        params, images=jnp.asarray(x))
    with torch.no_grad():
        got = TR.resnet_forward(model, port_config(config),
                                torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (256, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
    (57, 3, 2, (1, 1)), (57, 7, 2, (3, 3)), (64, 3, 1, (1, 1)),
    (8, 1, 2, (0, 0))])
def test_same_pads_follow_xla(size, kernel, stride, pads):
    """out = ceil(size / stride); total pad total // 2 low, rest high."""
    assert TR.same_pads(size, kernel, stride) == pads


def test_uneven_pads_are_not_torchs_symmetric_padding():
    """The stem and the max pool at an even size: torch's symmetric
    padding shifts the window, the port's explicit pads match JAX."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=(7, 7, 3, 4)).astype(np.float32)
    want = np.asarray(JR._conv(jnp.asarray(w), jnp.asarray(x), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w)
    got = TR._conv(wt, xt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    symmetric = F.conv2d(xt, wt.permute(3, 2, 0, 1), stride=2, padding=3)
    assert not np.allclose(symmetric.permute(0, 2, 3, 1).numpy(), want,
                           atol=1e-2)
    pooled = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                   (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = TR._max_pool_same(xt, 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(pooled))


def test_weights_cross_by_name_in_hwio_and_relayout_on_write():
    """Every JAX leaf lands under its '.'-joined path with its HWIO
    shape; the cuDNN layout follows an in-place write of the leaf."""
    config, params, model = pair("two_stages")
    flat = bridge.flatten_tree(params)
    named = dict(model.named_parameters())
    assert {name.replace(".", "/") for name in named} == set(flat)
    assert tuple(model.stem.shape) == (7, 7, 3, 8)
    assert tuple(model.stages[1][0].proj.shape) == (1, 1, 8, 16)
    first = TR._oihw(model.stem)
    assert tuple(first.shape) == (8, 3, 7, 7)
    assert TR._oihw(model.stem) is first
    fresh = TR.resnet_init(torch.Generator().manual_seed(1),
                           port_config(config), device="cpu")
    with torch.no_grad():
        fresh.stem.copy_(model.stem * 2.0)
        TR._oihw(fresh.stem)
        fresh.stem.mul_(0.5)
    torch.testing.assert_close(TR._oihw(fresh.stem), first, rtol=0, atol=0)


def test_exact_f32_is_scoped():
    before = torch.backends.cudnn.allow_tf32
    with TR.exact_f32(torch.float32):
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before
    with TR.exact_f32(torch.bfloat16):
        assert torch.backends.cudnn.allow_tf32 == before


def test_presets_are_the_jax_geometries():
    for name, config in JR.RESNET_PRESETS.items():
        port = TR.RESNET_PRESETS[name]
        assert port.stage_sizes == tuple(config.stage_sizes)
        assert (port.width, port.num_classes) == (config.width,
                                                  config.num_classes)
