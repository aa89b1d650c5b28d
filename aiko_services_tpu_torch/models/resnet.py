# ResNet: residual conv classifier in PyTorch.
#
# Counterpart of aiko_services_tpu/models/resnet.py (BASELINE.md config
# 2, "ResNet-18 image-classify PipelineElement"): inference-mode
# batchnorm (the affine x * scale + bias of folded running stats), basic
# blocks, SAME padding.  The ResNet module's parameter names are the JAX
# param tree's paths joined by '.' (stages.1.0.conv1 ↔ stages/1/0/conv1),
# and conv leaves keep the JAX HWIO layout, so bridge.py copies a JAX tree
# in by name and the flat-npz scheme holds unchanged.
#
# Layout: images arrive NHWC [B, H, W, 3], as in JAX.  An NHWC tensor
# viewed as NCHW is exactly PyTorch's channels_last format, which is the
# layout cuDNN's tensor-core convolutions want: the backbone runs on that
# view without a copy, and each HWIO leaf becomes an OIHW channels_last
# weight once per version of the leaf (_oihw).
#
# SAME padding follows XLA's rule: out = ceil(in / stride), the total
# pad split total // 2 low and the rest high.  Under stride 2 that is
# uneven (the 7x7 stem at an even size pads 2 low and 3 high, a 3x3
# conv or the 3x3 max pool 0 low and 1 high), which torch's symmetric
# `padding=` cannot express: uneven pads go through F.pad (-inf for the
# max pool).
#
# TF32: cuDNN runs f32 convolutions in TF32 by default; the JAX reference
# accumulates f32 products in f32.  The f32 forward turns TF32 off for
# its own duration (exact_f32), leaving the process-wide flag as it was.
#
# On a model axis (mesh=) the model is placed by resnet_axes, as JAX
# places it: "channels" maps to no mesh axis under DEFAULT_RULES, so the
# backbone stays whole on every rank, and the head is cut by its classes
# ("vocab"): each rank's logits are its chunk of them (local_classes).

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device, torch_dtype
from . import layers as L

__all__ = ["ResNetConfig", "ResNet", "resnet_init", "resnet_axes",
           "resnet_forward", "resnet_features", "local_classes",
           "exact_f32",
           "RESNET_PRESETS"]


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (2, 2, 2, 2)       # ResNet-18
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        # accept the JAX config's spellings (jnp.float32, "bfloat16", ...)
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "stage_sizes", tuple(self.stage_sizes))


RESNET_PRESETS = {
    "resnet18": ResNetConfig((2, 2, 2, 2)),
    "resnet34": ResNetConfig((3, 4, 6, 3)),
}


def _conv_param(kernel, in_ch, out_ch, dtype, device) -> nn.Parameter:
    return L._param((kernel, kernel, in_ch, out_ch), dtype, device)


def _conv_init_(w, generator) -> None:
    kernel, _, in_ch, _ = w.shape
    L._normal_(w, generator, math.sqrt(2.0 / (kernel * kernel * in_ch)))


class BatchNorm(L.Params):
    """Inference-mode batchnorm: the affine scale and bias."""

    def __init__(self, ch: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = L._param((ch,), dtype, device)
        self.bias = L._param((ch,), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


class BasicBlock(L.Params):
    def __init__(self, in_ch: int, out_ch: int, dtype, device):
        super().__init__()
        self.conv1 = _conv_param(3, in_ch, out_ch, dtype, device)
        self.bn1 = BatchNorm(out_ch, dtype, device)
        self.conv2 = _conv_param(3, out_ch, out_ch, dtype, device)
        self.bn2 = BatchNorm(out_ch, dtype, device)
        if in_ch != out_ch:
            self.proj = _conv_param(1, in_ch, out_ch, dtype, device)
            self.bn_proj = BatchNorm(out_ch, dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        for name in ("conv1", "conv2", "proj"):
            if name in self:
                _conv_init_(self[name], generator)


class ResNet(L.Params):
    """ResNet's parameters, uninitialised (resnet_init fills them from a
    generator; bridge.py copies a JAX param tree in).  head=False leaves
    out the classifier head, as the detector's backbone does."""

    def __init__(self, config: ResNetConfig, device=None, head: bool = True):
        super().__init__()
        self.config = config
        dtype, width = config.dtype, config.width
        self.stem = _conv_param(7, 3, width, dtype, device)
        self.bn_stem = BatchNorm(width, dtype, device)
        self.stages = nn.ModuleList()
        in_ch = width
        for stage, blocks in enumerate(config.stage_sizes):
            out_ch = width * (2 ** stage)
            stage_blocks = nn.ModuleList()
            for _ in range(blocks):
                stage_blocks.append(BasicBlock(in_ch, out_ch, dtype, device))
                in_ch = out_ch
            self.stages.append(stage_blocks)
        if head:
            self.head = L.Linear(in_ch, config.num_classes, True, dtype,
                                 device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        _conv_init_(self.stem, generator)


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> None:
    """Every module's init_ in registration order (the JAX package's
    distributions; its numbers differ, as torch and jax random streams
    do)."""
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)


@torch.no_grad()
def resnet_init(generator: torch.Generator, config: ResNetConfig,
                device=None) -> ResNet:
    """A ResNet with random weights drawn from `generator`.  device=None
    means the CUDA card."""
    model = ResNet(config, device=resolve_device(device))
    init_params_(model, generator)
    return model


@contextlib.contextmanager
def exact_f32(dtype):
    """For an f32 forward, cuDNN's TF32 off while the block runs (the
    reference accumulates f32 products in f32); other dtypes run as
    they are."""
    if dtype != torch.float32:
        yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _block_axes(block):
    axes = {"conv1": (None, None, None, "channels"),
            "bn1": {"scale": ("channels",), "bias": ("channels",)},
            "conv2": (None, None, None, "channels"),
            "bn2": {"scale": ("channels",), "bias": ("channels",)}}
    if "proj" in block:
        axes["proj"] = (None, None, None, "channels")
        axes["bn_proj"] = {"scale": ("channels",), "bias": ("channels",)}
    return axes


def resnet_axes(params):
    """Each parameter's logical axes for a ResNet (a module or its param
    tree; a backbone built without its head has no "head" entry)."""
    axes = {
        "stem": (None, None, None, "channels"),
        "bn_stem": {"scale": ("channels",), "bias": ("channels",)},
        "stages": [[_block_axes(b) for b in stage]
                   for stage in params["stages"]],
    }
    if "head" in params:
        axes["head"] = {"w": ("channels", "vocab"), "b": ("vocab",)}
    return axes


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """The OIHW channels_last form of an HWIO leaf, kept on the leaf and
    rebuilt when the leaf is written in place, moved or cast."""
    key = (w._version, w.data_ptr(), w.dtype)
    cached = getattr(w, "_aiko_oihw", None)
    if cached is None or cached[0] != key:
        cached = (key, w.detach().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last))
        w._aiko_oihw = cached
    return cached[1]


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(w, x, stride: int = 1):
    """SAME conv of NCHW (channels_last) x with an HWIO leaf, in x's
    dtype."""
    kernel = w.shape[0]
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    weight = _oihw(w).to(x.dtype)
    if top == bottom and left == right:
        return F.conv2d(x, weight, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight,
                    stride=stride)


def _max_pool_same(x, kernel: int, stride: int):
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    if top == bottom and left == right:
        return F.max_pool2d(x, kernel, stride, padding=(top, left))
    return F.max_pool2d(F.pad(x, (left, right, top, bottom),
                              value=float("-inf")), kernel, stride)


def _bn(params, x):
    return x * params["scale"].view(1, -1, 1, 1) + \
        params["bias"].view(1, -1, 1, 1)


def _basic_block(params, x, stride: int):
    residual = x
    y = F.relu(_bn(params["bn1"], _conv(params["conv1"], x, stride)))
    y = _bn(params["bn2"], _conv(params["conv2"], y))
    if "proj" in params:
        residual = _bn(params["bn_proj"], _conv(params["proj"], x, stride))
    return F.relu(y + residual)


def resnet_features(params, images):
    """Backbone feature extractor: images [B, H, W, 3] → the feature map
    [B, C, h, w] (channels_last) at the final stage's stride (shared by
    the classifier head here and the detector in models/detector.py)."""
    x = images.permute(0, 3, 1, 2)          # NHWC data as NCHW: no copy
    with exact_f32(x.dtype):
        x = F.relu(_bn(params["bn_stem"], _conv(params["stem"], x, 2)))
        x = _max_pool_same(x, 3, 2)
        for stage, stage_params in enumerate(params["stages"]):
            for i, block in enumerate(stage_params):
                stride = 2 if (stage > 0 and i == 0) else 1
                x = _basic_block(block, x, stride)
    return x


def local_classes(config: ResNetConfig, mesh=None) -> int:
    """This rank's chunk of the classes on the model axis of `mesh`; all
    of them without one.  Classes that do not divide raise ValueError
    (the head is not padded)."""
    return L.model_share(config.num_classes, "num_classes", mesh)


def resnet_forward(params, config: ResNetConfig, images, mesh=None):
    """images: [B, H, W, 3] → logits [B, num_classes] in f32.  mesh:
    this rank's shards (resnet_axes); the logits are the rank's
    contiguous chunk of the classes [B, local_classes]."""
    local_classes(config, mesh)
    x = resnet_features(params, images.to(config.dtype))
    x = x.mean(dim=(2, 3))                  # global avg pool
    head = params["head"]
    return x.float() @ head["w"].float() + head["b"].float()
