# Object detector: anchor-free center-point detection in PyTorch.
#
# Counterpart of aiko_services_tpu/models/detector.py (BASELINE.md config
# 4, "gstreamer video → YOLOv8 detect → tracker"): a ResNet backbone, a
# 3x3 neck and three 3x3 conv heads (class heatmap, box size, center
# offset), CenterNet-style; decode is 3x3 max-pool peak detection and a
# top-k, with static shapes.  Parameter names are the JAX tree's paths
# joined by '.' (backbone.stages.0.0.conv1, neck, head_heat, ...), conv
# leaves HWIO (models/resnet.py).
#
# detect() keeps everything after the forward in f32 on the device, with
# no host sync: sigmoid, peak pooling, top-k, the gather, tanh and the
# box arithmetic.  Two JAX semantics are spelled out:
#   * the heatmap is flattened NHWC ([B, h, w, C], class fastest) before
#     the top-k, so cell = idx // C and class = idx % C as in JAX;
#   * jax.lax.top_k puts the lower index first among equal values
#     (saturated sigmoids tie at 1.0); torch.topk promises no order, so
#     the top-k is a stable descending sort.

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device, torch_dtype
from . import layers as L
from .resnet import (BatchNorm, ResNet, ResNetConfig, _bn, _conv,
                     _conv_init_, _conv_param, exact_f32, init_params_,
                     resnet_features)

__all__ = ["DetectorConfig", "Detector", "detector_init", "detector_axes",
           "detector_forward", "detect", "top_k_stable", "DETECTOR_PRESETS"]


@dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 80
    backbone: ResNetConfig = ResNetConfig(stage_sizes=(2, 2, 2, 2),
                                          num_classes=1)
    head_channels: int = 64
    max_detections: int = 32
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        backbone = self.backbone
        if not isinstance(backbone, ResNetConfig):
            # the JAX config's backbone: the same fields
            backbone = ResNetConfig(**{
                field.name: getattr(backbone, field.name)
                for field in dataclasses.fields(ResNetConfig)})
            object.__setattr__(self, "backbone", backbone)


DETECTOR_PRESETS = {
    "detector_r18": DetectorConfig(),
    # CI/smoke geometry
    "detector_test": DetectorConfig(
        num_classes=4,
        backbone=ResNetConfig(stage_sizes=(1, 1), num_classes=1, width=8),
        head_channels=8, max_detections=8),
}


class Detector(L.Params):
    """The detector's parameters, uninitialised (detector_init fills
    them; bridge.py copies a JAX param tree in)."""

    def __init__(self, config: DetectorConfig, device=None):
        super().__init__()
        self.config = config
        dtype, ch = config.dtype, config.head_channels
        self.backbone = ResNet(config.backbone, device=device, head=False)
        feature_ch = config.backbone.width * \
            (2 ** (len(config.backbone.stage_sizes) - 1))
        self.neck = _conv_param(3, feature_ch, ch, dtype, device)
        self.bn_neck = BatchNorm(ch, dtype, device)
        self.head_heat = _conv_param(3, ch, config.num_classes, dtype,
                                     device)
        self.head_size = _conv_param(3, ch, 2, dtype, device)
        self.head_offset = _conv_param(3, ch, 2, dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        for name in ("neck", "head_heat", "head_size", "head_offset"):
            _conv_init_(self[name], generator)


@torch.no_grad()
def detector_init(generator: torch.Generator, config: DetectorConfig,
                  device=None) -> Detector:
    """A Detector with random weights drawn from `generator`.
    device=None means the CUDA card."""
    model = Detector(config, device=resolve_device(device))
    init_params_(model, generator)
    return model


def detector_axes(params):
    """Each parameter's logical axes, shaped like the JAX param tree."""
    from .resnet import resnet_axes
    return {
        "backbone": resnet_axes(params["backbone"]),
        "neck": (None, None, None, "channels"),
        "bn_neck": {"scale": ("channels",), "bias": ("channels",)},
        "head_heat": (None, None, None, None),
        "head_size": (None, None, None, None),
        "head_offset": (None, None, None, None),
    }


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def detector_forward(params, config: DetectorConfig, images):
    """images [B, H, W, 3] → (heatmap [B, h, w, C] logits,
    sizes [B, h, w, 2], offsets [B, h, w, 2]) at backbone stride."""
    x = images.to(config.dtype)
    features = resnet_features(params["backbone"], x)
    with exact_f32(config.dtype):
        neck = F.relu(_bn(params["bn_neck"],
                          _conv(params["neck"], features)))
        heatmap = _conv(params["head_heat"], neck)
        # F.softplus is linear above its threshold (20) where
        # jax.nn.softplus is log(1 + exp(x)): below 1e-8 apart in f32
        sizes = F.softplus(_conv(params["head_size"], neck))
        offsets = _conv(params["head_offset"], neck)
    return _nhwc(heatmap), _nhwc(sizes), _nhwc(offsets)


def top_k_stable(values, k: int):
    """jax.lax.top_k over the last dim: the k largest, descending, the
    lower index first among equal values."""
    ordered, index = torch.sort(values, dim=-1, descending=True,
                                stable=True)
    return ordered[..., :k], index[..., :k]


def detect(params, config: DetectorConfig, images,
           score_threshold: float = 0.3):
    """Full detection: forward + peak decode.  Returns
    (boxes [B, K, 4] f32 in input pixels (x1, y1, x2, y2), scores [B, K]
    f32, classes [B, K] int32) with K = config.max_detections,
    zero-padded (class -1)."""
    heatmap, sizes, offsets = detector_forward(params, config, images)
    b, h, w, c = heatmap.shape
    stride = images.shape[1] // h
    scores_map = torch.sigmoid(heatmap.float())

    # peaks: a cell survives when it equals its 3x3 neighbourhood max
    # (a symmetric 3x3 / 1 window: max_pool2d's -inf padding is SAME's)
    pooled = _nhwc(F.max_pool2d(scores_map.permute(0, 3, 1, 2), 3, 1, 1))
    peaks = torch.where(scores_map == pooled, scores_map, 0.0)

    flat = peaks.reshape(b, h * w * c)
    k = min(config.max_detections, h * w * c)
    top_scores, top_idx = top_k_stable(flat, k)
    cell = top_idx // c
    classes = (top_idx % c).to(torch.int32)
    ys = (cell // w).float()
    xs = (cell % w).float()

    def gather_hw(grid):
        # f32 regression regardless of backbone dtype
        flat_grid = grid.float().reshape(b, h * w, grid.shape[-1])
        return torch.gather(flat_grid, 1, cell[..., None].expand(
            b, k, grid.shape[-1]))

    size = gather_hw(sizes)                          # [B, K, 2] in cells
    offset = torch.tanh(gather_hw(offsets))          # [-1,1] cell units

    cx = (xs + 0.5 + offset[..., 0]) * stride
    cy = (ys + 0.5 + offset[..., 1]) * stride
    half_w = size[..., 0] * stride * 0.5
    half_h = size[..., 1] * stride * 0.5
    boxes = torch.stack([cx - half_w, cy - half_h,
                         cx + half_w, cy + half_h], dim=-1)
    # suppressed cells carry exactly 0.0 after the peak mask: require a
    # strictly positive score so padding rows stay zero at threshold <= 0
    keep = (top_scores >= score_threshold) & (top_scores > 0.0)
    boxes = torch.where(keep[..., None], boxes, 0.0)
    scores = torch.where(keep, top_scores, 0.0)
    classes = torch.where(keep, classes, -1)
    return boxes, scores, classes
