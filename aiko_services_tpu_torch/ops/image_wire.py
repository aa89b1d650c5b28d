# Camera-frame wire codec: 8x8 block DCT, quantized int8, top-K zigzag
# coefficients.
#
# Counterpart of aiko_services_tpu/ops/image_wire.py.  The host runs a
# blockwise DCT and JPEG-style quantization and ships the first K zigzag
# coefficients as int8 (dct8_encode, host numpy: codes byte-identical to
# the JAX package's); the device scatters them back into 8x8 blocks,
# dequantizes and inverts the DCT with two 8x8 products (dct8_decode, on
# tensors on the card), ahead of the consumer's normalisation.  keep=16 is
# 4x fewer bytes on the host-to-device hop than raw uint8; keep=10, 6.4x.

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dct8_encode", "dct8_decode", "dct8_wire_bytes", "DCT_KEEP"]

DCT_KEEP = 16                    # default coefficients kept per block


def _dct_basis() -> np.ndarray:
    """Orthonormal 8x8 DCT-II basis: Y = D @ X @ D.T."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    basis = np.cos((2 * n + 1) * k * np.pi / 16.0)
    basis[0] *= np.sqrt(1.0 / 2.0)
    return (basis * np.sqrt(2.0 / 8.0)).astype(np.float32)


_DCT = _dct_basis()

# JPEG Annex K luminance quantization (quality ~50), shared across
# channels
_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)


def _zigzag_order() -> np.ndarray:
    """Indices of the 64 block positions in zigzag scan order."""
    order = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[1] if (p[0] + p[1]) % 2 else p[0]))
    return np.array([i * 8 + j for i, j in order], np.int32)


_ZIGZAG = _zigzag_order()


def dct8_wire_bytes(height: int, width: int, channels: int = 3,
                    keep: int = DCT_KEEP) -> int:
    return (height // 8) * (width // 8) * channels * keep


def dct8_encode(image: np.ndarray, keep: int = DCT_KEEP) -> np.ndarray:
    """uint8 [H, W, C] (H, W multiples of 8) -> int8
    [H/8, W/8, C, keep] quantized zigzag DCT coefficients."""
    h, w, c = image.shape
    if h % 8 or w % 8:
        raise ValueError(f"dct8 needs 8-aligned frames, got {h}x{w}")
    x = image.astype(np.float32) - 128.0
    blocks = x.reshape(h // 8, 8, w // 8, 8, c).transpose(0, 2, 4, 1, 3)
    coeffs = np.einsum("ki,bwcij,lj->bwckl", _DCT, blocks, _DCT,
                       optimize=True)
    quantized = np.round(coeffs / _QUANT).reshape(
        h // 8, w // 8, c, 64)[..., _ZIGZAG[:keep]]
    return np.clip(quantized, -127, 127).astype(np.int8)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device):
    """The basis, the quantization table and the zigzag order on one
    device, sent once: a copy from pageable host memory would wait for
    the stream on every call."""
    return (torch.from_numpy(_DCT).to(device),
            torch.from_numpy(_QUANT).to(device),
            torch.from_numpy(_ZIGZAG.astype(np.int64)).to(device))


def dct8_decode(codes: torch.Tensor, height: int, width: int):
    """int8 [B, H/8, W/8, C, keep] -> float32 [B, H, W, C] in [0, 1], on
    the codes' device: scatter the zigzag coefficients, dequantize, two
    8x8 products (D.T @ coeffs @ D), then clip and divide by 255."""
    batch, hb, wb, channels, keep = codes.shape
    dct, quant, zigzag = _constants(codes.device)
    flat = torch.zeros((batch, hb, wb, channels, 64), dtype=torch.float32,
                       device=codes.device)
    flat[..., zigzag[:keep]] = codes.float()
    coeffs = flat.view(batch, hb, wb, channels, 8, 8) * quant
    blocks = dct.T @ coeffs @ dct
    image = (blocks + 128.0).permute(0, 1, 4, 2, 5, 3).reshape(
        batch, height, width, channels)
    return torch.clamp(image, 0.0, 255.0) / 255.0
