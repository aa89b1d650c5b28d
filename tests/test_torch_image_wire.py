"""The port's camera-wire codec (ops/image_wire.py) against the JAX
package's: dct8_encode's codes are byte-equal to JAX's, dct8_decode on
tensors is within 1e-5 of JAX's decode, the codec keeps PSNR above 30 dB
on camera-like frames at a quarter of raw's bytes (as
tests/test_detect.py checks the JAX codec), and misaligned frames
raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import image_wire as JIW
from aiko_services_tpu_torch.ops import image_wire as TIW

torch.set_num_threads(1)


def camera_frame(size=64, seed=0, noise=4.0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 4 * np.pi, size)
    return (127 + 80 * np.sin(x)[:, None, None] * np.cos(x)[None, :, None]
            + rng.normal(0, noise, (size, size, 3))).clip(
                0, 255).astype(np.uint8)


@pytest.mark.parametrize("keep", [16, 10, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_codes_are_jax_bytes(keep, seed):
    for image in (camera_frame(seed=seed),
                  np.random.default_rng(seed).integers(
                      0, 256, (32, 48, 3), dtype=np.uint8)):
        got = TIW.dct8_encode(image, keep=keep)
        want = JIW.dct8_encode(image, keep=keep)
        assert got.dtype == np.int8 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("keep", [16, 10, 64])
def test_decode_matches_jax(keep):
    codes = np.stack([TIW.dct8_encode(camera_frame(seed=s), keep=keep)
                      for s in range(3)])
    want = np.asarray(JIW.dct8_decode(jnp.asarray(codes), 64, 64))
    got = TIW.dct8_decode(torch.from_numpy(codes), 64, 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_round_trip_psnr_and_bytes():
    image = camera_frame()
    codes = TIW.dct8_encode(image)
    assert codes.nbytes == TIW.dct8_wire_bytes(64, 64) == image.nbytes // 4
    assert TIW.dct8_wire_bytes(256, 256) == 49152
    out = TIW.dct8_decode(torch.from_numpy(codes[None]), 64, 64)[0] * 255.0
    mse = np.mean((out.numpy() - image.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 30.0, f"PSNR {psnr:.1f} dB too low"


def test_misaligned_frames_raise():
    image = camera_frame()
    with pytest.raises(ValueError, match="8-aligned"):
        TIW.dct8_encode(image[:60])
    with pytest.raises(ValueError, match="8-aligned"):
        TIW.dct8_encode(image[:, :61])


def test_tables_are_jaxs():
    np.testing.assert_array_equal(TIW._DCT, JIW._DCT)
    np.testing.assert_array_equal(TIW._QUANT, JIW._QUANT)
    np.testing.assert_array_equal(TIW._ZIGZAG, JIW._ZIGZAG)
    assert TIW.DCT_KEEP == JIW.DCT_KEEP
