"""Port parity, image operations (``fvsrn_tpu_torch/utils/imageops.py``
against ``fvsrn_tpu/utils/imageops.py``): flow warping at zero, integer
and random sub-pixel flows that reach past the borders, and pyramid
inpainting on odd sizes, on the same numpy-seeded images, within 1e-6;
and the JAX package's own checks of both (tests/test_aux.py) on the
port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.utils.imageops import inpaint as jinpaint
from fvsrn_tpu.utils.imageops import warp_image as jwarp
from fvsrn_tpu_torch.utils.imageops import inpaint, warp_image

torch.set_num_threads(1)
TOL = 1e-6


def flow_of(kind, rng, h, w):
    if kind == "zero":
        return np.zeros((2, h, w), np.float32)
    if kind == "integer":
        return rng.integers(-3, 4, (2, h, w)).astype(np.float32)
    # sub-pixel, past the borders on every side
    return rng.uniform(-4.5, 4.5, (2, h, w)).astype(np.float32)


@pytest.mark.parametrize("kind", ["zero", "integer", "subpixel"])
def test_warp_matches_jax(kind, rng):
    img = rng.random((3, 9, 14)).astype(np.float32)
    flow = flow_of(kind, rng, 9, 14)
    want = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(flow)))
    got = warp_image(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if kind == "zero":
        np.testing.assert_allclose(got, img, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(1, 16, 16), (3, 13, 17), (2, 1, 9),
                                   (1, 33, 5)])
def test_inpaint_matches_jax(shape, rng):
    c, h, w = shape
    img = rng.random(shape).astype(np.float32)
    mask = (rng.random((h, w)) > 0.4).astype(np.float32)
    want = np.asarray(jinpaint(jnp.asarray(img), jnp.asarray(mask)))
    got = inpaint(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the known pixels pass through
    np.testing.assert_array_equal(got[:, mask > 0], img[:, mask > 0])


def test_warp_shift(rng):
    img = torch.from_numpy(rng.random((1, 6, 6)).astype(np.float32))
    flow = torch.zeros(2, 6, 6)
    flow[0] = 1.0   # sample from x + 1
    out = warp_image(img, flow)
    torch.testing.assert_close(out[0, :, :5], img[0, :, 1:], rtol=0,
                               atol=1e-6)


def test_inpaint_fills_holes():
    img = torch.ones(1, 16, 16) * 0.7
    mask = torch.ones(16, 16)
    mask[4:12, 4:12] = 0.0
    noisy = img.clone()
    noisy[0, 4:12, 4:12] = 99.0   # garbage in the hole
    out = inpaint(noisy, mask)
    assert abs(float(out[0, 0, 0]) - 0.7) <= 1e-5
    assert abs(float(out[0, 8, 8]) - 0.7) <= 1e-3
