"""Port parity, leaf math: camera, ray/box intersection, activations,
piecewise TF and blending of ``fvsrn_tpu_torch`` against ``fvsrn_tpu``
on the same numpy inputs (CPU, atol 1e-6)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu import blending as jblend
from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import camera_matrix as jcamera_matrix
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.activations import ACTIVATIONS as JACT
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.utils.vecmath import intersect_aabb as jintersect
from fvsrn_tpu_torch import blending
from fvsrn_tpu_torch.camera import (CameraOnASphere, camera_matrix,
                                    generate_rays)
from fvsrn_tpu_torch.models.activations import ACTIVATIONS, parse_activation
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.utils.vecmath import intersect_aabb

torch.set_num_threads(1)
ATOL = 1e-6


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("orientation", ["Ym", "Xp", "Zm"])
@pytest.mark.parametrize("pyd", [(0.3, 0.5, 1.6), (-0.7, 2.1, 2.5)])
def test_camera_matrix_and_rays(orientation, pyd):
    pitch, yaw, dist = pyd
    jc = JCam.make(pitch=pitch, yaw=yaw, distance=dist,
                   orientation=orientation)
    c = CameraOnASphere.make(pitch=pitch, yaw=yaw, distance=dist,
                             orientation=orientation)
    jm = np.asarray(jcamera_matrix(jc))
    m = camera_matrix(c).numpy()
    np.testing.assert_allclose(m, jm, atol=ATOL)
    jrs, jrd = jgenerate_rays(jm, 12, 8, jc.fov_y_radians)
    rs, rd = generate_rays(c, 12, 8, device="cpu")
    assert rs.shape == (1, 8, 12, 3) and rd.shape == (1, 8, 12, 3)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), atol=ATOL)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=ATOL)


def test_intersect_aabb(rng):
    rs = rng.normal(0.0, 1.5, (500, 3)).astype(np.float32)
    rd = rng.normal(0.0, 1.0, (500, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    bmin = np.asarray([-0.5, -0.4, -0.6], np.float32)
    bsz = np.asarray([1.0, 0.8, 1.2], np.float32)
    jt0, jt1 = jintersect(jnp.asarray(rs), jnp.asarray(rd),
                          jnp.asarray(bmin), jnp.asarray(bsz))
    t0, t1 = intersect_aabb(t(rs), t(rd), t(bmin), t(bsz))
    assert t0.shape == (500, 1)
    np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=1e-6,
                               atol=ATOL)
    np.testing.assert_allclose(t1.numpy(), np.asarray(jt1), rtol=1e-6,
                               atol=ATOL)
    hit = (t1.numpy() > t0.numpy()).mean()
    assert 0.1 < hit < 0.9  # both hits and misses exercised


@pytest.mark.parametrize("name", ["SnakeAlt", "Snake", "ReLU", "Sine",
                                  "Sigmoid", "Softplus", "None"])
def test_activations(name, rng):
    x = rng.normal(0.0, 3.0, 1000).astype(np.float32)
    p = 2.0
    want = np.asarray(JACT[name](jnp.asarray(x), p))
    got = ACTIVATIONS[name](t(x), p).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


def test_parse_activation():
    assert parse_activation("SnakeAlt:2") == ("SnakeAlt", 2.0)
    assert parse_activation("ReLU") == ("ReLU", 1.0)
    with pytest.raises(ValueError):
        parse_activation("Nope")


@pytest.mark.parametrize("points", [2, 3, 5])
def test_piecewise_tf(points, rng):
    rgb = rng.random((points, 3)).astype(np.float32)
    op = (rng.random(points) * 30.0).astype(np.float32)
    pos = np.concatenate([[0.0], np.sort(rng.random(points - 2)), [1.0]])
    jtf = JTF.make(rgb=rgb, opacity=op, positions=pos)
    tf = TransferFunctionPiecewiseLinear.make(rgb=rgb.tolist(),
                                              opacity=op.tolist(),
                                              positions=pos.tolist())
    np.testing.assert_array_equal(tf.tensor.numpy(), np.asarray(jtf.tensor))
    d = np.concatenate([rng.uniform(-0.2, 1.2, 400), pos]).astype(np.float32)
    want = np.asarray(jtf.eval_normalized(jnp.asarray(d), None, None, 1 / 64))
    got = tf.eval_normalized(t(d), None, None, 1 / 64).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("mode", [blending.BLEND_BEER_LAMBERT,
                                  blending.BLEND_ALPHA])
def test_blend_step(mode, rng):
    acc_rgb = rng.random((64, 3)).astype(np.float32)
    acc_a = rng.random((64, 1)).astype(np.float32)
    contrib = rng.random((64, 4)).astype(np.float32) * 2.0
    depth = rng.random((64, 1)).astype(np.float32)
    tc = rng.random((64, 1)).astype(np.float32)
    want = jblend.blend_step(jnp.asarray(acc_rgb), jnp.asarray(acc_a),
                             jnp.asarray(contrib), mode,
                             acc_depth=jnp.asarray(depth),
                             contrib_depth=jnp.asarray(tc))
    got = blending.blend_step(t(acc_rgb), t(acc_a), t(contrib), mode,
                              acc_depth=t(depth), contrib_depth=t(tc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
