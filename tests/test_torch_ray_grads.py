"""Port parity, ray gradients of the megakernel (TPU kernel row 3 with
``want_ray_grads``): the port's plain differentiable march
(``mega_trace_dvr_plain(differentiable=True, ray_grads=True)``, autograd
through the samples' positions, k0 and tmax held constant) against the
JAX megakernel's custom VJP (``mega_trace_dvr(ray_grads=True)`` in Pallas
interpret mode, its footprint certified up front) on JAX's own two cases
(``tests/test_fused.py:1668-1754``), at their tolerances:

- rays and weights: d(loss)/d(ray_start, ray_dir) atol 3e-5 / rtol 1e-3,
  every weight, the Fourier matrix and the latent grid atol 2e-5 / rtol
  1e-3;
- the camera matrix through ``generate_rays``: atol 3e-5 / rtol 1e-3.
  Lattice sampling makes the loss a staircase in the camera (k0 =
  ceil(tmin/h) jumps), so the a.e. derivative is held to JAX's, not to
  finite differences;

and the flag changes no other gradient: the weights', the TF's and the
grid's are the same with and without it, bit for bit; without it the
rays get none (the JAX op's zero cotangent). The CUDA ray-gradient
instances are held against this plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py's phase S. CPU only,
16x16 and 8x8 views, h = 1/32, an 8^3 grid."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import camera_matrix as jcamera_matrix
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.ops.fused_dvr import certify_boxfeat
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.camera import generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops.fused_mega import (mega_trace_dvr,
                                            mega_trace_dvr_plain)
from tools.export_torch_weights import network_arrays

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_mega_grad import BMIN, BSIZE, jax_net  # noqa: E402

torch.set_num_threads(1)
H = 1 / 32
STEPS = max_steps_bound(BSIZE, H)
SEG, TILE = 16, 64
FOV = 0.7853981633974483
RGB = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]]
OPACITY = [2.0, 10.0, 30.0]
POSITIONS = [0.0, 0.45, 1.0]


def jtf():
    return JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)


def scene_rays():
    """JAX's ``_scene`` view: 16x16 rays in row order, four 64-ray
    tiles."""
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=1.6), 16,
                            16)
    return (np.asarray(rs).reshape(-1, 3), np.asarray(rd).reshape(-1, 3))


def port_march(rs, rd, net, ray_grads=True, fn=mega_trace_dvr_plain,
               tf=None, **kw):
    tf = (torch.tensor(np.asarray(jtf().tensor)) if tf is None else tf)
    return fn(rs, rd, net, BMIN, BSIZE, tf, stepsize=H, seg=SEG, tile=TILE,
              enable_early_out=False, differentiable=True,
              ray_grads=ray_grads, table_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def rays_case():
    """JAX's gradients of loss = mean((c - tgt)^2) with respect to the
    rays and the network (``test_mega_ray_gradients_match_plain``)."""
    jnet = jax_net()
    rs, rd = scene_rays()
    tgt = np.random.default_rng(1).random((rs.shape[0], 4)).astype(
        np.float32)
    spec = certify_boxfeat(rs, rd, (8, 8, 8), BMIN, BSIZE, stepsize=H,
                           max_steps=STEPS, seg=SEG, tile=TILE)

    def loss(rs_, rd_, net):
        c = jmega(rs_, rd_, net, BMIN, BSIZE, jtf().tensor, stepsize=H,
                  max_steps=STEPS, seg=SEG, tile=TILE,
                  enable_early_out=False, differentiable=True,
                  ray_grads=True, subbox=spec, interpret=True)
        return jnp.mean((c - tgt) ** 2)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(rs), jnp.asarray(rd),
                                          jnet)
    jgrads, _ = network_arrays(g[2])
    return rs, rd, tgt, np.asarray(g[0]), np.asarray(g[1]), jgrads


def port_ray_grads(rs, rd, tgt, ray_grads=True):
    net = srn_from_arrays(*network_arrays(jax_net()))
    tf = torch.tensor(np.asarray(jtf().tensor), requires_grad=True)
    rs_t = torch.tensor(rs, requires_grad=True)
    rd_t = torch.tensor(rd, requires_grad=True)
    c = port_march(rs_t, rd_t, net, ray_grads, tf=tf)
    ((c - torch.tensor(tgt)) ** 2).mean().backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    grads["tf"] = tf.grad
    return rs_t.grad, rd_t.grad, grads


def test_ray_gradients_match_jax(rays_case):
    """d(loss)/d(ray_start, ray_dir) and the network's gradients."""
    rs, rd, tgt, g_rs, g_rd, jgrads = rays_case
    d_rs, d_rd, grads = port_ray_grads(rs, rd, tgt)
    assert np.abs(g_rs).max() > 1e-4 and np.abs(g_rd).max() > 1e-4
    np.testing.assert_allclose(d_rs.numpy(), g_rs, atol=3e-5, rtol=1e-3)
    np.testing.assert_allclose(d_rd.numpy(), g_rd, atol=3e-5, rtol=1e-3)
    for name in jgrads:
        np.testing.assert_allclose(grads[name].numpy(), jgrads[name],
                                   atol=2e-5, rtol=1e-3, err_msg=name)


def test_ray_flag_changes_no_other_gradient(rays_case):
    """The weights', the TF's and the grid's gradients are the same with
    and without ``ray_grads``; without it the rays get none."""
    rs, rd, tgt = rays_case[:3]
    with_rays = port_ray_grads(rs, rd, tgt, True)
    without = port_ray_grads(rs, rd, tgt, False)
    assert without[0] is None and without[1] is None
    assert with_rays[0] is not None and with_rays[1] is not None
    for name, g in with_rays[2].items():
        assert g.abs().max() > 0, name
        torch.testing.assert_close(g, without[2][name], rtol=0, atol=0)


def test_ray_gradients_wrapper_runs_plain_on_cpu(rays_case):
    """``mega_trace_dvr`` on CPU tensors is its plain version, rays'
    gradients included, bit for bit."""
    rs, rd, tgt = rays_case[:3]
    out = []
    for fn in (mega_trace_dvr, mega_trace_dvr_plain):
        net = srn_from_arrays(*network_arrays(jax_net()))
        rs_t = torch.tensor(rs, requires_grad=True)
        rd_t = torch.tensor(rd, requires_grad=True)
        c = port_march(rs_t, rd_t, net, fn=fn)
        ((c - torch.tensor(tgt)) ** 2).mean().backward()
        out.append((rs_t.grad, rd_t.grad, net.layers[0].weight.grad))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_camera_matrix_gradient_matches_jax():
    """d(loss)/d(camera matrix) through ray generation and the march
    (``test_mega_ray_gradients_camera_matrix``): an 8x8 view, one tile."""
    jnet = jax_net(grid=True)
    m0 = np.asarray(jcamera_matrix(JCam.make(pitch=0.25, yaw=0.7,
                                             distance=1.6)))
    s0, d0 = jgenerate_rays(m0, 8, 8, fov_y_radians=FOV)
    spec = certify_boxfeat(np.asarray(s0).reshape(-1, 3),
                           np.asarray(d0).reshape(-1, 3), (8, 8, 8), BMIN,
                           BSIZE, stepsize=H, max_steps=STEPS, seg=SEG,
                           tile=TILE)

    def loss(m):
        s, d = jgenerate_rays(m, 8, 8, fov_y_radians=FOV)
        c = jmega(s.reshape(-1, 3), d.reshape(-1, 3), jnet, BMIN, BSIZE,
                  jtf().tensor, stepsize=H, max_steps=STEPS, seg=SEG,
                  tile=TILE, enable_early_out=False, differentiable=True,
                  ray_grads=True, subbox=spec, interpret=True)
        return jnp.mean(c ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(m0)))
    m = torch.tensor(m0, requires_grad=True)
    s, d = generate_rays(m, 8, 8, FOV)
    net = srn_from_arrays(*network_arrays(jnet))
    c = port_march(s.reshape(-1, 3), d.reshape(-1, 3), net)
    (c ** 2).mean().backward()
    assert np.abs(want).max() > 1e-4, "the camera gradient vanished"
    np.testing.assert_allclose(m.grad.numpy(), want, atol=3e-5, rtol=1e-3)
