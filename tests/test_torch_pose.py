"""Port parity, camera pose recovery (``fvsrn_tpu_torch/train/pose.py``):
``make_pose_render`` against the JAX package's on the same rays-to-image
function (the fixed jitter bit for bit, the supersampled rays within
1e-6), the renders of JAX's oracle scene (tests/test_pose.py: the plain
lattice march of a seeded 32:32:32 SRN with an 8x8^3 grid) within 2e-5,
and ``recover_pose`` on that scene: the JAX test's gates (final cost
below 5% of the start's, pose error below 35% of the perturbation's),
JAX's recovered pose and costs exactly given JAX's render (the first 5
accepted costs within 1e-5 on the port's own), a cost that never rises,
and the true pose a fixed point. CPU only."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
from fvsrn_tpu.train.pose import make_pose_render as jmake_render
from fvsrn_tpu.train.pose import recover_pose as jrecover
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                           max_steps_bound, trace_dvr)
from fvsrn_tpu_torch.train.pose import make_pose_render, recover_pose
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.utils import prng
from tools.export_torch_weights import network_arrays

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_fused import _scene  # noqa: E402

torch.set_num_threads(1)
FOV = 0.7853981633974483
PYD_TRUE = np.asarray([0.3, 0.7, 1.6], np.float32)
PERT = np.asarray([-0.04, 0.05, -0.03], np.float32)
TF = dict(rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
          opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0])


def _renderers(stepsize):
    """(port rays->image, JAX rays->image) of the JAX test's scene: the
    plain lattice march without early-out."""
    jnet, jtf, _, _ = _scene(True, seed=31)
    net = srn_from_arrays(*network_arrays(jnet))
    steps = max_steps_bound((1.0, 1.0, 1.0), stepsize)
    vol = VolumeInterpolationNetwork(net)
    tf = TransferFunctionPiecewiseLinear.make(**TF)
    cfg = RayEvaluationSteppingDvr.make(stepsize=stepsize,
                                        enable_early_out=False)
    jvol = JVol.make(jnet)
    jcfg = JCfg.make(stepsize=stepsize, enable_early_out=False)

    @torch.no_grad()
    def render_rays(s, d):
        return trace_dvr(s, d, vol, tf, cfg, steps, lattice=True).color

    def jrender_rays(s, d):
        return jtrace(s, d, jvol, jtf, jcfg, steps, lattice=True).color

    return render_rays, jax.jit(jrender_rays)


def test_pose_render_matches_jax():
    """The fixed jitter is JAX's uniform bit for bit; the supersampled
    rays (the rays themselves as the 'image') agree to 1e-6, the oracle
    scene's renders to 2e-5, at the true pose and off it."""
    jit = prng.uniform(prng.prng_key(7), (4, 16, 16, 2))
    want = jax.random.uniform(jax.random.PRNGKey(7), (4, 16, 16, 2))
    np.testing.assert_array_equal(jit.numpy(), np.asarray(want))
    rays = make_pose_render(lambda s, d: torch.cat([s, d], dim=1), 16, 16,
                            fov_y_radians=FOV, supersample=4)
    jrays = jmake_render(lambda s, d: jnp.concatenate([s, d], axis=1), 16,
                         16, fov_y_radians=FOV, supersample=4)
    for pyd in (PYD_TRUE, PYD_TRUE + PERT):
        np.testing.assert_allclose(rays(pyd).numpy(),
                                   np.asarray(jrays(jnp.asarray(pyd))),
                                   atol=1e-6)
    render_rays, jrender_rays = _renderers(1 / 32)
    render = make_pose_render(render_rays, 16, 16, fov_y_radians=FOV,
                              supersample=4)
    jrender = jmake_render(jrender_rays, 16, 16, fov_y_radians=FOV,
                           supersample=4)
    for pyd in (PYD_TRUE, PYD_TRUE + PERT):
        img = render(pyd).numpy()
        np.testing.assert_allclose(img, np.asarray(jrender(jnp.asarray(pyd))),
                                   atol=2e-5)
        assert img[:, 3].max() > 0.5


def test_pose_recovery_converges_as_jax():
    """LM with 4x fixed jitter on the oracle scene (16x16, 1/32, 12
    iterations). Given JAX's render, the port's LM recovers JAX's pose
    and costs exactly (its float64 host loop is the JAX package's). End
    to end, each package on its own render: JAX's gates, and the same
    accepted costs (rtol 1e-5) for the first 5 iterations; after those
    the lattice-sampled loss, a staircase in the pose, lets 2e-5 of
    render noise pick another accepted step (the recovered poses then
    differ by ~5e-4 at 12 iterations, both near the true pose)."""
    render_rays, jrender_rays = _renderers(1 / 32)
    render = make_pose_render(render_rays, 16, 16, fov_y_radians=FOV,
                              supersample=4)
    jrender = jmake_render(jrender_rays, 16, 16, fov_y_radians=FOV,
                           supersample=4)
    jtarget = jrender(jnp.asarray(PYD_TRUE))
    jres = jrecover(jrender, jtarget, PYD_TRUE + PERT, iterations=12)
    same = recover_pose(
        lambda p: torch.from_numpy(np.asarray(jrender(jnp.asarray(p)))),
        torch.from_numpy(np.asarray(jtarget)), PYD_TRUE + PERT,
        iterations=12)
    np.testing.assert_allclose(same.pyd, jres.pyd, atol=1e-4, rtol=0)
    assert same.costs == jres.costs
    res = recover_pose(render, render(PYD_TRUE), PYD_TRUE + PERT,
                       iterations=12)
    e0 = float(np.abs(PERT).max())
    e1 = float(np.abs(res.pyd - PYD_TRUE).max())
    assert res.cost < 0.05 * res.cost0, (res.cost0, res.cost)
    assert e1 < 0.35 * e0, (e0, e1)
    np.testing.assert_allclose(res.costs[:6], jres.costs[:6], rtol=1e-5)


def test_pose_recovery_monotone_and_fixed_point():
    """The accepted cost never rises, and the true pose is a fixed point
    (cost 0 stays 0: target and renders share the fixed jitter)."""
    render_rays, _ = _renderers(1 / 16)
    render = make_pose_render(render_rays, 8, 8, fov_y_radians=FOV,
                              supersample=2)
    target = render(PYD_TRUE)
    res = recover_pose(render, target,
                       PYD_TRUE + np.asarray([0.02, -0.02, 0.01]),
                       iterations=4)
    assert all(b <= a + 1e-12 for a, b in zip(res.costs, res.costs[1:]))
    assert res.cost < res.cost0
    res0 = recover_pose(render, target, PYD_TRUE, iterations=2)
    assert res0.cost0 < 1e-10
    np.testing.assert_allclose(res0.pyd, PYD_TRUE, atol=1e-6)
