"""Port parity, plain ray marcher: ``trace_dvr`` of ``fvsrn_tpu_torch``
against ``fvsrn_tpu`` at 32x32, stepsize 1/64 (CPU, atol 2e-5), in
lattice mode with a per-ray tmax clamp (the fused kernel's oracle) and in
the reference's per-ray mode with the alpha early-out; and its autograd
gradients against ``jax.grad`` of the JAX march (atol 2e-5, rtol 1e-3,
the gradient contract of tests/test_fused.py), with and without
``checkpoint_chunk``; color-output (rgbo) networks, which skip the TF."""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound as jmax_steps
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                           max_steps_bound, trace_dvr)
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ATOL = 2e-5
H = 1 / 64
RGB = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]]
OPACITY = [2.0, 10.0, 30.0]
POSITIONS = [0.0, 0.45, 1.0]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    lat = JLatent(static_grid=(rng.standard_normal((8, 8, 8, 8)) * 0.3)
                  .astype(np.float32))
    jnet = JSRN.make(layers="32:32:32", activation="SnakeAlt:2",
                     num_fourier=6, output_mode="density:direct",
                     latent=lat, seed=7)
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=1.6),
                            32, 32)
    rs = np.asarray(rs).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    clip = rng.uniform(1.0, 2.2, rs.shape[0]).astype(np.float32)
    return jnet, rs, rd, clip


def test_max_steps_bound():
    for box, h in [((1.0, 1.0, 1.0), 1 / 512), ((1.0, 0.5, 2.0), 0.013)]:
        assert max_steps_bound(box, h) == jmax_steps(box, h)


@pytest.mark.parametrize("lattice,early_out,clipped", [
    (True, False, True), (True, True, False), (False, True, False)])
def test_trace_dvr(scene, lattice, early_out, clipped):
    jnet, rs, rd, clip = scene
    steps = jmax_steps((1.0, 1.0, 1.0), H)
    jtf = JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)
    want = jtrace(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(jnet), jtf,
                  JCfg.make(stepsize=H, enable_early_out=early_out), steps,
                  tmax_in=jnp.asarray(clip)[:, None] if clipped else None,
                  lattice=lattice)
    vol = VolumeInterpolationNetwork(srn_from_arrays(*network_arrays(jnet)))
    tf = TransferFunctionPiecewiseLinear.make(RGB, OPACITY, POSITIONS)
    got = trace_dvr(torch.tensor(rs), torch.tensor(rd), vol, tf,
                    RayEvaluationSteppingDvr.make(
                        stepsize=H, enable_early_out=early_out), steps,
                    tmax_in=torch.tensor(clip) if clipped else None,
                    lattice=lattice)
    assert np.asarray(want.color)[:, 3].max() > 0.5
    np.testing.assert_allclose(got.color.detach().numpy(),
                               np.asarray(want.color), atol=ATOL)
    np.testing.assert_allclose(got.depth.detach().numpy(),
                               np.asarray(want.depth), atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 7])
def test_trace_dvr_gradients(scene, chunk):
    """d(sum(w * rgba))/d(every network leaf and the TF), lattice march
    with the clip, no early-out (the fused backward's oracle)."""
    jnet, rs, rd, clip = scene
    n = 256                                    # a 16x16 subset of rays
    rs, rd, clip = rs[:n * 4:4], rd[:n * 4:4], clip[:n * 4:4]
    steps = jmax_steps((1.0, 1.0, 1.0), H)
    w = np.random.default_rng(5).uniform(-1, 1, (n, 4)).astype(np.float32)
    jcfg = JCfg.make(stepsize=H, enable_early_out=False)

    def jloss(net, tf):
        color = jtrace(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(net),
                       tf, jcfg, steps, tmax_in=jnp.asarray(clip)[:, None],
                       lattice=True).color
        return jnp.sum(color * w)

    jtf = JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)
    gnet, gtf = jax.grad(jloss, argnums=(0, 1))(jnet, jtf)
    want, _ = network_arrays(gnet)
    net = srn_from_arrays(*network_arrays(jnet))
    tf = TransferFunctionPiecewiseLinear.make(RGB, OPACITY, POSITIONS)
    tf.tensor.requires_grad_(True)
    color = trace_dvr(torch.tensor(rs), torch.tensor(rd),
                      VolumeInterpolationNetwork(net), tf,
                      RayEvaluationSteppingDvr.make(stepsize=H,
                                                    enable_early_out=False),
                      steps, tmax_in=torch.tensor(clip), lattice=True,
                      checkpoint_chunk=chunk).color
    (color * torch.tensor(w)).sum().backward()
    got = {name: p.grad.numpy() for name, p in net.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.abs(want[name]).max() > 0, name
        np.testing.assert_allclose(got[name], want[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(tf.tensor.grad.numpy(), np.asarray(gtf.tensor),
                               atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("output_mode", ["rgbo", "rgbo:direct"])
def test_trace_dvr_color_output(scene, output_mode):
    """An rgbo network gives each sample its color and absorption o*h, no
    TF: per-ray march with the alpha early-out, as the JAX package."""
    _, rs, rd, _ = scene
    rng = np.random.default_rng(9)
    jnet = JSRN.make(layers="32:32", activation="ReLU", num_fourier=6,
                     output_mode=output_mode,
                     latent=JLatent(static_grid=(rng.standard_normal(
                         (8, 8, 8, 8)) * 0.3).astype(np.float32)), seed=9)
    steps = jmax_steps((1.0, 1.0, 1.0), H)
    jtf = JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)
    want = jtrace(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(jnet), jtf,
                  JCfg.make(stepsize=H), steps)
    vol = VolumeInterpolationNetwork(srn_from_arrays(*network_arrays(jnet)))
    assert vol.outputs_color
    with torch.no_grad():
        got = trace_dvr(torch.tensor(rs), torch.tensor(rd), vol,
                        TransferFunctionPiecewiseLinear.make(
                            RGB, OPACITY, POSITIONS),
                        RayEvaluationSteppingDvr.make(stepsize=H), steps)
    assert np.asarray(want.color)[:, 3].max() > 0.05
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               atol=ATOL)
