"""Port parity, the isosurface render: ``eval_normal`` against the JAX
package's (``jax.grad`` for "adjoint", its forward differences for "fd"),
the plain first-hit march ``trace_iso`` (per-ray and lattice) and
``LoadedModel.render_network_iso`` in FUSED, FUSED_BF16 and PLAIN32
against the JAX package's (FUSED in Pallas interpret mode) at atol 1e-4,
the contract of tests/test_inference.py's iso test; CPU tensors, so the
port's FUSED march is the per-segment engine's plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.dvr import max_steps_bound as jmax_steps
from fvsrn_tpu.raytracer.iso import RayEvaluationSteppingIso as JIso
from fvsrn_tpu.raytracer.iso import trace_iso as jtrace_iso
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.raytracer.iso import RayEvaluationSteppingIso, trace_iso
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ATOL = 1e-4
CAM = dict(pitch=0.3, yaw=0.6, distance=1.6)
ISO = dict(stepsize=1 / 32, isovalue=0.5, binary_search_steps=6)


@pytest.fixture(scope="module")
def jnet():
    """The network of tests/test_inference.py's iso test."""
    rng = np.random.default_rng(7)
    latent = JLatent(static_grid=jnp.asarray(
        (rng.standard_normal((8, 8, 8, 8)) * 0.4).astype(np.float32)))
    return JSRN.make(layers="32:32", activation="SnakeAlt:2", num_fourier=6,
                     output_mode="density", latent=latent, seed=7)


def port(jnet):
    return srn_from_arrays(*network_arrays(jnet))


def test_eval_normal_adjoint_matches_jax_grad(jnet):
    rng = np.random.default_rng(1)
    pos = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    want = np.asarray(JVolume.make(jnet).eval_normal(jnp.asarray(pos)))
    got = VolumeInterpolationNetwork(port(jnet)).eval_normal(
        torch.tensor(pos))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_eval_normal_fd_matches_jax(jnet):
    """Forward differences of fd_step = 1e-2: the quotient scales the two
    frameworks' float32 evaluation differences (~1e-7) by 1/fd_step, so
    they agree to 1e-4; both lie within 0.25 of the exact gradient (the
    step's truncation error, 0.11 at most here)."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    want = np.asarray(JVolume.make(jnet, gradient_mode="fd", fd_step=1e-2)
                      .eval_normal(jnp.asarray(pos)))
    vol = VolumeInterpolationNetwork(port(jnet), gradient_mode="fd",
                                     fd_step=1e-2)
    got = vol.eval_normal(torch.tensor(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    exact = np.asarray(JVolume.make(jnet).eval_normal(jnp.asarray(pos)))
    assert np.abs(got - exact).max() < 0.25


@pytest.mark.parametrize("lattice", [False, True])
def test_trace_iso_matches_jax(jnet, lattice):
    rs, rd = jgenerate_rays(JCam.make(**CAM), 16, 16)
    rs = np.asarray(rs).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    steps = jmax_steps((1.0, 1.0, 1.0), ISO["stepsize"])
    want = jtrace_iso(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(jnet),
                      JIso.make(**ISO), steps, lattice=lattice)
    got = trace_iso(torch.tensor(rs), torch.tensor(rd),
                    VolumeInterpolationNetwork(port(jnet)),
                    RayEvaluationSteppingIso.make(**ISO), steps,
                    lattice=lattice)
    assert (np.asarray(want.color)[:, 3] > 0.5).sum() > 10
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               atol=ATOL)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=ATOL)


@pytest.mark.parametrize("mode,size", [("FUSED", (16, 16)),
                                       ("FUSED", (12, 10)),
                                       ("FUSED_BF16", (16, 16)),
                                       ("PLAIN32", (16, 16))])
def test_render_network_iso_matches_jax(jnet, mode, size):
    """12x10 pads the rays to a 128-ray tile (start 0, direction 1, as in
    the JAX package): the padding rays march in the same call."""
    w, h = size
    jtf = JTF.make(rgb=[[1.0, 1.0, 1.0]] * 2, opacity=[0.0, 10.0],
                   positions=[0.0, 1.0])
    want = np.asarray(JLoadedModel(jnet, jtf).render_network_iso(
        JCam.make(**CAM), w, h, JIso.make(**ISO), mode, interpret=True))
    tf = TransferFunctionPiecewiseLinear(torch.tensor(np.asarray(
        jtf.tensor)))
    got = LoadedModel(port(jnet), tf).render_network_iso(
        CameraOnASphere.make(**CAM), w, h,
        RayEvaluationSteppingIso.make(**ISO), mode, device="cpu")
    assert (want[..., 3] > 0.5).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_iso_rejects_curvature_features(jnet):
    """A curvature feature needs ``eval_curvature``, which network volumes
    lack: the render raises ``AttributeError``, as the JAX package's does
    (grids render it: tests/test_torch_volume.py). An unknown feature is
    refused when the configuration is made."""
    rs, rd = jgenerate_rays(JCam.make(**CAM), 4, 4)
    rs = np.asarray(rs).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    tex = np.ones((8, 4), np.float32)
    with pytest.raises(AttributeError):
        jtrace_iso(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(jnet),
                   JIso.make(**ISO, surface_feature="mean",
                             isocontour_texture=jnp.asarray(tex)), 64)
    cfg = RayEvaluationSteppingIso.make(**ISO, surface_feature="mean",
                                        isocontour_texture=tex)
    with pytest.raises(AttributeError):
        trace_iso(torch.tensor(rs), torch.tensor(rd),
                  VolumeInterpolationNetwork(port(jnet)), cfg, 64)
    with pytest.raises(ValueError):
        RayEvaluationSteppingIso.make(surface_feature="bogus")
