"""Port parity, the TFs beside the piecewise one, the BRDF and shading in
the plain march (``fvsrn_tpu_torch/transfer.py``, ``brdf.py``,
``raytracer/dvr.py`` with ``need_normals`` and ``brdf``,
``raytracer/evaluator.render_image`` with a BRDF): the port against the
JAX package on the same seeded NumPy inputs.

- ``eval_normalized``, ``max_absorption`` and ``evaluate`` of the
  identity, texture (plain, 1D- and 2D-preintegrated) and Gaussian
  (plain, analytic, gradient-scaled) TFs within 1e-6; the
  preintegration tables within 1e-5 relative.
- ``BRDFLambert.eval`` (Phong with a directional or a point light,
  magnitude scaling, both) within 1e-6.
- ``trace_dvr`` with normals and a BRDF on a voxel grid at 32x32 within
  1e-5: color, blended normal and depth; ``render_image`` with a BRDF.

CPU only, small sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu import transfer as jtransfer
from fvsrn_tpu.brdf import BRDFLambert as JBRDF
from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu.raytracer.evaluator import ImageEvaluatorSimple as JEval
from fvsrn_tpu.volume.grid import VolumeInterpolationGrid as JGrid
from fvsrn_tpu_torch import transfer
from fvsrn_tpu_torch.brdf import BRDFLambert
from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                           max_steps_bound, trace_dvr)
from fvsrn_tpu_torch.raytracer.evaluator import (ImageEvaluatorSimple,
                                                 render_image)
from fvsrn_tpu_torch.volume.grid import VolumeInterpolationGrid

torch.set_num_threads(1)
CPU = "cpu"
CAM = dict(pitch=0.4, yaw=0.7, distance=1.7)
GAUSS = np.array([[1.0, 0.2, 0.2, 6.0, 0.7, 0.08],
                  [0.1, 0.8, 0.3, 3.0, 0.35, 0.15],
                  [0.2, 0.3, 1.0, -1.0, 0.1, 0.05]], np.float32)


def texture_table(r=24, seed=2):
    rng = np.random.default_rng(seed)
    t = rng.random((r, 4)).astype(np.float32)
    t[:, 3] *= 12.0
    return t


def tf_pairs(kind):
    """(JAX TF, port TF) of ``kind``."""
    if kind == "identity":
        return (jtransfer.TransferFunctionIdentity.make(7.0, 1.5),
                transfer.TransferFunctionIdentity.make(7.0, 1.5))
    if kind.startswith("texture"):
        t = texture_table()
        j = jtransfer.TransferFunctionTexture(tensor=t)
        p = transfer.TransferFunctionTexture(torch.from_numpy(t))
        if kind == "texture_pre1d":
            j, p = j.with_preintegration(64), p.with_preintegration(64)
        elif kind == "texture_pre2d":
            j = j.with_preintegration_2d(16, 1 / 64, 8)
            p = p.with_preintegration_2d(16, 1 / 64, 8)
        return j, p
    analytic = kind in ("gaussian_analytic", "gaussian_both")
    scaled = kind in ("gaussian_gradient", "gaussian_both")
    return (jtransfer.TransferFunctionGaussian(
        tensor=GAUSS, analytic=analytic, scale_with_gradient=scaled),
        transfer.TransferFunctionGaussian(
            torch.from_numpy(GAUSS), analytic=analytic,
            scale_with_gradient=scaled))


KINDS = ["identity", "texture", "texture_pre1d", "texture_pre2d",
         "gaussian", "gaussian_analytic", "gaussian_gradient",
         "gaussian_both"]


def tf_inputs(n=3000, seed=4):
    """Densities over [-0.1, 1.1], previous densities with a share of
    "no previous sample" (-1) and of equal pairs, and normals."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    prev = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    prev[::7] = -1.0
    prev[3::11] = d[3::11]
    prev[5::13] = d[5::13] + 5e-4
    normal = rng.standard_normal((n, 3)).astype(np.float32) * 3.0
    return d, prev, normal


@pytest.mark.parametrize("kind", KINDS)
def test_tf_eval_normalized_matches_jax(kind):
    jtf, tf = tf_pairs(kind)
    d, prev, normal = tf_inputs()
    for p in (None, prev):
        want = np.asarray(jtf.eval_normalized(
            jnp.asarray(d), jnp.asarray(normal),
            None if p is None else jnp.asarray(p), 0.03))
        got = tf.eval_normalized(torch.from_numpy(d),
                                 torch.from_numpy(normal),
                                 None if p is None else torch.from_numpy(p),
                                 0.03)
        assert got.shape == (len(d), 4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert float(tf.max_absorption()) == pytest.approx(
        float(jtf.max_absorption()), abs=1e-6)


@pytest.mark.parametrize("kind", ["texture_pre1d", "texture_pre2d"])
def test_preintegration_tables_match_jax(kind):
    jtf, tf = tf_pairs(kind)
    want = np.asarray(jtf.preintegrated)
    got = tf.preintegrated.numpy()
    assert got.shape == want.shape and tf.preintegration_mode == \
        jtf.preintegration_mode
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    moved = tf.to(CPU)
    assert moved.preintegration_mode == tf.preintegration_mode
    np.testing.assert_array_equal(moved.preintegrated.numpy(), got)


@pytest.mark.parametrize("kind", ["identity", "texture_pre1d",
                                  "gaussian_both"])
def test_evaluate_matches_jax(kind):
    """``transfer.evaluate`` on raw densities with previous densities
    and gradients, below-minimum densities zeroed; within 1e-6. The
    analytic Gaussian divides a difference of erfs by the density step
    Delta, and XLA contracts the density mapping's multiply into the TF's
    subtraction (one rounding fewer): that rounding moves the result by
    up to ~|c| 2^-24 / |Delta|, so steps |Delta| < 0.01 are held to
    1e-6 * 0.01 / |Delta|."""
    jtf, tf = tf_pairs(kind)
    d, prev, normal = tf_inputs(1000, seed=6)
    d, prev = d[:, None] * 1.2, prev[:, None] * 1.2
    want = np.asarray(jtransfer.evaluate(
        jtf, jnp.asarray(d), 0.1, 1.1, previous_density=jnp.asarray(prev),
        stepsize=0.05, gradient=jnp.asarray(normal)))
    got = transfer.evaluate(tf, torch.from_numpy(d), 0.1, 1.1,
                            previous_density=torch.from_numpy(prev),
                            stepsize=0.05, gradient=torch.from_numpy(normal))
    step = np.abs(d - prev)
    tol = np.full_like(step, 1e-6)
    if kind == "gaussian_both":
        tol = np.where(step < 0.01, 1e-6 * 0.01 / np.maximum(step, 1e-30),
                       tol)
    assert np.all(np.abs(got.numpy() - want) <= tol), \
        np.abs(got.numpy() - want).max()


def test_gradient_scaled_gaussian_needs_normals():
    _, tf = tf_pairs("gaussian_gradient")
    with pytest.raises(ValueError):
        tf.eval_normalized(torch.zeros(3))


BRDFS = {
    "off": dict(),
    "phong_directional": dict(enable_phong=True, ambient=0.2, specular=0.4,
                              magnitude_center=0.8, magnitude_radius=0.5,
                              light=(0.3, -1.0, -0.5), specular_exponent=8),
    "phong_point": dict(enable_phong=True, ambient=0.1, specular=0.6,
                        magnitude_center=1.5, magnitude_radius=1.0,
                        light=(0.5, 1.5, 1.0), light_type="point",
                        specular_exponent=5),
    "magnitude": dict(enable_magnitude_scaling=True, magnitude_scaling=0.7),
    "both": dict(enable_phong=True, enable_magnitude_scaling=True,
                 magnitude_scaling=2.0, ambient=0.3, specular=0.2,
                 magnitude_center=1.0, magnitude_radius=0.6,
                 light=(0.0, 0.0, -1.0), specular_exponent=16),
}


@pytest.mark.parametrize("name", list(BRDFS))
def test_brdf_eval_matches_jax(name):
    rng = np.random.default_rng(9)
    n = 2000
    rgba = rng.random((n, 4)).astype(np.float32)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    grad = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
    grad[::17] = 0.0
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    want = np.asarray(JBRDF.make(**BRDFS[name]).eval(
        jnp.asarray(rgba), jnp.asarray(pos), jnp.asarray(grad),
        jnp.asarray(rd)))
    got = BRDFLambert.make(**BRDFS[name]).eval(
        *(torch.from_numpy(a) for a in (rgba, pos, grad, rd)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def grid_pair():
    rng = np.random.default_rng(21)
    shape = (10, 12, 14)
    axes = [np.linspace(-1, 1, s) for s in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    f = (0.5 + 0.3 * np.sin(2.1 * x + 0.4) * np.cos(1.7 * y ** 2 - z)
         + 0.2 * z + 0.05 * rng.random(shape))
    f = np.clip(f, 0, 1).astype(np.float32)
    return JGrid.from_grid(jnp.asarray(f)), VolumeInterpolationGrid.from_grid(f)


@pytest.mark.parametrize("tf_kind,brdf", [
    ("piecewise", "phong_directional"), ("piecewise", "both"),
    ("gaussian_gradient", "phong_point"), ("texture_pre1d", "off")])
def test_trace_dvr_normals_and_brdf_on_grid_match_jax(tf_kind, brdf):
    """The plain march with normals fed to the TF and the BRDF on a grid,
    32x32, 1/64: color, blended normal and depth within 1e-5."""
    jg, g = grid_pair()
    if tf_kind == "piecewise":
        kw = dict(rgb=[[0.9, 0.4, 0.1], [0.2, 0.5, 1.0], [1.0, 1.0, 0.6]],
                  opacity=[0.0, 9.0, 25.0], positions=[0.0, 0.5, 1.0])
        jtf = jtransfer.TransferFunctionPiecewiseLinear.make(**kw)
        tf = transfer.TransferFunctionPiecewiseLinear.make(**kw)
    else:
        jtf, tf = tf_pairs(tf_kind)
    cfg = dict(stepsize=1 / 64, density_min=0.05, density_max=1.0,
               need_normals=True)
    rs, rd = generate_rays(CameraOnASphere.make(**CAM), 32, 32, device=CPU)
    rs, rd = rs[0].reshape(-1, 3), rd[0].reshape(-1, 3)
    steps = max_steps_bound(g.box_size.tolist(), 1 / 64)
    want = jtrace_dvr(jnp.asarray(rs.numpy()), jnp.asarray(rd.numpy()), jg,
                      jtf, JCfg.make(**cfg), steps,
                      brdf=JBRDF.make(**BRDFS[brdf]))
    got = trace_dvr(rs, rd, g, tf, RayEvaluationSteppingDvr.make(**cfg),
                    steps, brdf=BRDFLambert.make(**BRDFS[brdf]))
    assert np.asarray(want.color)[:, 3].max() > 0.3
    assert np.abs(np.asarray(want.normal)).max() > 0.1
    for a, b in ((got.color, want.color), (got.normal, want.normal),
                 (got.depth, want.depth)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_trace_dvr_without_normals_has_none():
    _, g = grid_pair()
    rs, rd = generate_rays(CameraOnASphere.make(**CAM), 4, 4, device=CPU)
    out = trace_dvr(rs[0].reshape(-1, 3), rd[0].reshape(-1, 3), g,
                    transfer.TransferFunctionIdentity.make(5.0),
                    RayEvaluationSteppingDvr.make(stepsize=0.05), 40)
    assert out.normal is None and out.color.shape == (16, 4)


def test_render_image_with_brdf_matches_jax():
    """``render_image`` of a grid with a shading BRDF (JAX's
    ``ImageEvaluatorSimple``), 16x16, all eight channels within 1e-5."""
    jg, g = grid_pair()
    cfg = dict(stepsize=1 / 64, need_normals=True)
    jtf, tf = tf_pairs("identity")
    want = np.asarray(JEval(
        camera=JCam.make(**CAM), volume=jg, tf=jtf,
        ray_config=JCfg.make(**cfg),
        brdf=JBRDF.make(**BRDFS["both"])).render(16, 16))
    got = render_image(ImageEvaluatorSimple(
        camera=CameraOnASphere.make(**CAM), volume=g, tf=tf,
        ray_config=RayEvaluationSteppingDvr.make(**cfg),
        brdf=BRDFLambert.make(**BRDFS["both"])), 16, 16, device=CPU)
    assert got.shape == (1, 8, 16, 16) and want[:, 3].max() > 0.3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["texture", "texture_pre1d", "gaussian",
                                  "identity"])
def test_fused_render_refuses_other_tfs(kind):
    """The FUSED render takes the texture TFs (by their preintegration,
    as the JAX package routes them; tests/test_torch_tf_modes.py holds
    the image) and refuses the others with ``NotImplementedError``
    naming the TF mode; the plain march renders every one."""
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    _, tf = tf_pairs(kind)
    net = SceneRepresentationNetwork.make(
        layers="32:32", num_fourier=4, seed=2,
        latent=LatentSpace(static_grid=torch.zeros(4, 8, 8, 8)))
    m = LoadedModel(net, tf, config=RayEvaluationSteppingDvr.make(
        stepsize=1 / 16))
    cam = CameraOnASphere.make(**CAM)
    mode = {"texture_pre1d": "preint1d"}.get(kind, kind)
    if kind.startswith("texture"):
        render = m.prepare_network_render(cam, 16, 16, "FUSED", device=CPU)
        assert render.march_kwargs["tf_mode"] == mode
        img = render()
        assert img.shape == (16, 16, 4) and bool(torch.isfinite(img).all())
    else:
        with pytest.raises(NotImplementedError, match=f"TF mode '{mode}'"):
            m.prepare_network_render(cam, 16, 16, "FUSED", device=CPU)
    img = m.render_network(cam, 16, 16, "PLAIN32", device=CPU)
    assert img.shape == (16, 16, 4) and bool(torch.isfinite(img).all())
