"""Port parity, normals and shading of the fused marches (TPU kernel rows 1
and 4 with ``need_normals`` and a ``brdf``; row 7's gradient inside the
Monte-Carlo walk): the port's ``fused_trace_dvr`` and ``mega_trace_dvr``
(their plain versions here, on the CPU) against the JAX package's plain
oracle ``trace_dvr`` with ``need_normals`` on the same numpy inputs,
within the JAX package's own gates for its kernels (tests/test_fused.py:
colour 1e-4 unshaded and 2e-4 shaded, normal 5e-4, depth 1e-4); the
refusals JAX makes; the MC walk with a gradient-scaled Gaussian against
JAX's on the same key; and the gradient-network evaluation against the
JAX script's steps at a tiny size. The CUDA kernels are held against
these plain versions on the card by tests/test_torch_kernels.py."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.brdf import BRDFLambert as JBRDF
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer import montecarlo as jmc
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
from fvsrn_tpu.transfer import TransferFunctionGaussian as JGauss
from fvsrn_tpu_torch.brdf import BRDFLambert
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.ops import fused_eval
from fvsrn_tpu_torch.ops.fused_dvr import (fused_trace_dvr,
                                           fused_trace_dvr_bucketed,
                                           plan_ray_buckets)
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr
from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
from fvsrn_tpu_torch.raytracer import montecarlo as tmc
from fvsrn_tpu_torch.transfer import TransferFunctionGaussian
from fvsrn_tpu_torch.utils import prng
from fvsrn_tpu_torch.utils.vecmath import intersect_aabb
from tests.test_torch_segment import (BMIN, BSIZE, RAMP, jnet_of, port,
                                      rays16, t, tfs)

torch.set_num_threads(1)
H = 1 / 64
STEPS = 112
SEG, TILE = 16, 64
TOL = dict(color=1e-4, color_shaded=2e-4, normal=5e-4, depth=1e-4)
# the JAX tests' BRDF (tests/test_fused.py:345), and a point light
PHONG = dict(enable_phong=True, ambient=0.2, specular=0.3,
             magnitude_center=0.02, magnitude_radius=0.02,
             light=(0.3, -0.5, -1.0))
BRDFS = {
    None: None,
    "phong": PHONG,
    "point": dict(PHONG, light=(0.8, 1.2, -1.5), light_type="point",
                  specular_exponent=5),
    "magnitude": dict(PHONG, enable_magnitude_scaling=True,
                      magnitude_scaling=200.0),
}


def brdfs(name):
    spec = BRDFS[name]
    if spec is None:
        return None, None
    return JBRDF.make(**spec), BRDFLambert.make(**spec)


def bf16_grid(jnet):
    """``jnet`` with its latent grid rounded to bf16: the JAX oracle of a
    march that reads the grid from a bf16 table."""
    grid = jnp.asarray(jnet.latent.static_grid, jnp.bfloat16).astype(
        jnp.float32)
    return dataclasses.replace(jnet, latent=dataclasses.replace(
        jnet.latent, static_grid=grid))


def oracle(jnet, brdf, lattice):
    rs, rd = rays16()
    cfg = JCfg.make(stepsize=H, enable_early_out=False, need_normals=True)
    jtf, _ = tfs(RAMP)
    return jtrace(jnp.asarray(rs), jnp.asarray(rd), JVol.make(jnet), jtf,
                  cfg, STEPS, brdf=brdf, lattice=lattice)


def assert_matches(got, want, shaded):
    for field in ("color", "normal", "depth"):
        tol = TOL["color_shaded" if field == "color" and shaded else field]
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=tol, err_msg=field)
    assert np.abs(np.asarray(want.normal)).max() > 0.1
    assert np.asarray(want.color)[:, 3].max() > 0.1


CASES = {
    "per_ray": dict(),
    "per_ray_phong": dict(brdf="phong"),
    "per_ray_point": dict(brdf="point"),
    "per_ray_magnitude": dict(brdf="magnitude"),
    "lattice": dict(lattice=True),
    "lattice_phong": dict(lattice=True, brdf="phong"),
    "direction_phong": dict(net=dict(direction=True, output_mode="density"),
                            brdf="phong"),
    "relu_point": dict(net=dict(activation="ReLU"), brdf="point"),
    "sigmoid_head": dict(net=dict(output_mode="density"), brdf="phong"),
    "bf16_table_phong": dict(bf16=True, brdf="phong"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_normals_match_jax_oracle(case):
    """The per-segment engine (row 4) with normals, per-ray or lattice
    sampling (``latent_mode="boxfeat"``), against ``trace_dvr``; a bf16
    table against the oracle of the bf16-rounded grid."""
    spec = CASES[case]
    jnet = jnet_of(**spec.get("net", {}))
    jb, b = brdfs(spec.get("brdf"))
    bf16 = spec.get("bf16", False)
    want = oracle(bf16_grid(jnet) if bf16 else jnet, jb,
                  spec.get("lattice", False))
    rs, rd = rays16()
    got = fused_trace_dvr(
        t(rs), t(rd), port(jnet), BMIN, BSIZE, tfs(RAMP)[1].tensor,
        stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE,
        enable_early_out=False, need_normals=True, brdf=b,
        table_dtype=torch.bfloat16 if bf16 else torch.float32,
        latent_mode="boxfeat" if spec.get("lattice") else "table")
    assert_matches(got, want, b is not None)


MEGA_CASES = {
    "f32": dict(),
    "f32_phong": dict(brdf="phong"),
    "f32_point_magnitude": dict(brdf="magnitude"),
    "bf16_phong": dict(bf16=True, brdf="phong"),
    "direction_point": dict(net=dict(direction=True, output_mode="density"),
                            brdf="point"),
    "relu_phong": dict(net=dict(activation="ReLU"), brdf="phong"),
}


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_mega_normals_match_jax_oracle(case):
    """The megakernel (row 1) with normals against the lattice oracle: a
    float32 table (JAX's default) and the render's bf16 table against the
    oracle of the bf16-rounded grid."""
    spec = MEGA_CASES[case]
    jnet = jnet_of(**spec.get("net", {}))
    jb, b = brdfs(spec.get("brdf"))
    bf16 = spec.get("bf16", False)
    want = oracle(bf16_grid(jnet) if bf16 else jnet, jb, True)
    rs, rd = rays16()
    got = mega_trace_dvr(
        t(rs), t(rd), port(jnet), BMIN, BSIZE, tfs(RAMP)[1].tensor,
        stepsize=H, seg=SEG, tile=TILE, enable_early_out=False,
        need_normals=True, brdf=b,
        table_dtype=torch.bfloat16 if bf16 else torch.float32)
    assert_matches(got, want, b is not None)


@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_bucketed_normals_match_jax_oracle(engine):
    """The bucketed route forwards ``need_normals`` and ``brdf`` and
    reassembles every field of the output in the input order."""
    jnet = jnet_of()
    jb, b = brdfs("phong")
    want = oracle(jnet, jb, True)
    rs, rd = rays16()
    plan = plan_ray_buckets(rs, rd, BMIN, BSIZE, stepsize=H, seg=SEG,
                            tile=TILE, n_buckets=2, grid_sizes=(8, 8, 8))
    kw = dict(latent_mode="boxfeat") if engine == "scan" else dict(
        table_dtype=torch.float32)
    got = fused_trace_dvr_bucketed(
        t(rs), t(rd), port(jnet), BMIN, BSIZE, tfs(RAMP)[1].tensor,
        plan=plan, engine=engine, stepsize=H, seg=SEG, tile=TILE,
        enable_early_out=False, need_normals=True, brdf=b, **kw)
    assert_matches(got, want, True)


def test_shading_changes_the_image():
    """Shading moves the colour; the unshaded call returns rgba alone."""
    rs, rd = rays16()
    net = port(jnet_of())
    kw = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE,
              enable_early_out=False)
    plain = fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE,
                            tfs(RAMP)[1].tensor, **kw)
    shaded = fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE,
                             tfs(RAMP)[1].tensor, need_normals=True,
                             brdf=brdfs("phong")[1], **kw)
    assert isinstance(plain, torch.Tensor)
    assert float((shaded.color - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("kw,error", [
    (dict(differentiable=True), NotImplementedError),
    (dict(net="rgbo"), ValueError),
    (dict(need_normals=False, brdf="phong"), ValueError),
])
def test_mega_refuses_normals_as_jax(kw, error):
    """mega_trace_dvr raises where the JAX megakernel raises: normals in
    the differentiable march, normals of an rgbo head, a shading BRDF
    without normals."""
    kw = {"need_normals": True, **kw}
    net = port(jnet_of(output_mode="rgbo" if kw.pop("net", None) else
                       "density:direct"))
    kw["brdf"] = brdfs(kw.get("brdf"))[1]
    rs, rd = rays16()
    with pytest.raises(error):
        mega_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tfs(RAMP)[1].tensor,
                       stepsize=H, seg=SEG, tile=TILE, **kw)


# ---------------------------------------------------------------------------
# the Monte-Carlo walk's in-loop normals

# densities of the scene lie in [0.46, 0.51] and |grad| ~ 0.05-0.2, so the
# gradient-scaled widths sigma max(1e-5, 0.1 |grad|) are ~0.01-0.05
GAUSS = np.array([[0.9, 0.3, 0.2, 8.0, 0.485, 2.0],
                  [0.2, 0.8, 0.9, 6.0, 0.47, 3.0]], np.float32)
MC = dict(max_absorption=14.0, num_bounces=1, max_iterations=64)


class GaussScene:
    """A seeded 32:32 SnakeAlt:2 SRN with a sigmoid density head and an
    8x8^3 grid (most rays interact, tests/test_torch_mc.py), and a
    gradient-scaled two-Gaussian TF, in both packages."""

    def __init__(self):
        from fvsrn_tpu.camera import CameraOnASphere as JCam
        from fvsrn_tpu.camera import generate_rays as jgen
        from fvsrn_tpu_torch.convert import srn_from_arrays
        from tools.export_torch_weights import network_arrays
        rng = np.random.default_rng(23)
        grid = (rng.standard_normal((8, 8, 8, 8)) * 0.3).astype(np.float32)
        self.jnet = JSRN.make(layers="32:32", activation="SnakeAlt:2",
                              num_fourier=6, output_mode="density",
                              latent=JLatent(static_grid=jnp.asarray(grid)),
                              seed=23)
        self.net = srn_from_arrays(*network_arrays(self.jnet))
        self.jtf = JGauss(tensor=jnp.asarray(GAUSS), scale_with_gradient=True)
        self.tf = TransferFunctionGaussian(torch.from_numpy(GAUSS),
                                           scale_with_gradient=True)
        self.jcfg = jmc.RayEvaluationMonteCarlo.make(**MC)
        self.cfg = tmc.RayEvaluationMonteCarlo.make(**MC)
        s, d = jgen(JCam.make(pitch=0.3, yaw=0.8, distance=1.6), 16, 16)
        self.rs = np.array(s).reshape(-1, 3)
        self.rd = np.array(d).reshape(-1, 3)

    def vols(self, mode):
        """Both volumes; forward differences of 1e-2: the TF's Gaussian
        width follows |grad|, so at 1e-3 the float32 noise of the two
        packages' densities (~3e-8 over the step) moves a hit's colour by
        up to 8e-3."""
        return (JVol.make(self.jnet, gradient_mode=mode, fd_step=1e-2),
                VolumeInterpolationNetwork(self.net, gradient_mode=mode,
                                           fd_step=1e-2))


@pytest.fixture(scope="module")
def gauss():
    return GaussScene()


def assert_walks_close(got, want):
    """At least 98% of the rays within 1e-3, those within 1e-3 (the MC
    contract of tests/test_torch_mc.py)."""
    got = np.asarray(got).reshape(len(want), -1)
    want = np.asarray(want).reshape(len(want), -1)
    close = np.all(np.abs(got - want) < 1e-3, axis=-1)
    assert close.mean() >= 0.98, f"{(~close).sum()} rays diverged"
    np.testing.assert_allclose(got[close], want[close], atol=1e-3)


@pytest.mark.parametrize("mode", ["adjoint", "fd"])
def test_delta_tracking_gradient_scaled_gaussian_matches_jax(gauss, mode):
    """The walk evaluates each tentative collision's normal for the TF
    and records the hit's own: t_out, hit position, colour and normal
    against JAX's walk on the same key."""
    jvol, vol = gauss.vols(mode)
    rs, rd = torch.from_numpy(gauss.rs), torch.from_numpy(gauss.rd)
    tmin, _ = intersect_aabb(rs, rd, vol.box_min, vol.box_size)
    start = rs + torch.clamp(tmin, min=0.0) * rd
    got = tmc.delta_tracking(prng.prng_key(5), start, rd, vol, gauss.tf,
                             gauss.cfg)
    want = jmc.delta_tracking(jax.random.PRNGKey(5),
                              jnp.asarray(start.numpy()),
                              jnp.asarray(gauss.rd), jvol, gauss.jtf,
                              gauss.jcfg)
    hits = float((got.t_out > 0).float().mean())
    assert 0.3 < hits < 1.0
    assert float(got.hit_normal.abs().max()) > 0.1
    assert_walks_close(np.concatenate([np.asarray(v).reshape(len(v), -1)
                                       for v in got], 1),
                       np.concatenate([np.asarray(v).reshape(len(v), -1)
                                       for v in want], 1))


@pytest.mark.parametrize("mode", ["adjoint", "fd"])
def test_trace_mc_gradient_scaled_gaussian(gauss, mode, monkeypatch):
    """trace_mc with the gradient-scaled Gaussian, plain and through the
    fused sampler (its plain version here), against JAX's trace_mc on the
    same key; with adjoint normals each camera-walk round asks the
    sampler once for values and gradients (row 7's gradient instance on
    the card), with fd normals at the three offsets besides."""
    jvol, vol = gauss.vols(mode)
    rs, rd = torch.from_numpy(gauss.rs), torch.from_numpy(gauss.rd)
    hg = PhaseFunctionHenyeyGreenstein.make(g=0.3)
    calls = {True: 0, False: 0}
    real = fused_eval.fused_eval_plain

    def counted(*a, want_grad=False, **k):
        calls[want_grad] += 1
        return real(*a, want_grad=want_grad, **k)

    monkeypatch.setattr(fused_eval, "fused_eval_plain", counted)
    plain = tmc.trace_mc(prng.prng_key(42), rs, rd, vol, gauss.tf, hg,
                         gauss.cfg)
    assert calls == {True: 0, False: 0}
    rounds = tmc.TRACKING_ROUNDS
    fused = tmc.trace_mc(prng.prng_key(42), rs, rd, vol, gauss.tf, hg,
                         gauss.cfg, use_fused=True)
    rounds = tmc.TRACKING_ROUNDS - rounds
    from fvsrn_tpu.phase import PhaseFunctionHenyeyGreenstein as JHG
    want = jmc.trace_mc(jax.random.PRNGKey(42), jnp.asarray(gauss.rs),
                        jnp.asarray(gauss.rd), jvol, gauss.jtf,
                        JHG.make(g=0.3), gauss.jcfg)
    assert 0.3 < float(plain.color[:, 3].mean()) < 1.0
    for got in (plain, fused):
        assert_walks_close(got.color, want.color)
        assert_walks_close(torch.cat([got.normal, got.depth], 1),
                           np.concatenate([np.asarray(want.normal),
                                           np.asarray(want.depth)], 1))
    if mode == "adjoint":
        # camera-walk rounds launch the gradient instance, shadow-walk
        # rounds the values
        assert calls[True] > 0 and calls[True] + calls[False] == rounds
    else:
        assert calls[True] == 0 and calls[False] > rounds


# ---------------------------------------------------------------------------
# the gradient-network evaluation


def test_eval_gradient_networks_matches_jax_script(tmp_path):
    """The port's eval (1 epoch of world training on 1024 samples) against
    the JAX script's steps on the JAX-trained network: the normal rows
    (adjoint and fd) and the shaded render at 16x16 against the JAX
    script's plain oracle (trace_dvr in lattice mode)."""
    from fvsrn_tpu.brdf import BRDFLambert as JB
    from fvsrn_tpu.camera import CameraOnASphere as JCam
    from fvsrn_tpu.camera import generate_rays as jgen
    from fvsrn_tpu.eval.sweep import default_options as jdefaults
    from fvsrn_tpu.train.main import _resolve_scene as jresolve
    from fvsrn_tpu.train.main import run as jrun
    from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
    from fvsrn_tpu.utils.vecmath import safe_normalize as jsafe
    from fvsrn_tpu_torch.eval import eval_gradient_networks as ev
    from fvsrn_tpu_torch.eval.sweep import default_options
    from fvsrn_tpu_torch.train.main import _resolve_scene, run

    scene = "IMPLICIT:MARSCHNER_LOBB"
    small = dict(epochs=1, samples=1024, volumetric_features_channels=8,
                 volumetric_features_resolution=16, layers="16:16",
                 fouriercount=4, batch_size=256)
    jopt = jdefaults(scene, str(tmp_path / "j.hdf5"))
    jopt.update(small)
    jnet = jrun(jopt)["network"]
    opt = default_options(scene, str(tmp_path / "p.npz"))
    opt.update(small, device="cpu")
    net = run(opt)["network"]

    volume, _, _ = _resolve_scene(scene)
    rows = ev.normal_rows(net, volume, eval_samples=512, fd_step=1e-3,
                          device="cpu")
    jvolume, _, _ = jresolve(scene)
    pos01 = jax.random.uniform(jax.random.PRNGKey(123), (512, 3),
                               minval=0.05, maxval=0.95)
    world = jvolume.box_min + pos01 * jvolume.box_size
    ref_n = jsafe(jvolume.eval_normal(world))
    for row in rows:
        nv = JVol.make(jnet, gradient_mode=row["mode"], fd_step=1e-3)
        got = jsafe(nv.eval_normal(world))
        assert row["mean_cosine"] == pytest.approx(
            float(jnp.mean(jnp.sum(got * ref_n, -1))), abs=2e-3)
        assert row["l2"] == pytest.approx(
            float(jnp.mean(jnp.sum((got - ref_n) ** 2, -1))), abs=4e-3)

    out = ev.shaded_render(net, size=16, device="cpu")
    rs, rd = jgen(JCam.make(pitch=0.35, yaw=0.8, distance=1.6), 16, 16)
    jtf = JTF.make(rgb=[[0.9, 0.6, 0.3], [0.4, 0.6, 1.0]],
                   opacity=[2.0, 20.0], positions=[0.0, 1.0])
    cfg = JCfg.make(stepsize=1 / 128, enable_early_out=False,
                    need_normals=True)
    want = jtrace(jnp.reshape(rs, (-1, 3)), jnp.reshape(rd, (-1, 3)),
                  JVol.make(jnet), jtf, cfg,
                  max_steps_bound((1.0, 1.0, 1.0), 1 / 128),
                  brdf=JB.make(light=(0.3, -0.8, 0.5), ambient=0.3),
                  lattice=True).color
    assert out["fused"].shape == (256, 4) and out["ssim"] > 0.99
    np.testing.assert_allclose(out["fused"].numpy(), np.asarray(want),
                               rtol=0, atol=1e-3)
    assert float(np.asarray(want)[:, 3].max()) > 0.1
