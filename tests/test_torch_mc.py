"""Port parity, Monte-Carlo path tracing (raytracer/montecarlo.py, the
caller of TPU kernel row 7) with its phase functions, spherical harmonics
and image evaluator: the port against the JAX package on the same seeded
SRN, rays and keys. A draw that goes through log/cos/sqrt may differ from
XLA's by an ulp and flip a knife-edge collision, so walks are held to the
JAX package's contract (tests/test_fused_eval.py): at least 98% of the
rays within 1e-3, and those within 1e-3. The schedule options
(compaction, steps per round) and the fused sampler must not change a
walk at all: bitwise."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu import sh as jsh
from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.phase import PhaseFunctionHenyeyGreenstein as JHG
from fvsrn_tpu.phase import PhaseFunctionRayleigh as JRayleigh
from fvsrn_tpu.raytracer import evaluator as jev
from fvsrn_tpu.raytracer import montecarlo as jmc
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch import sh
from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.phase import (PhaseFunctionHenyeyGreenstein,
                                   PhaseFunctionRayleigh)
from fvsrn_tpu_torch.raytracer import evaluator, montecarlo as tmc
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.utils import prng
from fvsrn_tpu_torch.utils.vecmath import intersect_aabb
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
TF = dict(rgb=[[0.9, 0.2, 0.1], [0.2, 0.9, 0.5]], opacity=[0.0, 12.0],
          positions=[0.0, 1.0])
MC = dict(max_absorption=12.0, num_bounces=1, max_iterations=64)
CAM = dict(pitch=0.3, yaw=0.8, distance=1.6)


class Scene:
    """The seeded scene in both packages: a 32:32 SnakeAlt:2 SRN with a
    sigmoid density head (about 0.5 everywhere, so most rays interact)
    and an 8x8^3 grid, a two-point TF, HG(0.3), one bounce."""

    def __init__(self):
        rng = np.random.default_rng(23)
        grid = (rng.standard_normal((8, 8, 8, 8)) * 0.3).astype(np.float32)
        self.jnet = JSRN.make(layers="32:32", activation="SnakeAlt:2",
                              num_fourier=6, output_mode="density",
                              latent=JLatent(static_grid=jnp.asarray(grid)),
                              seed=23)
        self.net = srn_from_arrays(*network_arrays(self.jnet))
        self.jvol = JVol.make(self.jnet)
        self.vol = VolumeInterpolationNetwork(self.net)
        self.jtf = JTF.make(**TF)
        self.tf = TransferFunctionPiecewiseLinear.make(**TF)
        self.jcfg = jmc.RayEvaluationMonteCarlo.make(**MC)
        self.cfg = tmc.RayEvaluationMonteCarlo.make(**MC)
        s, d = jgenerate_rays(JCam.make(**CAM), 16, 16)
        self.rs = np.asarray(s).reshape(-1, 3)
        self.rd = np.asarray(d).reshape(-1, 3)

    def rays(self):
        return torch.from_numpy(self.rs.copy()), torch.from_numpy(
            self.rd.copy())

    def starts(self):
        """Walk starts on the box's entry point (the start of trace_mc's
        first walk)."""
        rs, rd = self.rays()
        tmin, _ = intersect_aabb(rs, rd, self.vol.box_min,
                                 self.vol.box_size)
        return rs + torch.clamp(tmin, min=0.0) * rd, rd


@pytest.fixture(scope="module")
def scene():
    return Scene()


def assert_walks_close(got, want):
    """At least 98% of the rays (rows) within 1e-3, those within 1e-3."""
    got = np.asarray(got).reshape(len(want), -1)
    want = np.asarray(want).reshape(len(want), -1)
    close = np.all(np.abs(got - want) < 1e-3, axis=-1)
    assert close.mean() >= 0.98, f"{(~close).sum()} rays diverged"
    np.testing.assert_allclose(got[close], want[close], atol=1e-3)


def cat(result):
    return np.concatenate([np.asarray(v).reshape(len(v), -1)
                           for v in result], axis=1)


@pytest.mark.parametrize("jax_steps", [1, 4])
def test_delta_tracking_matches_jax(scene, jax_steps):
    """t_out, hit position, TF color and normal of each walk; also against
    the JAX walk batching 4 steps a round (whose cumulative sum differs
    from one step a round in the last bits)."""
    rs, rd = scene.starts()
    got = tmc.delta_tracking(prng.prng_key(3), rs, rd, scene.vol, scene.tf,
                             scene.cfg)
    want = jmc.delta_tracking(jax.random.PRNGKey(3), jnp.asarray(rs.numpy()),
                              jnp.asarray(scene.rd), scene.jvol, scene.jtf,
                              scene.jcfg, steps_per_round=jax_steps)
    hits = float((got.t_out > 0).float().mean())
    assert 0.5 < hits < 1.0
    assert_walks_close(cat(got), cat(want))


def test_trace_mc_matches_jax(scene):
    rs, rd = scene.rays()
    got = tmc.trace_mc(prng.prng_key(42), rs, rd, scene.vol, scene.tf,
                       PhaseFunctionHenyeyGreenstein.make(g=0.3), scene.cfg)
    want = jmc.trace_mc(jax.random.PRNGKey(42), jnp.asarray(scene.rs),
                        jnp.asarray(scene.rd), scene.jvol, scene.jtf,
                        JHG.make(g=0.3), scene.jcfg)
    assert 0.5 < float(got.color[:, 3].mean()) < 1.0
    assert float(got.color[:, :3].max()) > 0.0
    assert_walks_close(got.color, want.color)
    assert_walks_close(np.concatenate([got.normal, got.depth], 1),
                       np.concatenate([np.asarray(want.normal),
                                       np.asarray(want.depth)], 1))


def test_trace_mc_fused_matches_plain(scene):
    """use_fused=True: the sample evaluator (its plain version on the CPU)
    in every tracking round, against the volume's own eval_density."""
    rs, rd = scene.rays()
    args = (scene.vol, scene.tf, PhaseFunctionHenyeyGreenstein.make(g=0.3),
            scene.cfg)
    rounds = tmc.TRACKING_ROUNDS
    plain = tmc.trace_mc(prng.prng_key(42), rs, rd, *args)
    rounds = tmc.TRACKING_ROUNDS - rounds
    fused = tmc.trace_mc(prng.prng_key(42), rs, rd, *args, use_fused=True,
                         fused_kwargs=dict(tile=128))
    assert 8 < rounds <= 4 * MC["max_iterations"]
    assert_walks_close(fused.color, plain.color)


@pytest.mark.parametrize("schedule", [((4, 128), (8, 32)), ((2, 16),),
                                      None])
def test_trace_mc_compaction_is_bitwise(scene, schedule):
    """compact=True (active-masked walks and live-ray compaction, a width
    small enough to overflow, and the default schedule) changes nothing."""
    rs, rd = scene.rays()
    args = (prng.prng_key(2), rs, rd, scene.vol, scene.tf,
            PhaseFunctionHenyeyGreenstein.make(g=0.3), scene.cfg)
    base = tmc.trace_mc(*args)
    got = tmc.trace_mc(*args, compact=True, compact_schedule=schedule,
                       compact_min_width=None if schedule else 32)
    for a, b in zip(base, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("steps", [3, 4])
def test_delta_tracking_steps_per_round_is_bitwise(scene, steps):
    rs, rd = scene.starts()
    args = (prng.prng_key(3), rs, rd, scene.vol, scene.tf, scene.cfg)
    base = tmc.delta_tracking(*args, steps_per_round=1)
    got = tmc.delta_tracking(*args, steps_per_round=steps)
    for a, b in zip(base, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("every", [1, 3])
def test_delta_tracking_live_check_is_bitwise(scene, every, monkeypatch):
    """How often the host reads whether any ray still walks changes no
    bit: a round in which no ray walks changes nothing."""
    rs, rd = scene.starts()
    args = (prng.prng_key(3), rs, rd, scene.vol, scene.tf, scene.cfg)
    base = tmc.delta_tracking(*args)
    monkeypatch.setattr(tmc, "LIVE_CHECK_EVERY", every)
    got = tmc.delta_tracking(*args)
    for a, b in zip(base, got):
        assert torch.equal(a, b)


def test_delta_tracking_active_mask(scene):
    rs, rd = scene.starts()
    args = (prng.prng_key(0), rs, rd, scene.vol, scene.tf, scene.cfg)
    base = tmc.delta_tracking(*args)
    active = (torch.arange(rs.shape[0]) % 2 == 0)[:, None]
    got = tmc.delta_tracking(*args, active=active)
    m = active[:, 0]
    assert torch.equal(got.t_out[m], base.t_out[m])
    assert not bool(got.t_out[~m].any())


def test_eval_background_matches_jax():
    rng = np.random.default_rng(1)
    coeffs = rng.standard_normal((9, 3)).astype(np.float32) * 0.5
    coeffs[0] = 0.8
    d = rng.standard_normal((200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    kw = dict(light_position=(0.0, 1.5, 0.0), light_radius=0.7,
              light_intensity=2.0, sh_coefficients=coeffs)
    got = tmc.eval_background(torch.from_numpy(o), torch.from_numpy(d),
                              tmc.RayEvaluationMonteCarlo.make(**kw))
    want = jmc.eval_background(jnp.asarray(o), jnp.asarray(d),
                               jmc.RayEvaluationMonteCarlo.make(**kw))
    lit = got[:, 3] > 0
    assert bool((got[:, :3] == 2.0).all(dim=1).any()) and bool(lit.any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_matches_jax(degree):
    d = np.random.default_rng(degree).standard_normal((64, 3)).astype(
        np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = sh.evaluate(torch.from_numpy(d), degree)
    assert got.shape == (64, sh.get_coefficient_count(degree))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jsh.evaluate(jnp.asarray(d), degree)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["hg", "hg_iso", "rayleigh"])
def test_phase_matches_jax(which):
    """prob, sample_angle and sample with given uniforms."""
    port, ref = {
        "hg": (PhaseFunctionHenyeyGreenstein.make(g=0.3), JHG.make(g=0.3)),
        "hg_iso": (PhaseFunctionHenyeyGreenstein.make(g=0.0),
                   JHG.make(g=0.0)),
        "rayleigh": (PhaseFunctionRayleigh.make(), JRayleigh.make())}[which]
    rng = np.random.default_rng(2)
    d_in = rng.standard_normal((300, 3)).astype(np.float32)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    d_out = rng.standard_normal((300, 3)).astype(np.float32)
    d_out /= np.linalg.norm(d_out, axis=1, keepdims=True)
    u, u_phi = rng.random((2, 300)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        port.prob(t(d_in), t(d_out)).numpy(),
        np.asarray(ref.prob(jnp.asarray(d_in), jnp.asarray(d_out))),
        rtol=1e-5)
    np.testing.assert_allclose(
        port.sample_angle(t(u)).numpy(),
        np.asarray(ref.sample_angle(jnp.asarray(u))), rtol=0, atol=2e-6)
    got = port.sample(None, t(d_in), u=t(u), u_phi=t(u_phi))
    want = ref.sample(jax.random.PRNGKey(0), jnp.asarray(d_in),
                      u=jnp.asarray(u), u_phi=jnp.asarray(u_phi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-5)
    # without uniforms both draw them from split(key): JAX's bits
    got = port.sample(prng.prng_key(5), t(d_in))
    want = ref.sample(jax.random.PRNGKey(5), jnp.asarray(d_in))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_render_image_mc_and_progressive_match_jax(scene):
    """render_image(ray_mode="mc") is the first pass of the progressive
    renderer; refine(2) folds in a second pass with fold_in(key, 1). 8x8
    against the JAX ProgressiveRenderer on the same key."""
    phase = PhaseFunctionHenyeyGreenstein.make(g=0.3)
    ev = evaluator.ImageEvaluatorSimple(
        camera=CameraOnASphere.make(**CAM), volume=scene.vol, tf=scene.tf,
        ray_config=scene.cfg, phase=phase, ray_mode="mc")
    jevs = jev.ImageEvaluatorSimple(
        camera=JCam.make(**CAM), volume=scene.jvol, tf=scene.jtf,
        ray_config=scene.jcfg, phase=JHG.make(g=0.3), ray_mode="mc")
    jpr = jev.ProgressiveRenderer(jevs, 8, 8, key=jax.random.PRNGKey(7))
    want1 = np.asarray(jpr.refine(1))
    want2 = np.asarray(jpr.refine(1))
    img = evaluator.render_image(ev, 8, 8,
                                 key=prng.fold_in(prng.prng_key(7), 0),
                                 device="cpu")
    assert img.shape == (1, 8, 8, 8)
    pix = lambda a: np.moveaxis(np.asarray(a)[0], 0, -1).reshape(64, -1)
    assert_walks_close(pix(img[:, :4]), pix(want1[:, :4]))
    pr = evaluator.ProgressiveRenderer(ev, 8, 8, key=prng.prng_key(7),
                                       device="cpu")
    got2 = pr.refine(2)
    assert pr.frames == 2
    assert_walks_close(pix(got2), pix(want2))
    rgba = evaluator.extract_color(got2, tonemapping=True, max_exposure=0.5)
    assert rgba.shape == (1, 4, 8, 8) and float(rgba[:, :3].max()) <= 1.0


def test_render_image_supersampling_is_not_ported(scene):
    """Supersampling is ported now: render_image(samples=2) in "mc" mode,
    the jitter and the walks from the same key, against the JAX
    render_image at 8x8."""
    ev = evaluator.ImageEvaluatorSimple(
        camera=CameraOnASphere.make(**CAM), volume=scene.vol, tf=scene.tf,
        ray_config=scene.cfg, phase=PhaseFunctionRayleigh.make(),
        ray_mode="mc", samples=2)
    jevs = jev.ImageEvaluatorSimple(
        camera=JCam.make(**CAM), volume=scene.jvol, tf=scene.jtf,
        ray_config=scene.jcfg, phase=JRayleigh.make(), ray_mode="mc",
        samples=2)
    want = np.asarray(jev.render_image(jevs, 8, 8,
                                       key=jax.random.PRNGKey(3)))
    got = evaluator.render_image(ev, 8, 8, key=prng.prng_key(3),
                                 device="cpu").numpy()
    assert got.shape == want.shape == (1, 8, 8, 8)
    pix = lambda a: np.moveaxis(a[0], 0, -1).reshape(64, -1)
    assert_walks_close(pix(got[:, :4]), pix(want[:, :4]))


@pytest.mark.parametrize("samples", [2, 3])
def test_render_image_supersampling_dvr_matches_jax(scene, samples):
    """render_image(samples=S) in "dvr" mode at 32x32: JAX's jitter
    (uniform(prng_key(42), (S, H, W, 2)), bit for bit), the multisampled
    rays, and the combination (colors and alpha-weighted normals over S,
    depth over the summed alpha), within 1e-5."""
    from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    ev = evaluator.ImageEvaluatorSimple(
        camera=CameraOnASphere.make(**CAM), volume=scene.vol, tf=scene.tf,
        ray_config=RayEvaluationSteppingDvr.make(stepsize=1 / 32),
        samples=samples)
    jevs = jev.ImageEvaluatorSimple(
        camera=JCam.make(**CAM), volume=scene.jvol, tf=scene.jtf,
        ray_config=JCfg.make(stepsize=1 / 32), samples=samples)
    want = np.asarray(jev.render_image(jevs, 32, 32))
    with torch.no_grad():
        got = evaluator.render_image(ev, 32, 32, device="cpu").numpy()
    assert got.shape == want.shape == (1, 8, 32, 32)
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_generate_rays_jitter_matches_jax():
    """The camera's multisampling: (S, H, W, 2) offsets in the batch
    axis; a batched camera refuses them."""
    jit = np.random.default_rng(4).random((3, 6, 5, 2)).astype(np.float32)
    want = jgenerate_rays(JCam.make(**CAM), 5, 6, jitter=jnp.asarray(jit))
    got = generate_rays(CameraOnASphere.make(**CAM), 5, 6,
                        jitter=torch.from_numpy(jit))
    for g, w in zip(got, want):
        assert g.shape == (3, 6, 5, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("which", ["hg", "rayleigh"])
def test_phase_sample_from_key_matches_jax(which):
    """phase.sample without uniforms: u and u_phi from the two keys of
    split(key), JAX's uniform bits, on a (4, 50) batch of directions."""
    port, ref = {"hg": (PhaseFunctionHenyeyGreenstein.make(g=-0.4),
                        JHG.make(g=-0.4)),
                 "rayleigh": (PhaseFunctionRayleigh.make(),
                              JRayleigh.make())}[which]
    d = np.random.default_rng(6).standard_normal((4, 50, 3)).astype(
        np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k1, k2 = prng.split(prng.prng_key(11))
    want_u = np.asarray(jax.random.uniform(
        jax.random.split(jax.random.PRNGKey(11))[0], (4, 50)))
    np.testing.assert_array_equal(prng.uniform(k1, (4, 50)).numpy(), want_u)
    got = port.sample(prng.prng_key(11), torch.from_numpy(d))
    want = ref.sample(jax.random.PRNGKey(11), jnp.asarray(d))
    assert got.shape == (4, 50, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_sample_light_position_without_ray_ids_matches_jax():
    """The light sample from JAX's random.normal(key, shape + (3,)):
    normals within 1e-6 (XLA's erf_inv polynomial), points within 1e-6."""
    cfg = tmc.RayEvaluationMonteCarlo.make(**MC, light_radius=0.3,
                                           light_position=(0.1, 2.0, -0.5))
    jcfg = jmc.RayEvaluationMonteCarlo.make(**MC, light_radius=0.3,
                                            light_position=(0.1, 2.0, -0.5))
    got = tmc.sample_light_position(prng.prng_key(9), cfg, (7, 30),
                                    torch.float32, device="cpu")
    want = jmc.sample_light_position(jax.random.PRNGKey(9), jcfg, (7, 30),
                                     jnp.float32)
    assert got.shape == (7, 30, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
