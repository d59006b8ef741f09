"""Port parity, the rasterization pre-pass
(``fvsrn_tpu_torch/raytracer/rasterization.py``): each function against
the JAX package's on the same numpy inputs. Streamlines (Euler and RK4)
and projections within 1e-5; the splatted rgba + depth image with its
z-buffer: colors equal, depth within 1e-5, two points in one pixel
resolved by depth and an exact tie as JAX's scatter resolves it (the
last point); a particle background composited under a render through
``render_image(background=)`` against ``ImageEvaluatorSimple.render
(background=)`` within 2e-5 (the plain march's parity bound). CPU
only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.raytracer import rasterization as jr
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.evaluator import ImageEvaluatorSimple as JEval
from fvsrn_tpu.transfer import TransferFunctionIdentity as JIdentity
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JVol
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.raytracer import rasterization as tr
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.raytracer.evaluator import ImageEvaluatorSimple
from fvsrn_tpu_torch.transfer import TransferFunctionIdentity
from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

torch.set_num_threads(1)
CAM = dict(pitch=0.3, yaw=0.6, distance=2.0)


def _swirl(x):
    return torch.stack([-x[:, 1], x[:, 0], 0.2 * torch.ones_like(x[:, 0])],
                       dim=1)


def _jswirl(x):
    return jnp.stack([-x[:, 1], x[:, 0], 0.2 * jnp.ones_like(x[:, 0])],
                     axis=1)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_particle_trace_matches_jax(method):
    seeds = np.random.default_rng(3).uniform(-0.4, 0.4, (5, 3))
    p = tr.ParticleIntegration.make(seeds, steps=40, dt=0.05, method=method)
    jp = jr.ParticleIntegration.make(seeds, steps=40, dt=0.05, method=method)
    got = p.trace(_swirl).numpy()
    assert got.shape == (5, 41, 3)
    np.testing.assert_allclose(got, np.asarray(jp.trace(_jswirl)), atol=1e-5)


def test_project_points_matches_jax():
    pts = np.random.default_rng(4).uniform(-0.5, 0.5, (64, 3)).astype(
        np.float32)
    got = tr.project_points(torch.from_numpy(pts),
                            CameraOnASphere.make(**CAM), 48, 32)
    want = jr.project_points(jnp.asarray(pts), JCam.make(**CAM), 48, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)


@pytest.mark.parametrize("radius", [1, 2])
def test_rasterize_points_matches_jax(radius):
    """200 seeded points, a few behind the camera and off screen, and an
    exact tie (a point repeated in another color): the JAX image."""
    rng = np.random.default_rng(5 + radius)
    pts = rng.uniform(-0.6, 0.6, (200, 3)).astype(np.float32)
    pts[:3] = [[-3.0, 0.0, 0.0], [0.0, 5.0, 0.0], [0.0, 0.0, 0.0]]
    pts[3] = pts[2]
    cols = rng.uniform(0, 1, (200, 4)).astype(np.float32)
    got = tr.rasterize_points(torch.from_numpy(pts), torch.from_numpy(cols),
                              CameraOnASphere.make(**CAM), 32, 24,
                              point_radius=radius).numpy()
    want = np.asarray(jr.rasterize_points(
        jnp.asarray(pts), jnp.asarray(cols), JCam.make(**CAM), 32, 24,
        point_radius=radius))
    assert got.shape == (1, 5, 24, 32)
    np.testing.assert_array_equal(got[0, :4], want[0, :4])
    np.testing.assert_allclose(got[0, 4], want[0, 4], atol=1e-5)


def test_rasterize_exact_tie_matches_jax():
    """Three points at one place in three colors, splatted with radius 2:
    every covered pixel takes the last point's color, as JAX's scatter
    leaves it."""
    pts = np.zeros((3, 3), np.float32)
    cols = np.eye(4, dtype=np.float32)[:3] + np.float32(0.5)
    got = tr.rasterize_points(torch.from_numpy(pts), torch.from_numpy(cols),
                              CameraOnASphere.make(**CAM), 16, 16,
                              point_radius=2).numpy()
    want = np.asarray(jr.rasterize_points(
        jnp.asarray(pts), jnp.asarray(cols), JCam.make(**CAM), 16, 16,
        point_radius=2))
    hit = got[0, 3] > 0
    assert hit.sum() == 9
    np.testing.assert_array_equal(got[0, :4], want[0, :4])
    np.testing.assert_array_equal(got[0, :4][:, hit].T,
                                  np.broadcast_to(cols[2], (9, 4)))


def test_rasterize_depth_buffer():
    """Two points on the center ray: the nearer one's color and depth."""
    cam = CameraOnASphere.make(distance=2.0)
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.0, 0.3, 0.0]])
    cols = torch.tensor([[1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 0.0, 1.0],
                         [0.0, 0.0, 1.0, 1.0]])
    img = tr.rasterize_points(pts, cols, cam, 32, 32).numpy()
    flat = img[0, :, 16, 16]
    assert flat[0] == 1.0 and flat[1] == 0.0
    np.testing.assert_allclose(flat[4], 2.0, atol=1e-4)
    assert (img[0, 4] > 0).sum() >= 2


def test_particle_background_render_matches_jax():
    """Streamline splats as the background of a transparent and of an
    absorbing sphere: the rays stop at the splats' depth and the splats
    show through, as in the JAX package."""
    seeds = np.asarray([[0.0, 0.0, 0.0], [0.1, -0.2, 0.3]], np.float32)
    kw = dict(color=(0.2, 0.9, 0.4, 1.0), steps=6, dt=0.05,
              point_radius=2)
    cam, jcam = CameraOnASphere.make(**CAM), JCam.make(**CAM)
    bg = tr.rasterize_particles(tr.ParticleIntegration.make(seeds, **kw),
                                _swirl, cam, 16, 16)
    jbg = jr.rasterize_particles(jr.ParticleIntegration.make(seeds, **kw),
                                 _jswirl, jcam, 16, 16)
    np.testing.assert_array_equal(bg.numpy()[0, :4], np.asarray(jbg)[0, :4])
    np.testing.assert_allclose(bg.numpy()[0, 4], np.asarray(jbg)[0, 4],
                               atol=1e-5)
    for absorption in (0.0, 6.0):
        ev = ImageEvaluatorSimple(
            camera=cam, volume=VolumeInterpolationImplicit.make("SPHERE"),
            tf=TransferFunctionIdentity.make(absorption=absorption),
            ray_config=RayEvaluationSteppingDvr.make(stepsize=0.05))
        jev = JEval(camera=jcam, volume=JVol.make("SPHERE"),
                    tf=JIdentity.make(absorption=absorption),
                    ray_config=JCfg.make(stepsize=0.05))
        got = ev.render(16, 16, background=bg, device="cpu").numpy()
        want = np.asarray(jev.render(16, 16, background=jbg))
        np.testing.assert_allclose(got, want, atol=2e-5)
        assert got[0, 3].max() > 0.9
