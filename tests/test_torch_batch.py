"""Port parity, batched scenes: ``render_image`` renders B cameras against
B volumes or B TFs, one entry each, as the JAX package does.

The scene's batch is the largest of the camera's (``center`` or
``pitch_yaw_distance`` batched), the volume's and the TF's; camera entry
b traces volume and TF entry min(b, batch - 1) (``trace_dvr(b=)``,
``trace_iso(b=)``, ``eval_normalized(b=)``, ``BRDFLambert.eval(b=)``).
Every batched case gives each entry different data: a batch of one
cannot show an ignored ``b``. Renders are held within 1e-5 of the JAX
package (both march in float32 with the same per-ray sampling). CPU only,
16x16 images, 8^3 grids."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu import brdf as jbrdf
from fvsrn_tpu import camera as jcamera
from fvsrn_tpu import transfer as jtransfer
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JDvr
from fvsrn_tpu.raytracer.evaluator import ImageEvaluatorSimple as JEval
from fvsrn_tpu.raytracer.evaluator import render_image as jrender
from fvsrn_tpu.raytracer.iso import RayEvaluationSteppingIso as JIso
from fvsrn_tpu.volume.grid import VolumeInterpolationGrid as JGrid
from fvsrn_tpu_torch import brdf, camera, transfer
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.raytracer.evaluator import (ImageEvaluatorSimple,
                                                 ProgressiveRenderer,
                                                 render_image)
from fvsrn_tpu_torch.raytracer.iso import RayEvaluationSteppingIso
from fvsrn_tpu_torch.volume.grid import VolumeInterpolationGrid

torch.set_num_threads(1)
CPU = "cpu"
SIZE = 16
H = 1.0 / 64
TOL = 1e-5


def grid_data(batch, seed=5):
    """(batch, 8, 8, 8) smooth densities, each entry its own field."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    out = []
    for b in range(batch):
        c = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
        r = 0.45 + 0.25 * b
        f = np.exp(-((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
                   / r ** 2)
        out.append(f + 0.05 * rng.uniform(size=f.shape))
    return np.stack(out).astype(np.float32)


def piecewise(batch):
    """A 2-knot piecewise TF, (R, 5) for batch 1 and (B, R, 5) with
    different colours and absorptions per entry otherwise."""
    rows = [np.array([[0.9, 0.3, 0.1, 0.0, 0.0],
                      [0.1, 0.6, 1.0, 30.0 + 50.0 * b, 1.0]], np.float32)
            for b in range(batch)]
    return rows[0] if batch == 1 else np.stack(rows)


def cameras(center_only=False):
    """Two cameras: batched in pitch/yaw/distance, or in center only."""
    if center_only:
        center = np.array([[0.0, 0.0, 0.0], [0.15, -0.1, 0.05]], np.float32)
        pyd = np.array([0.3, 0.5, 1.6], np.float32)
    else:
        center = np.zeros(3, np.float32)
        pyd = np.array([[0.3, 0.5, 1.6], [-0.4, 1.9, 1.8]], np.float32)
    j = jcamera.CameraOnASphere(center=center, pitch_yaw_distance=pyd)
    t = camera.CameraOnASphere(center=torch.tensor(center),
                               pitch_yaw_distance=torch.tensor(pyd))
    return j, t


def render_both(cam_j, cam_t, data, tf_j, tf_t, mode="dvr", jconfig=None,
                tconfig=None):
    jvol = JGrid.from_grid(data)
    tvol = VolumeInterpolationGrid.from_grid(data)
    if jconfig is None:
        jconfig = JDvr.make(stepsize=H)
        tconfig = RayEvaluationSteppingDvr.make(stepsize=H)
    want = np.asarray(jrender(JEval(camera=cam_j, volume=jvol, tf=tf_j,
                                    ray_config=jconfig, ray_mode=mode),
                              SIZE, SIZE))
    got = render_image(ImageEvaluatorSimple(
        camera=cam_t, volume=tvol, tf=tf_t, ray_config=tconfig,
        ray_mode=mode), SIZE, SIZE, device=CPU).numpy()
    return want, got


def entry_errors(want, got):
    assert want.shape == got.shape
    return [float(np.abs(want[b] - got[b]).max())
            for b in range(want.shape[0])]


def test_render_image_batched_grid_matches_jax():
    """Two cameras against a 2 x 8^3 grid: entry 1 renders grid 1 (it
    rendered grid 0 before, 0.888 off)."""
    cj, ct = cameras()
    data = grid_data(2)
    tf = piecewise(1)
    want, got = render_both(
        cj, ct, data, jtransfer.TransferFunctionPiecewiseLinear(tf),
        transfer.TransferFunctionPiecewiseLinear(torch.tensor(tf)))
    assert want.shape == (2, 8, SIZE, SIZE)
    errs = entry_errors(want, got)
    assert max(errs) < TOL, errs
    # the two entries differ, so an ignored b would show
    assert np.abs(want[1, 3] - want[0, 3]).max() > 0.1


def test_render_image_batched_tf_matches_jax():
    """An unbatched grid, two cameras, a (2, R, 5) piecewise TF."""
    cj, ct = cameras()
    data = grid_data(1)[0]
    tf = piecewise(2)
    want, got = render_both(
        cj, ct, data, jtransfer.TransferFunctionPiecewiseLinear(tf),
        transfer.TransferFunctionPiecewiseLinear(torch.tensor(tf)))
    errs = entry_errors(want, got)
    assert max(errs) < TOL, errs


def test_render_image_camera_batched_in_center_matches_jax():
    """A camera batched in ``center`` only, against a batched grid."""
    cj, ct = cameras(center_only=True)
    assert ct.batch == 2
    data = grid_data(2, seed=9)
    tf = piecewise(1)
    want, got = render_both(
        cj, ct, data, jtransfer.TransferFunctionPiecewiseLinear(tf),
        transfer.TransferFunctionPiecewiseLinear(torch.tensor(tf)))
    assert want.shape[0] == 2
    errs = entry_errors(want, got)
    assert max(errs) < TOL, errs


def test_render_image_iso_batched_grid_matches_jax():
    """The iso render of two cameras against a 2 x 8^3 grid."""
    cj, ct = cameras()
    data = grid_data(2, seed=13)
    tf = piecewise(1)
    want, got = render_both(
        cj, ct, data, jtransfer.TransferFunctionPiecewiseLinear(tf),
        transfer.TransferFunctionPiecewiseLinear(torch.tensor(tf)),
        mode="iso", jconfig=JIso.make(stepsize=H, isovalue=0.6),
        tconfig=RayEvaluationSteppingIso.make(stepsize=H, isovalue=0.6))
    errs = entry_errors(want, got)
    # a first hit that flips on float32 noise moves a whole pixel; none
    # does at this size
    assert max(errs) < TOL, errs
    assert np.abs(want[1, 3] - want[0, 3]).max() > 0.5


def test_render_image_batched_brdf_matches_jax():
    """Phong shading on a batched grid with normals: every entry reads the
    same (unbatched) BRDF and its own grid."""
    cj, ct = cameras()
    data = grid_data(2, seed=17)
    tf = piecewise(2)
    jb = jbrdf.BRDFLambert.make(enable_phong=True)
    tb = brdf.BRDFLambert.make(enable_phong=True)
    jvol = JGrid.from_grid(data)
    tvol = VolumeInterpolationGrid.from_grid(data)
    want = np.asarray(jrender(JEval(
        camera=cj, volume=jvol,
        tf=jtransfer.TransferFunctionPiecewiseLinear(tf),
        ray_config=JDvr.make(stepsize=H, need_normals=True), brdf=jb),
        SIZE, SIZE))
    got = render_image(ImageEvaluatorSimple(
        camera=ct, volume=tvol,
        tf=transfer.TransferFunctionPiecewiseLinear(torch.tensor(tf)),
        ray_config=RayEvaluationSteppingDvr.make(stepsize=H,
                                                 need_normals=True),
        brdf=tb), SIZE, SIZE, device=CPU).numpy()
    errs = entry_errors(want, got)
    assert max(errs) < TOL, errs


def _tf_pairs():
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 1, (2, 16, 4)).astype(np.float32)
    tex[..., 3] *= 20
    gauss = np.stack([np.array([[0.9, 0.2, 0.1, 9.0, 0.3 + 0.2 * b, 0.2],
                                [0.1, 0.8, 0.4, 4.0, 0.8, 0.1 + 0.1 * b]],
                               np.float32) for b in range(2)])
    ident = np.array([[1.0, 2.0], [3.0, 0.5]], np.float32)
    return {
        "identity": (jtransfer.TransferFunctionIdentity(ident),
                     transfer.TransferFunctionIdentity(torch.tensor(ident))),
        "piecewise": (jtransfer.TransferFunctionPiecewiseLinear(piecewise(2)),
                      transfer.TransferFunctionPiecewiseLinear(
                          torch.tensor(piecewise(2)))),
        "texture": (jtransfer.TransferFunctionTexture(tex),
                    transfer.TransferFunctionTexture(torch.tensor(tex))),
        "gaussian": (jtransfer.TransferFunctionGaussian(gauss),
                     transfer.TransferFunctionGaussian(torch.tensor(gauss))),
    }


@pytest.mark.parametrize("kind", ["identity", "piecewise", "texture",
                                  "gaussian"])
def test_batched_tf_entries_match_jax(kind):
    """``batch``, ``_params(b)`` and ``eval_normalized(b=)`` of every TF
    the JAX package batches, entry by entry."""
    jtf, ttf = _tf_pairs()[kind]
    assert ttf.batch == jtf.batch == 2
    d = np.linspace(0.0, 1.0, 97, dtype=np.float32)
    outs = []
    for b in range(2):
        want = np.asarray(jtf.eval_normalized(jnp.asarray(d), None, None,
                                              0.25, b=b))
        got = ttf.eval_normalized(torch.tensor(d), None, None, 0.25,
                                  b=b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ttf._params(b).numpy(),
                                      np.asarray(jtf._params(b)))
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def test_camera_batch_and_frame_match_jax():
    """``batch``, ``get_parameters``, ``get_origin`` and ``get_front``."""
    for center_only in (False, True):
        cj, ct = cameras(center_only)
        assert ct.batch == cj.batch == 2
        for name in ("get_parameters", "get_origin", "get_front"):
            np.testing.assert_allclose(getattr(ct, name)().numpy(),
                                       np.asarray(getattr(cj, name)()),
                                       rtol=1e-6, atol=1e-6)
    single = camera.CameraOnASphere.make(pitch=0.2)
    assert single.batch == 1
    assert single.get_origin().shape == (1, 3)


def test_progressive_renderer_sizes_by_the_camera():
    """The running sums take the camera's batch, as the JAX package's."""
    _, ct = cameras(center_only=True)
    data = grid_data(2)
    ev = ImageEvaluatorSimple(
        camera=ct, volume=VolumeInterpolationGrid.from_grid(data),
        tf=transfer.TransferFunctionPiecewiseLinear(
            torch.tensor(piecewise(1))),
        ray_config=RayEvaluationSteppingDvr.make(stepsize=H))
    pr = ProgressiveRenderer(ev, 8, 8, device=CPU)
    img = pr.refine(1)
    assert img.shape == (2, 8, 8, 8)
    want = render_image(ev, 8, 8, device=CPU)
    assert torch.allclose(img[:, :4], want[:, :4])
