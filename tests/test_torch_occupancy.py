"""Port parity, TF-aware empty-space culling (``fvsrn_tpu_torch/ops/
occupancy.py`` and the ``segment_active`` mask of the fused march) against
the JAX package's (``fvsrn_tpu/ops/occupancy.py``, ``mega_trace_dvr(
segment_active=...)`` in Pallas interpret mode) on the same inputs:

- density bounds of the sparse flagship at resolution 16, fine=2 (atol
  1e-5), the TF's interval opacities and the occupancy grid (equal);
- the JAX-semantics masks, per call and per bucket plan (equal);
- the zero-band probe of ``LoadedModel._occupancy_grid``;
- the masked plain march, image (1e-4) and gradients (atol 2e-5 / rtol
  1e-3), against the masked JAX megakernel;
- the route-1 mask on the bench camera's 512x512 rays: it covers every
  lattice sample the kernel takes in an occupied cell, in tiles whose
  kernel base k0t lies below the JAX mask's (rays and masks only);
- the culled port render against the unculled one at 32x32."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.ops import occupancy as jocc
from fvsrn_tpu.ops.fused_dvr import plan_ray_buckets as jplan
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu.scenes import sparse_scene as jsparse_scene
from fvsrn_tpu.train.checkpoints import RunCheckpoint
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch import inference
from fvsrn_tpu_torch.camera import CameraOnASphere, camera_matrix, \
    generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.ops import fused_mega, occupancy
from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation, \
    plan_ray_buckets
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.scenes import dense_scene, sparse_scene
from fvsrn_tpu_torch.train.checkpoints import load_weights
from tools.export_torch_weights import network_arrays

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_mega_grad import (BMIN, BSIZE, H, POSITIONS,  # noqa: E402
                                  RGB, SEG, TILE, block_rays, jax_net)

torch.set_num_threads(1)
RES, FINE = 16, 2
STEP = 1 / 128


@pytest.fixture(scope="module")
def shell():
    """(JAX network, port network, JAX TF, port TF) of the sparse
    flagship."""
    _, jtf, ckpt = jsparse_scene()
    with RunCheckpoint(ckpt, "r") as ck:
        jnet = ck.load_weights()
    _, tf, npz = sparse_scene()
    return jnet, load_weights(npz), jtf, tf


@pytest.fixture(scope="module")
def bounds(shell):
    jnet, net, _, _ = shell
    want = jocc.build_density_bounds(JVolume.make(jnet), resolution=RES,
                                     fine=FINE)
    got = occupancy.build_density_bounds(VolumeInterpolationNetwork(net),
                                         resolution=RES, fine=FINE,
                                         chunk=4096)
    return want, got


@pytest.fixture(scope="module")
def occ_grid(shell):
    jnet, _, jtf, _ = shell
    return jocc.build_occupancy(JVolume.make(jnet), jtf, resolution=RES,
                                fine=FINE, stepsize=STEP)


def test_density_bounds_match_jax(bounds):
    (jmin, jmax), (dmin, dmax) = bounds
    assert dmin.shape == dmax.shape == (RES,) * 3
    assert dmin.dtype == np.float32
    np.testing.assert_allclose(dmin, jmin, atol=1e-5)
    np.testing.assert_allclose(dmax, jmax, atol=1e-5)
    assert (dmin <= dmax).all() and dmax.max() > 0.3


def test_tf_max_opacity_matches_jax(bounds, shell):
    _, _, jtf, tf = shell
    (jmin, jmax), _ = bounds
    want = jocc.tf_max_opacity(jtf, jmin, jmax)
    got = occupancy.tf_max_opacity(tf, jmin, jmax)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == 0).any() and (got > 0).any()   # the zero band shows


def test_build_occupancy_matches_jax(shell, occ_grid):
    _, net, _, tf = shell
    got = occupancy.build_occupancy(VolumeInterpolationNetwork(net), tf,
                                    resolution=RES, fine=FINE, stepsize=STEP)
    assert got.dtype == bool and got.shape == (RES,) * 3
    np.testing.assert_array_equal(got, occ_grid)
    assert 0.05 < got.mean() < 0.95


def _view(width, distance=1.6):
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=distance)
    rs, rd = generate_rays(camera_matrix(cam), width, width,
                           cam.fov_y_radians, device="cpu")
    perm, _ = block_ray_permutation(width, width, 16, 16, device="cpu")
    return rs.reshape(-1, 3)[perm].numpy(), rd.reshape(-1, 3)[perm].numpy()


def test_make_segment_occupancy_matches_jax(occ_grid):
    rs, rd = _view(32, distance=1.3)
    steps = max_steps_bound(BSIZE, STEP)
    rng = np.random.default_rng(5)
    clip = (2.0 * rng.random(rs.shape[0])).astype(np.float32)
    tminc = (0.4 * rng.random(rs.shape[0])).astype(np.float32)
    kw = dict(stepsize=STEP, seg=16, tile=64, n_seg=-(-steps // 16),
              max_steps=steps)
    for extra in ({}, dict(tmax_clip=clip, tmin_clip=tminc),
                  dict(samples_per_step=0.5)):
        want = jocc.make_segment_occupancy(rs, rd, occ_grid, BMIN, BSIZE,
                                           **kw, **extra)
        got = occupancy.make_segment_occupancy(rs, rd, occ_grid, BMIN,
                                               BSIZE, **kw, **extra)
        assert got.dtype == bool and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()


def test_plan_segment_occupancy_matches_jax(occ_grid):
    rs, rd = _view(32, distance=1.3)
    clip = (0.6 + 1.5 * np.random.default_rng(6).random(rs.shape[0])
            ).astype(np.float32)
    kw = dict(stepsize=STEP, seg=16, tile=64, n_buckets=3,
              grid_sizes=(32, 32, 32), tmax_clip=clip)
    jp = jplan(rs, rd, BMIN, BSIZE, **kw)
    p = plan_ray_buckets(rs, rd, BMIN, BSIZE, **kw)
    np.testing.assert_array_equal(p.perm, jp.perm)
    want = jocc.plan_segment_occupancy(jp, rs, rd, occ_grid, BMIN, BSIZE,
                                       stepsize=STEP, seg=16, tile=64)
    got = occupancy.plan_segment_occupancy(p, rs, rd, occ_grid, BMIN, BSIZE,
                                           stepsize=STEP, seg=16, tile=64)
    assert len(got) == len(want) == len(jp.group_sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_zero_band_probe():
    """A ramp TF has no zero band: no grid, in either package."""
    _, jtf, ckpt = jdense_scene()
    jm = JLoadedModel.from_checkpoint(ckpt, tf=jtf)
    _, tf, npz = dense_scene()
    assert jm._occupancy_grid(STEP) is None
    dense = LoadedModel.from_checkpoint(npz, tf=tf)
    assert dense._occupancy_grid(STEP, device="cpu") is None


def test_zero_band_probe_builds_a_grid(shell, occ_grid, monkeypatch):
    """The sparse TF has one: a grid, cached, equal to the JAX package's
    at the same (reduced) resolution."""
    _, _, _, tf = shell
    monkeypatch.setattr(inference, "OCCUPANCY_RESOLUTION", RES)
    m = LoadedModel.from_checkpoint(sparse_scene()[2], tf=tf)
    grid = m._occupancy_grid(STEP, device="cpu")
    np.testing.assert_array_equal(grid, occ_grid)
    assert m._occupancy_grid(STEP, device="cpu") is grid       # cached


def _masked_both(mask, early_out):
    """(JAX (image, grads), port (image, grads)) of the masked march's
    loss sum(w * rgba); grads keyed by leaf name, the TF as "tf"."""
    jnet = jax_net()
    rs, rd = block_rays(1.3)
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    jtf = JTF.make(rgb=RGB, opacity=[20.0, 60.0, 120.0], positions=POSITIONS)

    def jloss(net, tf_tensor):
        img = jmega(jnp.asarray(rs), jnp.asarray(rd), net, BMIN, BSIZE,
                    tf_tensor, stepsize=H, max_steps=max_steps_bound(BSIZE, H),
                    seg=SEG, tile=TILE, enable_early_out=early_out,
                    differentiable=True, table_dtype=jnp.float32,
                    segment_active=jnp.asarray(mask), interpret=True)
        return jnp.sum(img * w), img

    (_, jimg), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(jtf.tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(gtf)
    net = srn_from_arrays(*network_arrays(jnet))
    tf = torch.tensor(np.asarray(jtf.tensor), requires_grad=True)
    img = fused_mega.mega_trace_dvr_plain(
        torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE, tf,
        stepsize=H, seg=SEG, tile=TILE, enable_early_out=early_out,
        differentiable=True, segment_active=torch.tensor(mask))
    (img * torch.tensor(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = tf.grad.numpy()
    return (np.asarray(jimg), jgrads), (img.detach().numpy(), grads)


@pytest.mark.parametrize("early_out", [True, False])
def test_masked_march_matches_jax(early_out):
    """A seeded mask culls a third of the (tile, segment) programs: the
    plain masked march equals the masked JAX megakernel, forward and
    gradients; and the mask changed the image."""
    n_seg = -(-max_steps_bound(BSIZE, H) // SEG) + 2
    mask = np.random.default_rng(4).random((4, n_seg)) > 0.33
    (jimg, jgrads), (img, grads) = _masked_both(mask, early_out)
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        np.testing.assert_allclose(grads[name], jgrads[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)
    rs, rd = block_rays(1.3)
    full = fused_mega.mega_trace_dvr_plain(
        torch.tensor(rs), torch.tensor(rd),
        srn_from_arrays(*network_arrays(jax_net())), BMIN, BSIZE,
        torch.tensor(np.asarray(JTF.make(rgb=RGB, opacity=[20.0, 60.0, 120.0],
                                         positions=POSITIONS).tensor)),
        stepsize=H, seg=SEG, tile=TILE, enable_early_out=early_out,
        table_dtype=torch.float32)
    assert np.abs(full.numpy() - img).max() > 1e-2


def test_mask_shape_is_checked():
    rs, rd = block_rays(1.3)
    net = srn_from_arrays(*network_arrays(jax_net()))
    tf = torch.tensor(np.asarray(JTF.make(rgb=RGB, opacity=[1.0, 2.0, 3.0],
                                          positions=POSITIONS).tensor))
    for bad in (torch.ones(3, 8, dtype=torch.bool),
                torch.ones(4, dtype=torch.bool),
                torch.ones(4, 8, dtype=torch.float32)):
        with pytest.raises(ValueError):
            fused_mega.mega_trace_dvr_plain(
                torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE, tf,
                stepsize=H, seg=SEG, tile=TILE, segment_active=bad)


def test_route1_mask_covers_the_kernels_samples():
    """The bench camera at 512x512, h = 1/512, 16x16 blocks: five tiles
    hold box-missing rays whose entry point lies below every live ray's,
    so the kernel's base k0t sits 2-5 steps below the JAX mask's. On 40
    tiles holding all five, against an occupancy grid of thin walls
    inside the box's faces, the route-1 mask is True exactly where some
    lattice sample the kernel takes (its k0t, each ray's k0_ray and tmax)
    lies in an occupied cell."""
    h, tile, seg, res = 1 / 512, 256, 32, 128
    rs, rd = _view(512)
    rs_t, rd_t = torch.from_numpy(rs), torch.from_numpy(rd)
    rays = fused_mega.ray_packet(rs_t, rd_t, BMIN, BSIZE, h).numpy()
    pk = rays.reshape(-1, tile, 8)
    k0t = np.nanmin(pk[..., 6], axis=1)
    t0 = (np.float32(-0.5) - rs) / rd
    t1 = (np.float32(0.5) - rs) / rd
    tmin = np.maximum(np.minimum(t0, t1).max(axis=1), 0.0)
    tmax = np.maximum(t0, t1).min(axis=1)
    k0t_jax = np.where(tmax > tmin, np.ceil(tmin / h), np.inf).reshape(
        -1, tile).min(axis=1)
    shifted = np.nonzero(np.isfinite(k0t_jax) & (k0t < k0t_jax))[0]
    assert shifted.tolist() == [67, 68, 69, 96, 97]
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    occ = np.maximum(np.maximum(abs(x), abs(y)), abs(z)) > 0.47
    tiles = np.arange(64, 104)
    sel = (tiles[:, None] * tile + np.arange(tile)).ravel()
    mask = occupancy.kernel_segment_occupancy(
        rs_t[sel], rd_t[sel], occ, BMIN, BSIZE, stepsize=h, seg=seg,
        tile=tile).numpy()
    p = pk[tiles]
    need = np.zeros(mask.shape, bool)
    for s in range(mask.shape[1] + 2):
        k = (k0t[tiles, None, None] + np.float32(s * seg)
             + np.arange(seg, dtype=np.float32))
        t = k * np.float32(h)
        alive = (t <= p[..., 7:8]) & (k >= p[..., 6:7])
        pos = p[..., None, 0:3] + p[..., None, 3:6] * t[..., None]
        ix = np.clip(((pos + np.float32(0.5)) * res).astype(np.int32), 0,
                     res - 1)
        hit = (occ[ix[..., 0], ix[..., 1], ix[..., 2]] & alive).any(
            axis=(1, 2))
        if s < mask.shape[1]:
            need[:, s] = hit
        else:
            assert not alive.any()   # the mask spans every segment
    np.testing.assert_array_equal(mask, need)
    assert need[shifted - tiles[0]].any() and not mask.all()


def test_culled_render_matches_unculled(monkeypatch):
    """The sparse flagship at 32x32, h = 1/128, on the CPU: the culled
    render stays within max_steps * alpha_skip of the unculled one, and
    the mask culls some live programs."""
    monkeypatch.setattr(inference, "OCCUPANCY_RESOLUTION", 32)
    _, tf, npz = sparse_scene()
    m = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=STEP))
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6)
    culled = m.prepare_network_render(cam, 32, 32, "FUSED", device="cpu")
    plain = m.prepare_network_render(cam, 32, 32, "FUSED", device="cpu",
                                     occupancy_culling=False)
    assert culled.segment_active is not None and plain.segment_active is None
    mask = culled.segment_active
    a = culled().numpy()
    b = plain().numpy()
    bound = max_steps_bound(BSIZE, STEP) * inference.ALPHA_SKIP
    assert np.abs(a - b).max() <= bound
    assert b[..., 3].max() > 0.5
    _, live = fused_mega.mega_trace_dvr_plain(
        culled.ray_start, culled.ray_dir, culled.network, BMIN, BSIZE,
        culled.tf.tensor, stepsize=STEP, tmax_clip=culled.tmax_clip,
        return_samples=True)
    _, kept = culled.march(return_samples=True)
    assert int(kept.sum()) < int(live.sum()) and not bool(mask.all())
    r = m.render_network(cam, 32, 32, "FUSED", device="cpu",
                         occupancy_culling=False, saturation_clip=False,
                         table_dtype=torch.float32)
    assert r.shape == (32, 32, 4)
