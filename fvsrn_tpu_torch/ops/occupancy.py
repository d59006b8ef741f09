"""TF-aware empty-space culling for the fused march.

Counterpart of ``fvsrn_tpu/ops/occupancy.py``. Camera-static preparation,
then a mask the megakernel ANDs into its per-(tile, segment) activity:

1. :func:`build_density_bounds`: the density field (``eval_density`` of
   any volume) sampled on a lattice of ``fine`` points per macrocell axis,
   on the volume's device, in chunks, without gradients; per-macrocell
   [min, max] intervals, dilated by one macrocell (torch pooling; equal to
   the JAX package's NumPy windows). An estimate: features thinner than
   the lattice stride can escape it, so keep ``fine`` >= 2.
2. :func:`tf_max_opacity`: the TF's largest opacity over each interval (a
   sparse-table range maximum over a dense discretization, conservative by
   one bin on each side; host NumPy, as in the JAX package).
3. :func:`build_occupancy`: a boolean macrocell grid, True where a sample
   may add more than ``alpha_skip`` opacity * stepsize. Culling the rest
   changes a ray's image by at most ~max_steps * alpha_skip.
4. Masks, (n_tiles, n_seg) bool: True iff some lattice sample of some ray
   of the tile inside the segment lies in an occupied macrocell.
   :func:`make_segment_occupancy` and :func:`plan_segment_occupancy` keep
   the JAX package's semantics (the tile base k0t over the tile's LIVE
   rays; per bucket of a plan). :func:`kernel_segment_occupancy` builds
   the mask the port's megakernel route needs: from the kernel's own
   geometry (``fused_mega.ray_packet``: k0t over EVERY ray of the tile,
   box-missing ones included), since a tile whose k0t sits below the JAX
   mask's would index shifted segments and could cull live samples.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from .fused_mega import _segments_needed, _tile_geometry, ray_packet


def _f32(v, dev) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(3)


def build_density_bounds(volume, *, resolution: int = 32, fine: int = 4,
                         chunk: int = 1 << 18):
    """Per-macrocell density [min, max] over a ``resolution``^3 grid of the
    volume's box, sampled at ``fine`` points per macrocell axis (shared
    corners), dilated by one macrocell. Returns (dmin, dmax) NumPy
    (R, R, R) float32, index order [ix, iy, iz] over normalized [0, 1]^3.
    The densities are the volume's at its own conditioning (a network
    volume's ``time`` and ``ensemble``; the JAX signature's ``time`` and
    ``ensemble`` keywords are read nowhere there either)."""
    r = int(resolution)
    n = r * fine + 1
    dev = torch.as_tensor(volume.box_min).device
    xs = torch.from_numpy(np.linspace(0.0, 1.0, n, dtype=np.float32)).to(dev)
    bm = _f32(volume.box_min, dev)
    bs = _f32(volume.box_size, dev)
    total = n ** 3
    vals = torch.empty(total, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i in range(0, total, chunk):
            idx = torch.arange(i, min(i + chunk, total), device=dev)
            p = torch.stack([xs[idx // (n * n)], xs[(idx // n) % n],
                             xs[idx % n]], dim=1)
            v, _ = volume.eval_density(bm + p * bs, torch.zeros_like(p))
            vals[i:i + idx.numel()] = v.reshape(-1)
    d = vals.reshape(1, 1, n, n, n)
    # the (fine + 1)^3 windows at stride fine, then the one-cell dilation
    dmax = F.max_pool3d(d, fine + 1, stride=fine)
    dmin = -F.max_pool3d(-d, fine + 1, stride=fine)
    dmax = F.max_pool3d(dmax, 3, stride=1, padding=1)
    dmin = -F.max_pool3d(-dmin, 3, stride=1, padding=1)
    return (dmin[0, 0].cpu().numpy().astype(np.float32),
            dmax[0, 0].cpu().numpy().astype(np.float32))


def tf_max_opacity(tf, dmin: np.ndarray, dmax: np.ndarray, *,
                   density_min: float = 0.0, density_max: float = 1.0,
                   bins: int = 1024) -> np.ndarray:
    """Max TF opacity over each [dmin, dmax] interval (normalized density
    space): a sparse-table range maximum over a dense opacity
    discretization, for any TF with ``eval_normalized``, monotone or not."""
    dev = tf.tensor.device
    ds = torch.from_numpy(np.linspace(0.0, 1.0, bins + 1, dtype=np.float32))
    rgba = tf.eval_normalized(
        ds.to(dev), torch.zeros(bins + 1, 3, device=dev),
        torch.full((bins + 1,), -1.0, device=dev), 1.0)
    op = rgba[:, 3].cpu().numpy().astype(np.float64)
    # sparse table: level j holds the max over windows of length 2^j
    levels = [op]
    k = 1
    while 2 * k <= bins + 1:
        prev = levels[-1]
        levels.append(np.maximum(prev[:-k], prev[k:]))
        k *= 2
    inv = 1.0 / (density_max - density_min)
    lo = np.clip((dmin - density_min) * inv, 0.0, 1.0)
    hi = np.clip((dmax - density_min) * inv, 0.0, 1.0)
    # widen by one bin each side: the discretized max may undershoot the
    # interval's by a bin's slope, and the estimate must stay conservative
    a = np.clip((lo * bins).astype(np.int64) - 1, 0, bins)
    b = np.clip(np.ceil(hi * bins).astype(np.int64) + 1, 0, bins)
    b = np.maximum(b, a)
    span = b - a + 1
    kk = np.maximum(np.int64(np.log2(np.maximum(span, 1))), 0)
    out = np.empty(a.shape, np.float64)
    for kv in np.unique(kk):
        m = kk == kv
        lv = levels[int(kv)]
        step = 1 << int(kv)
        ia = np.clip(a[m], 0, lv.shape[0] - 1)
        ib = np.clip(b[m] - step + 1, 0, lv.shape[0] - 1)
        out[m] = np.maximum(lv[ia], lv[ib])
    return out.astype(np.float32)


def build_occupancy(volume, tf, *, resolution: int = 32, fine: int = 4,
                    stepsize: float, alpha_skip: float = 1e-5,
                    density_min: float = 0.0, density_max: float = 1.0,
                    chunk: int = 1 << 18) -> np.ndarray:
    """Boolean macrocell grid (R, R, R): True where a sample may add more
    than ``alpha_skip`` opacity * stepsize. Skipping the False cells moves
    a ray's image by at most ~max_steps * alpha_skip."""
    dmin, dmax = build_density_bounds(volume, resolution=resolution,
                                      fine=fine, chunk=chunk)
    opmax = tf_max_opacity(tf, dmin, dmax, density_min=density_min,
                           density_max=density_max)
    # cells wholly below the march's density floor never contribute
    below = dmax < density_min
    return np.ascontiguousarray((opmax * float(stepsize) >= alpha_skip)
                                & ~below)


def _sweep(rs: Tensor, rd: Tensor, k0t: Tensor, k0r: Tensor, tmx: Tensor,
           occ: Tensor, bm: Tensor, bs: Tensor, *, stepsize: float, seg: int,
           n_seg: int, ks: Tensor) -> Tensor:
    """(T, n_seg) bool: per tile and segment, whether a lattice point
    k = k0t + s*seg + ks of a ray with k >= k0r and k*h <= tmx lies in an
    occupied cell. rs, rd (T, tile, 3); k0t (T, 1); k0r, tmx (T, tile)."""
    h = stepsize
    r_grid = occ.shape[0]
    out = []
    for s in range(n_seg):
        kk = k0t[:, :, None] + float(s * seg) + ks            # (T, 1, K)
        t = kk * h
        alive = (kk >= k0r[..., None]) & (t <= tmx[..., None])
        pos = rs[..., None, :] + rd[..., None, :] * t[..., None]
        p01 = (pos - bm) / bs
        ix = torch.clamp((p01 * r_grid).to(torch.int32), 0, r_grid - 1).long()
        hit = occ[ix[..., 0], ix[..., 1], ix[..., 2]]
        out.append((hit & alive).flatten(1).any(dim=1))
    if not out:
        return torch.zeros(k0t.shape[0], 0, dtype=torch.bool,
                           device=k0t.device)
    return torch.stack(out, dim=1)


def make_segment_occupancy(ray_start, ray_dir, occupancy: np.ndarray,
                           box_min, box_size, *, stepsize: float,
                           seg: int, tile: int, n_seg: int,
                           max_steps: int,
                           tmax_clip: Optional[np.ndarray] = None,
                           tmin_clip: Optional[np.ndarray] = None,
                           samples_per_step: float = 1.0) -> np.ndarray:
    """The JAX package's (n_tiles, n_seg) bool mask: True iff ANY
    subsampled lattice point of ANY ray of the tile inside the segment hits
    an occupied macrocell, with the tile base k0t the minimum over the
    tile's live rays and the segments shifted past ``tmin_clip`` as the
    JAX kernel's prologue shifts them. NumPy in and out; the sweep runs in
    torch on the CPU."""
    rs = np.asarray(ray_start, np.float32)
    rd = np.asarray(ray_dir, np.float32)
    occ = np.asarray(occupancy)
    bm = np.asarray(box_min, np.float32)
    bs = np.asarray(box_size, np.float32)
    h = float(stepsize)
    n_tiles = rs.shape[0] // tile
    inv_d = 1.0 / np.where(rd == 0, 1e-12, rd)
    t0 = (bm - rs) * inv_d
    t1 = (bm + bs - rs) * inv_d
    tmin = np.maximum(np.minimum(t0, t1).max(axis=1), 0.0)
    tmax = np.maximum(t0, t1).min(axis=1)
    if tmax_clip is not None:
        tmax = np.minimum(tmax, np.asarray(tmax_clip, np.float32))
    if tmin_clip is not None:
        # a tmin-clipped plan advances k0_ray (and the tile bases) past the
        # clip: the masks index the same shifted segments
        tmin = np.maximum(tmin, np.asarray(tmin_clip, np.float32))
    k0_ray = np.ceil(tmin / h)
    k0t = np.where(tmax > tmin, k0_ray, np.inf) \
        .reshape(n_tiles, tile).min(axis=1)
    k0t = np.where(np.isfinite(k0t), k0t, 0.0).astype(np.float32)
    stride = max(1, int(round(1.0 / max(samples_per_step, 1e-6))))
    t = torch.from_numpy
    mask = _sweep(
        t(rs).reshape(n_tiles, tile, 3), t(rd).reshape(n_tiles, tile, 3),
        t(k0t)[:, None],
        t(k0_ray.astype(np.float32)).reshape(n_tiles, tile),
        t(tmax.astype(np.float32)).reshape(n_tiles, tile), t(occ),
        t(bm), t(bs), stepsize=h, seg=seg, n_seg=n_seg,
        ks=torch.arange(0, seg, stride, dtype=torch.float32))
    return mask.numpy()


def plan_segment_occupancy(plan, ray_start, ray_dir,
                           occupancy: np.ndarray, box_min, box_size, *,
                           stepsize: float, seg: int, tile: int,
                           samples_per_step: float = 1.0) -> tuple:
    """Per-bucket (tiles, segments) masks of a ``fused_dvr.RayBucketPlan``:
    :func:`make_segment_occupancy` on each group's permuted rays with the
    group's own step budget, segment count and clip. ``ray_start`` /
    ``ray_dir`` in the INPUT ray order (the plan's permutation is applied
    here)."""
    rs = np.asarray(ray_start, np.float32)[plan.perm]
    rd = np.asarray(ray_dir, np.float32)[plan.perm]
    out = []
    ofs = plan.dead
    for size, g_steps, n_seg in zip(plan.group_sizes, plan.group_steps,
                                    plan.group_segments):
        clip_g = (plan.tmax_clip[ofs:ofs + size]
                  if plan.tmax_clip is not None else None)
        out.append(make_segment_occupancy(
            rs[ofs:ofs + size], rd[ofs:ofs + size], occupancy, box_min,
            box_size, stepsize=stepsize, seg=seg, tile=tile, n_seg=n_seg,
            max_steps=g_steps, tmax_clip=clip_g,
            samples_per_step=samples_per_step))
        ofs += size
    return tuple(out)


def kernel_segment_occupancy(ray_start: Tensor, ray_dir: Tensor,
                             occupancy, box_min, box_size, *,
                             stepsize: float, seg: int, tile: int,
                             tmax_clip: Optional[Tensor] = None) -> Tensor:
    """The (n_tiles, n_seg) bool mask of the port's megakernel route, on the
    rays' device: every lattice sample the kernel would take (its tile base
    k0t over every ray of the tile, each ray's k0_ray and clipped tmax, as
    ``fused_mega.ray_packet`` computes them) is tested against the occupied
    macrocells, and n_seg is the kernel's own segment bound
    (``fused_mega.segments_needed``)."""
    dev = ray_start.device
    rays = ray_packet(ray_start, ray_dir, box_min, box_size, stepsize,
                      tmax_clip)
    packet, k0r, tmx, k0t = _tile_geometry(rays, tile)
    n_seg = _segments_needed(k0r, tmx, k0t, stepsize, seg)
    occ = torch.as_tensor(np.asarray(occupancy), device=dev)
    with torch.no_grad():
        return _sweep(packet[..., 0:3], packet[..., 3:6],
                      torch.where(torch.isfinite(k0t), k0t,
                                  torch.zeros_like(k0t)),
                      k0r, tmx, occ, _f32(box_min, dev), _f32(box_size, dev),
                      stepsize=stepsize, seg=seg, n_seg=n_seg,
                      ks=torch.arange(seg, dtype=torch.float32, device=dev))
