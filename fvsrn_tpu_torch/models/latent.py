"""Latent spaces: keyframe vectors and volumetric latent grids.

Counterpart of ``fvsrn_tpu/models/latent.py``:

- ``interp1d``: piecewise-linear interpolation of latent vectors over
  their keyframes 0..N-1;
- ``grid_sample_3d``: trilinear sampling with ``F.grid_sample``
  semantics (``align_corners=False``, border clamping);
- ``keyframe_grid_sample`` / ``keyframe_lerp``: a keyframed grid stack
  (K, C, D, H, W) at a scalar time, sampled and then lerped, or lerped
  into one grid first (equal, since the trilerp is linear in the grid's
  values); ``resolve_grid`` collapses a latent space's time and ensemble
  grids into the one static grid the fused marches take;
- ``LatentSpace``: a static grid, time and ensemble keyframed grids and
  latent vectors, the conditioning the SRN concatenates to its inputs.

A keyframe index ``t`` brackets keyframes ``clip(floor(t), 0, K-1)`` and
the next one (the last one past the end); its fraction ``t - floor`` is
not clipped, so a negative ``t`` extrapolates, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import Tensor, nn

from ..utils.device import constant


def grid_sample_3d(grid: Tensor, pos01: Tensor) -> Tensor:
    """Trilinear lookup of ``grid`` (C, D, H, W), with (D, H, W) indexed
    by (z, y, x), at ``pos01`` (..., 3) in (x, y, z) order. Returns
    (..., C)."""
    c, dd, hh, ww = grid.shape
    lead = pos01.shape[:-1]
    p = pos01.reshape(-1, 3)
    sizes = constant((ww, hh, dd), p.dtype, p.device)
    # align_corners=False: voxel centers at (i + 0.5) / S
    v = p * sizes - 0.5
    fl = torch.floor(v)
    f = v - fl
    i0 = fl.to(torch.int64)
    maxi = constant((ww - 1, hh - 1, dd - 1), torch.int64, p.device)
    lo = torch.minimum(torch.clamp(i0, min=0), maxi)
    hi = torch.minimum(torch.clamp(i0 + 1, min=0), maxi)
    # channel-last rows: one (N, C) gather per corner
    table = grid.permute(1, 2, 3, 0).reshape(-1, c)

    def gather(ix, iy, iz):
        return table[(iz * hh + iy) * ww + ix]

    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    c000 = gather(lo[:, 0], lo[:, 1], lo[:, 2])
    c100 = gather(hi[:, 0], lo[:, 1], lo[:, 2])
    c010 = gather(lo[:, 0], hi[:, 1], lo[:, 2])
    c110 = gather(hi[:, 0], hi[:, 1], lo[:, 2])
    c001 = gather(lo[:, 0], lo[:, 1], hi[:, 2])
    c101 = gather(hi[:, 0], lo[:, 1], hi[:, 2])
    c011 = gather(lo[:, 0], hi[:, 1], hi[:, 2])
    c111 = gather(hi[:, 0], hi[:, 1], hi[:, 2])
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return (c0 + (c1 - c0) * fz).reshape(lead + (c,))


def interp1d(fp: Tensor, x: Tensor) -> Tensor:
    """Piecewise-linear interpolation of ``fp`` (B, C, N) at positions
    ``x`` (B, M) in keyframe units, clipped to [0, N-1]: (B, C, M)."""
    n = fp.shape[-1]
    xc = torch.clamp(x.to(fp.dtype), 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(xc).to(torch.int64), 0, n - 2)
    f = xc - i0.to(fp.dtype)
    idx = i0[:, None, :].expand(fp.shape[0], fp.shape[1], x.shape[1])
    v0 = torch.gather(fp, -1, idx)
    v1 = torch.gather(fp, -1, idx + 1)
    return v0 + (v1 - v0) * f[:, None, :]


Time = Union[float, Tensor]


def _bracket(t: Time, k: int):
    """(lo, hi, f) of a scalar keyframe index ``t`` over ``k`` keyframes,
    in float32: Python ints and a float for a number, tensors for a
    tensor (no host read of the device's value)."""
    if isinstance(t, Tensor):
        t = t.reshape(()).to(torch.float32)
        tc = torch.clamp(torch.floor(t), 0, k - 1)
        hi = torch.clamp(tc + 1, max=k - 1)
        return tc.to(torch.int64), hi.to(torch.int64), t - tc
    t = np.float32(t)
    tc = np.float32(min(max(np.floor(t), 0), k - 1))
    return int(tc), min(int(tc) + 1, k - 1), float(np.float32(t - tc))


def _keyframe(grids: Tensor, i) -> Tensor:
    """Keyframe ``i`` (a Python int or a 0-d tensor) of ``grids``; the
    others get exactly zero gradient."""
    if isinstance(i, Tensor):
        return grids.index_select(0, i.reshape(1))[0]
    return grids[i]


def keyframe_grid_sample(grids: Tensor, pos01: Tensor, t: Time) -> Tensor:
    """Sample a keyframed grid stack (K, C, D, H, W) at positions
    ``pos01`` (..., 3): trilerp both keyframes bracketing the scalar
    ``t``, then lerp in time. Returns (..., C)."""
    lo, hi, f = _bracket(t, grids.shape[0])
    a = grid_sample_3d(_keyframe(grids, lo), pos01)
    b = grid_sample_3d(_keyframe(grids, hi), pos01)
    return a + (b - a) * f


def keyframe_lerp(grids: Tensor, t: Time) -> Tensor:
    """The keyframed grid stack (K, C, D, H, W) lerped at the scalar
    ``t`` into one (C, D, H, W) grid: equal to :func:`keyframe_grid_sample`
    to float precision, gradients to both bracketing keyframes."""
    lo, hi, f = _bracket(t, grids.shape[0])
    a = _keyframe(grids, lo)
    return a + (_keyframe(grids, hi) - a) * f


def resolve_grid(latent, time: Time = 0.0,
                 ensemble: Time = 0.0) -> Optional[Tensor]:
    """The latent space's volumetric grids as one static (C, D, H, W)
    grid at scalar (time, ensemble): the time grid's channels, then the
    ensemble grid's, for a time-dependent space (grids of unequal
    resolution raise ``ValueError``); the static grid otherwise. None
    without a grid."""
    if not latent.time_dependent:
        return latent.static_grid
    feats = []
    if latent.time_grid is not None:
        feats.append(keyframe_lerp(latent.time_grid, time))
    if latent.ensemble_grid is not None:
        feats.append(keyframe_lerp(latent.ensemble_grid, ensemble))
    if not feats:
        return None
    if len(feats) == 1:
        return feats[0]
    if feats[0].shape[1:] != feats[1].shape[1:]:
        raise ValueError(
            "fused path requires time and ensemble grids of equal "
            f"resolution, got {tuple(feats[0].shape)} vs "
            f"{tuple(feats[1].shape)}")
    return torch.cat(feats, dim=0)


def _param(t: Optional[Tensor]) -> Optional[nn.Parameter]:
    return nn.Parameter(t) if t is not None else None


class LatentSpace(nn.Module):
    """Latent conditioning of the SRN. A time-dependent space
    (``time_dependent``) is conditioned by its keyframed grids, the time
    grid (T, Ct, R, R, R) and the ensemble grid (E, Ce, R, R, R), and
    ignores its vectors; any other by its latent vectors, (1, C, K) each,
    and its static grid (C, R, R, R)."""

    def __init__(self, static_grid: Optional[Tensor] = None,
                 time_grid: Optional[Tensor] = None,
                 ensemble_grid: Optional[Tensor] = None,
                 time_vector: Optional[Tensor] = None,
                 ensemble_vector: Optional[Tensor] = None,
                 time_dependent: bool = False):
        super().__init__()
        self.static_grid = _param(static_grid)
        self.time_grid = _param(time_grid)
        self.ensemble_grid = _param(ensemble_grid)
        self.time_vector = _param(time_vector)
        self.ensemble_vector = _param(ensemble_vector)
        self.time_dependent = bool(time_dependent)

    @property
    def total_channels(self) -> int:
        if self.time_dependent:
            grids = (self.time_grid, self.ensemble_grid)
            return sum(g.shape[1] for g in grids if g is not None)
        c = sum(v.shape[1] for v in (self.ensemble_vector, self.time_vector)
                if v is not None)
        if self.static_grid is not None:
            c += self.static_grid.shape[0]
        return c

    def evaluate(self, x: Tensor, time: Optional[Tensor] = None,
                 ensemble: Optional[Tensor] = None) -> list[Tensor]:
        """Latent feature blocks (N, C_i) for positions x (N, 3) in
        [0, 1]^3, in the order of the SRN's input: the time grid, then the
        ensemble grid, sampled at ``time[0]`` and ``ensemble[0]`` (the
        batch is uniform there); or the ensemble vector at ``ensemble``
        (N,), the time vector at ``time`` (N,), then the static grid.
        ``time``/``ensemble`` default to zeros."""
        n = x.shape[0]
        if time is None:
            time = x.new_zeros(n)
        if ensemble is None:
            ensemble = x.new_zeros(n)
        feats = []
        if self.time_dependent:
            if self.time_grid is not None:
                feats.append(keyframe_grid_sample(self.time_grid, x,
                                                  time.reshape(-1)[0]))
            if self.ensemble_grid is not None:
                feats.append(keyframe_grid_sample(
                    self.ensemble_grid, x, ensemble.reshape(-1)[0]))
            return feats
        for vec, at in ((self.ensemble_vector, ensemble),
                        (self.time_vector, time)):
            if vec is not None:
                feats.append(interp1d(vec, at.reshape(1, -1))[0].T)
        if self.static_grid is not None:
            feats.append(grid_sample_3d(self.static_grid, x))
        return feats
