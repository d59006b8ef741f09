"""Voxel-grid volume interpolation, plain PyTorch on the grid's device.

Counterpart of ``fvsrn_tpu/volume/grid.py``, which the JAX package
computes outside any Pallas kernel. A world position p in [box_min,
box_min + box_size] maps to voxel space v = (p - box_min) / box_size *
res (res - 1 with ``old_resolution_behavior``); the data is indexed
[x, y, z].

- ``sample_nearest``: the voxel at round(v), half to even, clamped;
- ``sample_linear``: corners floor(v) and floor(v) + 1, each clamped to
  [0, res - 1] on its own, the fraction from the unclamped floor;
- ``sample_cubic``: the cubic B-spline as 8 trilinear fetches;
- ``VolumeInterpolationGrid``: density and inside test, the
  central-difference normal (one voxel step) and the principal
  curvatures of the projected Hessian (Kindlmann et al.).

The gathers index the flattened grid. Every per-call constant is a Python
number or a tensor made when the grid is, so sampling copies nothing from
the host (a small host-to-device copy waits for the card's queue).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def _gather3d(data: Tensor, ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
    """data (X, Y, Z) at integer index tensors (...,)."""
    _, ny, nz = data.shape
    return data.reshape(-1)[(ix * ny + iy) * nz + iz]


def _clamped(ipos: Tensor, shape) -> list[Tensor]:
    """Each axis of the integer positions (..., 3) clamped to [0, n - 1]."""
    return [torch.clamp(ipos[..., a], 0, n - 1) for a, n in enumerate(shape)]


def sample_nearest(data: Tensor, pos_voxel: Tensor) -> Tensor:
    ipos = _clamped(torch.round(pos_voxel).to(torch.int64), data.shape)
    return _gather3d(data, *ipos)


def sample_linear(data: Tensor, pos_voxel: Tensor) -> Tensor:
    """Trilinear sampling at voxel-space positions (..., 3)."""
    fl = torch.floor(pos_voxel)
    ipos = fl.to(torch.int64)
    f = pos_voxel - fl
    (lx, ly, lz) = _clamped(ipos, data.shape)
    (hx, hy, hz) = _clamped(ipos + 1, data.shape)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    d000 = _gather3d(data, lx, ly, lz)
    d001 = _gather3d(data, lx, ly, hz)
    d010 = _gather3d(data, lx, hy, lz)
    d011 = _gather3d(data, lx, hy, hz)
    d100 = _gather3d(data, hx, ly, lz)
    d101 = _gather3d(data, hx, ly, hz)
    d110 = _gather3d(data, hx, hy, lz)
    d111 = _gather3d(data, hx, hy, hz)
    c00 = d000 + (d100 - d000) * fx
    c10 = d010 + (d110 - d010) * fx
    c01 = d001 + (d101 - d001) * fx
    c11 = d011 + (d111 - d011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def _bspline_weights(frac: Tensor):
    """Cubic B-spline convolution weights (after Ruijters)."""
    one_frac = 1.0 - frac
    squared = frac * frac
    one_sqd = one_frac * one_frac
    w0 = (1.0 / 6.0) * one_sqd * one_frac
    w1 = 2.0 / 3.0 - 0.5 * squared * (2.0 - frac)
    w2 = 2.0 / 3.0 - 0.5 * one_sqd * (2.0 - one_frac)
    w3 = (1.0 / 6.0) * squared * frac
    return w0, w1, w2, w3


def sample_cubic(data: Tensor, pos_voxel: Tensor) -> Tensor:
    """Tricubic B-spline sampling from 8 trilinear fetches."""
    coord_grid = pos_voxel - 0.5
    index = torch.floor(coord_grid)
    fraction = coord_grid - index
    w0, w1, w2, w3 = _bspline_weights(fraction)
    g0 = w0 + w1
    g1 = w2 + w3
    h0 = (w1 / g0) - 0.5 + index
    h1 = (w3 / g1) + 1.5 + index

    def fetch(hx, hy, hz):
        return sample_linear(data, torch.stack([hx, hy, hz], dim=-1))

    h0x, h0y, h0z = h0[..., 0], h0[..., 1], h0[..., 2]
    h1x, h1y, h1z = h1[..., 0], h1[..., 1], h1[..., 2]
    g0x, g0y, g0z = g0[..., 0], g0[..., 1], g0[..., 2]
    g1x, g1y, g1z = g1[..., 0], g1[..., 1], g1[..., 2]

    t000 = g0x * fetch(h0x, h0y, h0z) + g1x * fetch(h1x, h0y, h0z)
    t010 = g0x * fetch(h0x, h1y, h0z) + g1x * fetch(h1x, h1y, h0z)
    t000 = g0y * t000 + g1y * t010
    t001 = g0x * fetch(h0x, h0y, h1z) + g1x * fetch(h1x, h0y, h1z)
    t011 = g0x * fetch(h0x, h1y, h1z) + g1x * fetch(h1x, h1y, h1z)
    t001 = g0y * t001 + g1y * t011
    return g0z * t000 + g1z * t001


SAMPLERS = {
    "nearest": sample_nearest,
    "trilinear": sample_linear,
    "tricubic": sample_cubic,
}


class VolumeInterpolationGrid:
    """A voxel grid as a volume. ``data``: (X, Y, Z) or batched (B, X,
    Y, Z) float32 densities, indexed [x][y][z]; ``box_min``,
    ``box_size``: (3,) float32 tensors on the data's device."""

    def __init__(self, data: Tensor, box_min: Tensor, box_size: Tensor,
                 interpolation: str = "trilinear",
                 old_resolution_behavior: bool = False):
        if interpolation not in SAMPLERS:
            raise ValueError(f"unknown interpolation {interpolation!r}")
        # row-major, so that the gathers' flattening is a view: a volume
        # file's array arrives transposed, and flattening that copies the
        # whole grid at every gather
        self.data = data.contiguous()
        self.box_min = box_min
        self.box_size = box_size
        self.interpolation = interpolation
        self.old_resolution_behavior = old_resolution_behavior
        res = torch.tensor(data.shape[-3:], dtype=torch.float32,
                           device=data.device)
        self._resm1 = res - 1
        self._scale = res - 1 if old_resolution_behavior else res

    @classmethod
    def from_grid(cls, data, interpolation: str = "trilinear",
                  box_min=None, box_size=None,
                  old_resolution_behavior: bool = False
                  ) -> "VolumeInterpolationGrid":
        """From an array or tensor (kept on its device; NumPy on the
        CPU). Default box: voxel size 1 / max(res), world size res x
        voxel size, centered at the origin."""
        data = torch.as_tensor(np.asarray(data) if not isinstance(
            data, torch.Tensor) else data).to(torch.float32)
        res = np.asarray(data.shape[-3:], np.float64)
        if box_size is None:
            box_size = res * (1.0 / res.max())
        if box_min is None:
            box_min = -np.asarray(box_size, np.float64) / 2.0
        f32 = dict(dtype=torch.float32, device=data.device)
        return cls(data,
                   torch.as_tensor(np.asarray(box_min, np.float32), **f32),
                   torch.as_tensor(np.asarray(box_size, np.float32), **f32),
                   interpolation, old_resolution_behavior)

    def to(self, device) -> "VolumeInterpolationGrid":
        return VolumeInterpolationGrid(
            self.data.to(device), self.box_min.to(device),
            self.box_size.to(device), self.interpolation,
            self.old_resolution_behavior)

    @property
    def batch(self) -> int:
        return self.data.shape[0] if self.data.ndim == 4 else 1

    @property
    def resolution(self) -> tuple[int, int, int]:
        return tuple(self.data.shape[-3:])

    def _data(self, b: int) -> Tensor:
        return self.data[b] if self.data.ndim == 4 else self.data

    def _to_voxel(self, position: Tensor) -> Tensor:
        return (position - self.box_min) / self.box_size * self._scale

    def eval_density(self, position: Tensor, direction=None, b: int = 0):
        """World position (..., 3) -> (density (...,), inside (...,)),
        inside tested in voxel space against [0, res - 1]."""
        pos_voxel = self._to_voxel(position)
        inside = ((pos_voxel >= 0).all(dim=-1)
                  & (pos_voxel <= self._resm1).all(dim=-1))
        value = SAMPLERS[self.interpolation](self._data(b), pos_voxel)
        return value, inside

    def eval_normal(self, position: Tensor, direction=None,
                    b: int = 0) -> Tensor:
        """Central-difference density gradient (..., 3): one voxel step,
        scaled by 0.5 / voxel size."""
        pos_voxel = self._to_voxel(position)
        data = self._data(b)
        normal_scale = 0.5 / (self.box_size / self._scale)
        sampler = SAMPLERS[self.interpolation]
        offs = torch.eye(3, dtype=position.dtype, device=position.device)
        return torch.stack(
            [normal_scale[i] * (sampler(data, pos_voxel + offs[i])
                                - sampler(data, pos_voxel - offs[i]))
             for i in range(3)], dim=-1)

    def eval_curvature(self, position: Tensor, direction=None,
                       b: int = 0) -> Tensor:
        """Principal curvatures (k1, k2), (..., 2), from the Hessian
        projected onto the tangent plane: G = -(P H P) / |g| with P = I -
        n n^T, n = -g / |g| (|g| clamped at 1e-7), T = trace(G), F =
        |G|_F, k = (T +- sqrt(max(2F^2 - T^2, 0))) / 2. H is the
        symmetrized central difference of ``eval_normal`` at one voxel."""
        g = self.eval_normal(position, direction, b)
        g_norm = torch.clamp(torch.linalg.vector_norm(g, dim=-1,
                                                      keepdim=True),
                             min=1e-7)
        n = -g / g_norm
        eye = torch.eye(3, dtype=position.dtype, device=position.device)
        P = eye - n[..., :, None] * n[..., None, :]
        h = self.box_size / self._scale
        denom = 1.0 / (2 * h)
        offs = eye * h
        cols = [denom[i] * (self.eval_normal(position + offs[i], direction, b)
                            - self.eval_normal(position - offs[i], direction,
                                               b))
                for i in range(3)]
        Hprime = torch.stack(cols, dim=-1)
        H = 0.5 * (Hprime + Hprime.transpose(-1, -2))
        G = (-1.0 / g_norm[..., None]) * (P @ H @ P)
        T = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
        F = torch.linalg.matrix_norm(G)
        discr = torch.sqrt(torch.clamp(2 * F * F - T * T, min=0.0))
        return torch.stack([0.5 * (T + discr), 0.5 * (T - discr)], dim=-1)
