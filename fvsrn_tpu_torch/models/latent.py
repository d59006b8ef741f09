"""Volumetric latent grids.

Counterpart of ``fvsrn_tpu/models/latent.py`` for a static grid:
``grid_sample_3d`` is trilinear sampling with ``F.grid_sample``
semantics (``align_corners=False``, border clamping), and
``LatentSpace`` holds the (C, D, H, W) grid the SRN concatenates to its
inputs. Keyframed (time / ensemble) grids and latent vectors are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn


def grid_sample_3d(grid: Tensor, pos01: Tensor) -> Tensor:
    """Trilinear lookup of ``grid`` (C, D, H, W), with (D, H, W) indexed
    by (z, y, x), at ``pos01`` (..., 3) in (x, y, z) order. Returns
    (..., C)."""
    c, dd, hh, ww = grid.shape
    lead = pos01.shape[:-1]
    p = pos01.reshape(-1, 3)
    sizes = torch.tensor([ww, hh, dd], dtype=p.dtype, device=p.device)
    # align_corners=False: voxel centers at (i + 0.5) / S
    v = p * sizes - 0.5
    fl = torch.floor(v)
    f = v - fl
    i0 = fl.to(torch.int64)
    maxi = torch.tensor([ww - 1, hh - 1, dd - 1], device=p.device)
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


class LatentSpace(nn.Module):
    """Latent conditioning of the SRN: an optional static (C, D, H, W)
    grid."""

    def __init__(self, static_grid: Optional[Tensor] = None):
        super().__init__()
        self.static_grid = (nn.Parameter(static_grid)
                            if static_grid is not None else None)

    @property
    def total_channels(self) -> int:
        return 0 if self.static_grid is None else self.static_grid.shape[0]

    def evaluate(self, x: Tensor) -> list[Tensor]:
        """Latent feature blocks for positions x (N, 3) in [0, 1]^3."""
        if self.static_grid is None:
            return []
        return [grid_sample_3d(self.static_grid, x)]
