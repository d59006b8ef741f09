"""Transfer functions.

Counterpart of ``fvsrn_tpu/transfer.py`` for the piecewise-linear TF,
which both benchmark scenes use. ``eval_normalized`` takes a density
already mapped to [0, 1] and returns rgba whose absorption channel is
already multiplied by the stepsize; :func:`evaluate` is the tensor-level
evaluation of raw (N, 1) densities that world-space training and
importance sampling call.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


class TransferFunctionPiecewiseLinear:
    """Piecewise-linear TF over control points. ``tensor`` is (R, 5):
    [r, g, b, absorption, position], positions ascending in [0, 1]."""

    def __init__(self, tensor: Tensor):
        self.tensor = tensor

    @classmethod
    def make(cls, rgb, opacity, positions) -> "TransferFunctionPiecewiseLinear":
        rgb = torch.tensor(rgb, dtype=torch.float32)
        opacity = torch.tensor(opacity, dtype=torch.float32)[:, None]
        positions = torch.tensor(positions, dtype=torch.float32)[:, None]
        return cls(torch.cat([rgb, opacity, positions], dim=-1))

    def max_absorption(self) -> Tensor:
        """The largest absorption of any control point."""
        return torch.max(self.tensor[..., 3])

    def to(self, device) -> "TransferFunctionPiecewiseLinear":
        return TransferFunctionPiecewiseLinear(self.tensor.to(device))

    def eval_normalized(self, density: Tensor, normal=None,
                        previous_density=None, stepsize=1.0) -> Tensor:
        tf = self.tensor
        r = tf.shape[0]
        d = torch.clamp(density, 0.0, 1.0)
        pos = tf[:, 4].contiguous()
        # smallest i with pos[i+1] > d, else R-2
        i = torch.clamp(torch.searchsorted(pos, d.contiguous(), right=True)
                        - 1, 0, r - 2)
        val0 = tf[i, :4]
        val1 = tf[i + 1, :4]
        p0 = pos[i]
        p1 = pos[i + 1]
        frac = (torch.minimum(torch.maximum(d, p0), p1) - p0) / (p1 - p0)
        rgba = val0 + (val1 - val0) * frac[..., None]
        return torch.cat([rgba[..., :3], rgba[..., 3:4] * stepsize], dim=-1)


def evaluate(tf, density: Tensor, density_min: float, density_max: float,
             stepsize: Optional[float] = None) -> Tensor:
    """Colors (N, 4) of densities (N, 1) mapped from [density_min,
    density_max] to [0, 1]; densities below density_min give (0, 0, 0, 0).
    The absorption is scaled by ``stepsize`` (1 when None)."""
    d = density[..., 0]
    inv_range = 1.0 / (density_max - density_min)
    color = tf.eval_normalized((d - density_min) * inv_range, None, None,
                               1.0 if stepsize is None else stepsize)
    return torch.where((d >= density_min)[..., None], color,
                       torch.zeros_like(color))
