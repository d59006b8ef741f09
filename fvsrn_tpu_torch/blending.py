"""Front-to-back "over" compositing of per-step contributions.

Counterpart of ``fvsrn_tpu/blending.py``. The contribution carries its
absorption (already scaled by the stepsize) in the w channel:
``beer_lambert`` turns it into alpha = 1 - exp(-absorption), ``alpha``
into min(1, absorption).
"""
from __future__ import annotations

import torch
from torch import Tensor

BLEND_BEER_LAMBERT = "beer_lambert"
BLEND_ALPHA = "alpha"


def current_alpha(absorption: Tensor, mode: str) -> Tensor:
    if mode == BLEND_BEER_LAMBERT:
        return 1.0 - torch.exp(-absorption)
    if mode == BLEND_ALPHA:
        return torch.clamp(absorption, max=1.0)
    raise ValueError(f"unknown blend mode {mode}")


def blend_step(acc_rgb: Tensor, acc_alpha: Tensor, contrib_rgba: Tensor,
               mode: str = BLEND_BEER_LAMBERT,
               acc_normal: Tensor | None = None,
               contrib_normal: Tensor | None = None,
               acc_depth: Tensor | None = None,
               contrib_depth: Tensor | None = None):
    """One front-to-back step: acc_rgb (..., 3), acc_alpha (..., 1),
    contrib_rgba (..., 4). Returns the updated accumulators, then normal
    and depth where given (each blended with the same weight as color)."""
    ca = current_alpha(contrib_rgba[..., 3:4], mode)
    w = (1.0 - acc_alpha) * ca
    out_rgb = acc_rgb + w * contrib_rgba[..., :3]
    out_alpha = acc_alpha + (1.0 - acc_alpha) * ca
    extras = []
    if acc_normal is not None:
        extras.append(acc_normal + w * contrib_normal)
    if acc_depth is not None:
        extras.append(acc_depth + w * contrib_depth)
    return (out_rgb, out_alpha, *extras)
