"""Vector math on channel-last tensors (the xyz component axis is last).

Counterpart of ``fvsrn_tpu/utils/vecmath.py``.
"""
from __future__ import annotations

import torch
from torch import Tensor


def dot(a: Tensor, b: Tensor, keepdim: bool = True) -> Tensor:
    """Sum of a * b over the last axis."""
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: Tensor) -> Tensor:
    """Normalize along the last axis (no epsilon, like the reference's
    plain ``normalize``)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def safe_normalize(v: Tensor) -> Tensor:
    """v / |v|, or 0 where |v|^2 <= 1e-12 (the reference's
    ``safeNormalize``)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=1e-20))
    return torch.where(n2 > 1e-12, v / n, torch.zeros_like(v))


def intersect_aabb(ray_start: Tensor, ray_dir: Tensor, box_min: Tensor,
                   box_size: Tensor) -> tuple[Tensor, Tensor]:
    """Ray/AABB intersection by the slab method. All inputs broadcast;
    returns (tmin, tmax), each (..., 1)."""
    inv_dir = 1.0 / ray_dir
    t135 = (box_min - ray_start) * inv_dir
    t246 = (box_min + box_size - ray_start) * inv_dir
    tmin = torch.amax(torch.minimum(t135, t246), dim=-1, keepdim=True)
    tmax = torch.amin(torch.maximum(t135, t246), dim=-1, keepdim=True)
    return tmin, tmax
