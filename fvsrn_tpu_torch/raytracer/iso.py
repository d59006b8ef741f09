"""Isosurface ray evaluation: first hit, bisection, shading. Plain PyTorch.

Counterpart of ``fvsrn_tpu/raytracer/iso.py``: march at constant steps
until the density exceeds the isovalue, refine the hit by
``binary_search_steps`` bisections between the last outside and the
first inside sample, then shade with ``dot(normal, ray_dir)``.
``refine_and_shade`` is per-ray work and serves both the plain march
(``trace_iso``) and the fused one (``ops.fused_dvr.fused_trace_iso``).
Only ``surface_feature="off"`` is ported; the curvature features need
``eval_curvature`` and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import Tensor

from ..utils.device import strict_f32
from ..utils.vecmath import intersect_aabb, safe_normalize
from .dvr import RayEvaluationOutput

SURFACE_FEATURE_OFF = "off"


def _f32(v) -> float:
    return float(torch.tensor(float(v), dtype=torch.float32))


@dataclass(frozen=True)
class RayEvaluationSteppingIso:
    """Configuration of the isosurface evaluator; numbers rounded to
    float32 as the JAX package stores them."""
    stepsize: float = 0.005
    isovalue: float = 0.5
    binary_search_steps: int = 8
    surface_feature: str = SURFACE_FEATURE_OFF

    @classmethod
    def make(cls, stepsize=0.005, isovalue=0.5, binary_search_steps=8,
             surface_feature=SURFACE_FEATURE_OFF
             ) -> "RayEvaluationSteppingIso":
        if surface_feature != SURFACE_FEATURE_OFF:
            raise NotImplementedError(
                f"surface feature {surface_feature!r} needs eval_curvature, "
                "which is not ported yet")
        return cls(stepsize=_f32(stepsize), isovalue=_f32(isovalue),
                   binary_search_steps=int(binary_search_steps),
                   surface_feature=surface_feature)


def _shade(volume: Any, position: Tensor, ray_dir: Tensor, found: Tensor):
    """(color, normal) at the hit: white times dot(normal, ray_dir),
    alpha 1, zero where nothing was found."""
    n = safe_normalize(volume.eval_normal(position, ray_dir))
    shade = torch.sum(n * ray_dir, dim=-1, keepdim=True)
    color = torch.cat([shade.expand(shade.shape[:-1] + (3,)),
                       torch.ones_like(shade)], dim=-1)
    return (torch.where(found, color, torch.zeros_like(color)),
            torch.where(found, n, torch.zeros_like(n)))


@torch.no_grad()
def refine_and_shade(ray_start: Tensor, ray_dir: Tensor, volume: Any,
                     config: RayEvaluationSteppingIso, depth: Tensor,
                     found: Tensor) -> RayEvaluationOutput:
    """Bisection between depth - stepsize and depth, then shading.
    ``depth`` (..., 1) float, ``found`` (..., 1) bool."""
    h = float(config.stepsize)
    iso = float(config.isovalue)
    d_out = depth - h
    d_in = depth
    for _ in range(config.binary_search_steps):
        d_test = 0.5 * (d_out + d_in)
        value = volume.eval_density(ray_start + ray_dir * d_test,
                                    ray_dir)[0][..., None]
        inside = found & (value > iso)
        depth = torch.where(inside, d_test, depth)
        d_in = torch.where(inside, d_test, d_in)
        d_out = torch.where(inside, d_out, d_test)
    color, _ = _shade(volume, ray_start + ray_dir * depth, ray_dir, found)
    return RayEvaluationOutput(color=color, depth=depth)


@torch.no_grad()
def trace_iso(ray_start: Tensor, ray_dir: Tensor, volume: Any,
              config: RayEvaluationSteppingIso, max_steps: int,
              tmax_in: Optional[Tensor] = None,
              lattice: bool = False) -> RayEvaluationOutput:
    """The plain first-hit march of rays (..., 3) through ``volume``,
    per-ray sampling t = tmin + i*h, or the global lattice with
    ``lattice=True``; then :func:`refine_and_shade`."""
    strict_f32()
    dtype = ray_start.dtype
    tmin, tmax = intersect_aabb(ray_start, ray_dir,
                                volume.box_min.to(dtype),
                                volume.box_size.to(dtype))
    tmin = torch.clamp(tmin, min=0.0)
    if tmax_in is not None:
        tmax = torch.minimum(tmax, tmax_in.reshape(tmax.shape).to(dtype))
    h = float(config.stepsize)
    iso = float(config.isovalue)
    depth = torch.zeros_like(tmin)
    found = torch.zeros(tmin.shape, dtype=torch.bool, device=tmin.device)
    k0 = torch.ceil(tmin / h) if lattice else None
    for i in range(max_steps):
        t = (k0 + float(i)) * h if lattice else tmin + float(i) * h
        valid = (t <= tmax) & ~found
        value = volume.eval_density(ray_start + ray_dir * t,
                                    ray_dir)[0][..., None]
        inside = valid & (value > iso)
        depth = torch.where(inside, t, depth)
        found = found | inside
    return refine_and_shade(ray_start, ray_dir, volume, config, depth, found)

