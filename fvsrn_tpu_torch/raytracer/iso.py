"""Isosurface ray evaluation: first hit, bisection, shading. Plain PyTorch.

Counterpart of ``fvsrn_tpu/raytracer/iso.py``: march at constant steps
until the density exceeds the isovalue, refine the hit by
``binary_search_steps`` bisections between the last outside and the
first inside sample, then shade with ``dot(normal, ray_dir)``.
``refine_and_shade`` is per-ray work and serves both the plain march
(``trace_iso``) and the fused one (``ops.fused_dvr.fused_trace_iso``).
A surface feature colors the hit from the volume's principal curvatures
(``eval_curvature``, which voxel grids have): the first or second
principal curvature, their mean or product through a 1D isocontour
texture, or both through a 2D one (``curvature_texture``). On a volume
without ``eval_curvature`` a feature raises ``AttributeError``, as in the
JAX package.
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
SURFACE_FEATURE_CURVATURE_TEXTURE = "curvature_texture"
SURFACE_FEATURE_FIRST = "first_principal"
SURFACE_FEATURE_SECOND = "second_principal"
SURFACE_FEATURE_MEAN = "mean"
SURFACE_FEATURE_GAUSSIAN = "gaussian"
SURFACE_FEATURES = (SURFACE_FEATURE_OFF, SURFACE_FEATURE_CURVATURE_TEXTURE,
                    SURFACE_FEATURE_FIRST, SURFACE_FEATURE_SECOND,
                    SURFACE_FEATURE_MEAN, SURFACE_FEATURE_GAUSSIAN)


def _f32(v) -> float:
    return float(torch.tensor(float(v), dtype=torch.float32))


@dataclass(frozen=True, eq=False)
class RayEvaluationSteppingIso:
    """Configuration of the isosurface evaluator; numbers rounded to
    float32 as the JAX package stores them. ``isocontour_texture``: (R, 4)
    for the 1D features, (R, R, 4) for ``curvature_texture``, indexed by
    the feature mapped from [-range, range] to [0, 1]."""
    stepsize: float = 0.005
    isovalue: float = 0.5
    binary_search_steps: int = 8
    surface_feature: str = SURFACE_FEATURE_OFF
    isocontour_range: float = 1.0
    isocontour_texture: Optional[Tensor] = None

    @classmethod
    def make(cls, stepsize=0.005, isovalue=0.5, binary_search_steps=8,
             surface_feature=SURFACE_FEATURE_OFF, isocontour_range=1.0,
             isocontour_texture=None) -> "RayEvaluationSteppingIso":
        if surface_feature not in SURFACE_FEATURES:
            raise ValueError(f"unknown surface feature {surface_feature!r}")
        if isocontour_texture is not None:
            isocontour_texture = torch.as_tensor(isocontour_texture,
                                                 dtype=torch.float32)
        return cls(stepsize=_f32(stepsize), isovalue=_f32(isovalue),
                   binary_search_steps=int(binary_search_steps),
                   surface_feature=surface_feature,
                   isocontour_range=_f32(isocontour_range),
                   isocontour_texture=isocontour_texture)


def _feature_color(config: RayEvaluationSteppingIso, volume: Any,
                   position: Tensor, ray_dir: Tensor, b: int) -> Tensor:
    """(..., 4) color of the surface feature at the hit."""
    curv = volume.eval_curvature(position, ray_dir, b=b)
    rng = config.isocontour_range
    tex = config.isocontour_texture.to(position.device)
    r = tex.shape[0]
    feature = config.surface_feature
    if feature == SURFACE_FEATURE_CURVATURE_TEXTURE:
        tx = (curv[..., 0] + rng) / (2 * rng)
        ty = (-curv[..., 1] + rng) / (2 * rng)
        ix = torch.clamp((tx * r).to(torch.int64), 0, r - 1)
        iy = torch.clamp((ty * r).to(torch.int64), 0, r - 1)
        return tex[iy, ix]
    if feature == SURFACE_FEATURE_FIRST:
        f = curv[..., 0]
    elif feature == SURFACE_FEATURE_SECOND:
        f = curv[..., 1]
    elif feature == SURFACE_FEATURE_MEAN:
        f = 0.5 * (curv[..., 0] + curv[..., 1])
    else:
        f = curv[..., 0] * curv[..., 1]
    f = (f + rng) / (2 * rng)
    return tex[torch.clamp((f * r).to(torch.int64), 0, r - 1)]


def _shade(config: RayEvaluationSteppingIso, volume: Any, position: Tensor,
           ray_dir: Tensor, found: Tensor, b: int):
    """(color, normal) at the hit: the feature's color (white when off)
    times dot(normal, ray_dir), alpha 1, zero where nothing was found."""
    n = safe_normalize(volume.eval_normal(position, ray_dir, b=b))
    shade = torch.sum(n * ray_dir, dim=-1, keepdim=True)
    if config.surface_feature == SURFACE_FEATURE_OFF:
        color = torch.cat([shade.expand(shade.shape[:-1] + (3,)),
                           torch.ones_like(shade)], dim=-1)
    else:
        color = _feature_color(config, volume, position, ray_dir, b) * shade
        color = torch.cat([color[..., :3], torch.ones_like(shade)], dim=-1)
    return (torch.where(found, color, torch.zeros_like(color)),
            torch.where(found, n, torch.zeros_like(n)))


@torch.no_grad()
def refine_and_shade(ray_start: Tensor, ray_dir: Tensor, volume: Any,
                     config: RayEvaluationSteppingIso, depth: Tensor,
                     found: Tensor, b: int = 0) -> RayEvaluationOutput:
    """Bisection between depth - stepsize and depth, then shading, on
    the volume's batch entry ``b``. ``depth`` (..., 1) float, ``found``
    (..., 1) bool."""
    h = float(config.stepsize)
    iso = float(config.isovalue)
    d_out = depth - h
    d_in = depth
    for _ in range(config.binary_search_steps):
        d_test = 0.5 * (d_out + d_in)
        value = volume.eval_density(ray_start + ray_dir * d_test,
                                    ray_dir, b=b)[0][..., None]
        inside = found & (value > iso)
        depth = torch.where(inside, d_test, depth)
        d_in = torch.where(inside, d_test, d_in)
        d_out = torch.where(inside, d_out, d_test)
    color, normal = _shade(config, volume, ray_start + ray_dir * depth,
                           ray_dir, found, b)
    return RayEvaluationOutput(color=color, depth=depth, normal=normal)


@torch.no_grad()
def trace_iso(ray_start: Tensor, ray_dir: Tensor, volume: Any,
              config: RayEvaluationSteppingIso, max_steps: int,
              tmax_in: Optional[Tensor] = None,
              lattice: bool = False, b: int = 0) -> RayEvaluationOutput:
    """The plain first-hit march of rays (..., 3) through ``volume``'s
    batch entry ``b``, per-ray sampling t = tmin + i*h, or the global
    lattice with ``lattice=True``; then :func:`refine_and_shade`."""
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
                                    ray_dir, b=b)[0][..., None]
        inside = valid & (value > iso)
        depth = torch.where(inside, t, depth)
        found = found | inside
    return refine_and_shade(ray_start, ray_dir, volume, config, depth, found,
                            b)

