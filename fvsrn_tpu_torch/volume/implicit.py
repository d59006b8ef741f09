"""Analytic (implicit) density fields.

Counterpart of ``fvsrn_tpu/volume/implicit.py``: the equation table, one
formula per equation on world coordinates inside the equation's own
source box, and ``VolumeInterpolationImplicit``, which maps the
renderer's box onto that source box and evaluates the density, with
its central-difference normal. They are the ground truth of screen-space
and world-space training. ``create_implicit_grid`` voxelizes an
equation, as ``Volume.create_implicit_dataset`` does.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import Tensor

from ..utils.device import resolve_device


def _sqr(x):
    return x * x


def _cb(x):
    return x * x * x


def _implicit2density(i):
    """Implicit surfaces cross zero at the surface; map to density 0.5 and
    clamp."""
    return torch.clamp(-i + 0.5, 0.0, 1.0)


def marschner_lobb(x, y, z, fM=6.0, alpha=0.25):
    r = torch.sqrt(x * x + y * y)
    pr = torch.cos(2 * math.pi * fM * torch.cos(math.pi * r / 2))
    num = (1 - torch.sin(math.pi * z / 2)) + alpha * (1 + pr)
    return num / (2 * (1 + alpha))


def cube(x, y, z, scale=0.5):
    d = torch.sqrt(_sqr(torch.clamp(torch.abs(x) - scale, min=0.0))
                   + _sqr(torch.clamp(torch.abs(y) - scale, min=0.0))
                   + _sqr(torch.clamp(torch.abs(z) - scale, min=0.0)))
    return 1 - d


def sphere(x, y, z):
    return 1 - torch.sqrt(x * x + y * y + z * z)


def inverse_sphere(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def ding_dong(x, y, z):
    return _implicit2density(x * x + y * y - z * (1 - z * z))


def endrass(x, y, z):
    s2 = math.sqrt(2.0)
    a = _sqr(x + y) - 2
    b = _sqr(x - y) - 2
    c = -4 * (1 - s2)
    d = 8 * (2 - s2) * z * z + 2 * (2 - 7 * s2) * (x * x + y * y)
    e = -16 * _sqr(_sqr(z)) + 8 * (1 + 2 * s2) * _sqr(z) - 1 + 12 * s2
    return 0.5 + (64 * (x * x - 1) * (y * y - 1) * a * b - _sqr(c + d + e))


def barth(x, y, z):
    z = z + 0.5
    phi = (1 + math.sqrt(5.0)) / 2
    x2, y2, z2, phi2 = x * x, y * y, z * 2, phi * phi
    return 0.5 + (4 * (phi2 * x2 - y2) * (phi2 * y2 - z2) * (phi2 * z2 - x2)
                  - (1 + 2 * phi) * _sqr(x2 + y2 + z2 - 1))


def heart(x, y, z):
    x2, y2, z2 = x * x, y * y, z * 2
    return _implicit2density(_cb(2 * x2 + 2 * y2 + z2 - 1)
                             - 0.1 * x2 * z2 * z - y2 * z2 * z)


def kleine(x, y, z):
    x2, y2, z2 = 25 * x * x, 25 * y * y, 5 * z * 2
    return 0.5 - ((x2 + y2 + z2 + 10 * y - 1) * _sqr(x2 + y2 + z2 - 10 * y - 1)
                  - 8 * z2 + 400 * x * y * (x2 + y2 + z2 - 10 * y - 1))


def cassini(x, y, z, a=0.25):
    return _implicit2density((_sqr(x + a) + y * y) * (_sqr(x - a) + y * y)
                             - z * z)


def steiner(x, y, z):
    x2, y2, z2 = x * x, y * y, z * 2
    return _implicit2density(x2 * y2 + x2 * z2 + y2 * z2 - 2 * x * y * z)


def cross_cap(x, y, z):
    x2, y2, z2 = x * x, y * y, z * 2
    return _implicit2density(4 * x2 * (x2 + y2 * z2 + z)
                             + y2 * (y2 + z2 - 1))


def kummer(x, y, z):
    x2, y2, z2 = x * x, y * y, z * 2
    return _implicit2density(x2 * x2 + y2 * y2 + z2 * z2 - x2 - y2 - z2
                             - x2 * y2 - y2 * z2 - z2 * x2 + 1)


def blobby(x, y, z):
    x2, y2, z2 = x * x, y * y, z * 2
    return _implicit2density(x2 + y2 * z2 + torch.sin(4 * x)
                             - torch.cos(4 * y) + torch.sin(4 * z) - 1)


def tube(x, y, z):
    r = torch.sqrt(y * y + z * z)
    return ((1 - (r * _cb(0.9 - 0.5 * torch.cos(7 * x)))) - 0.9) * 10


def multi_shell(x, y, z):
    """Three thin concentric shells with angular holes and a radial
    ripple: the sparse scene's field (~16% of the volume above density
    0.3)."""
    ripple = (0.03 * torch.sin(4.0 * x) * torch.sin(5.0 * y)
              * torch.sin(6.0 * z))
    r = torch.sqrt(x * x + y * y + z * z) + 1e-6 + ripple
    az = torch.atan2(y, x)
    el = z / r
    d = 0.0
    shells = ((0.35, 0.045, 3.0, 2.0, 0.0),
              (0.65, 0.038, 5.0, 3.0, 1.3),
              (0.95, 0.032, 7.0, 4.0, 2.1))
    for rk, wk, fk, gk, ck in shells:
        m = 0.5 + 0.5 * torch.cos(fk * az + ck) * torch.cos(gk * math.pi * el)
        d = d + 1.25 * torch.exp(-_sqr(r - rk) / (2 * wk * wk)) * m
    return torch.clamp(d, 0.0, 1.0)


# equation name -> (fn, source box min, source box max)
IMPLICIT_EQUATIONS: dict[str, tuple[Callable, float, float]] = {
    "MARSCHNER_LOBB": (marschner_lobb, -1.0, 1.0),
    "CUBE": (cube, -1.0, 1.0),
    "SPHERE": (sphere, -1.0, 1.0),
    "INVERSE_SPHERE": (inverse_sphere, -1.0, 1.0),
    "DING_DONG": (ding_dong, -2.0, 2.0),
    "ENDRASS": (endrass, -2.0, 2.0),
    "BARTH": (barth, -1.5, 1.5),
    "HEART": (heart, -1.0, 1.0),
    "KLEINE": (kleine, -1.0, 1.0),
    "CASSINI": (cassini, -1.0, 1.0),
    "STEINER": (steiner, -0.5, 0.5),
    "CROSS_CAP": (cross_cap, -1.0, 1.0),
    "KUMMER": (kummer, -2.0, 2.0),
    "BLOBBY": (blobby, -2.0, 2.0),
    "TUBE": (tube, -1.0, 1.0),
    "MULTI_SHELL": (multi_shell, -1.0, 1.0),
}


class VolumeInterpolationImplicit:
    """An analytic field as a volume: the world box (``box_min``,
    ``box_size``) is remapped to the equation's source box before the
    formula is evaluated."""

    def __init__(self, equation: str, box_min: Tensor, box_size: Tensor):
        self.equation = equation
        self.box_min = box_min
        self.box_size = box_size

    @classmethod
    def make(cls, equation: str = "SPHERE", box_min=(-0.5, -0.5, -0.5),
             box_size=(1.0, 1.0, 1.0), *, device="cpu"
             ) -> "VolumeInterpolationImplicit":
        if equation not in IMPLICIT_EQUATIONS:
            raise ValueError(f"unknown implicit equation {equation}")
        f32 = dict(dtype=torch.float32, device=device)
        return cls(equation, torch.tensor(box_min, **f32),
                   torch.tensor(box_size, **f32))

    def to(self, device) -> "VolumeInterpolationImplicit":
        return VolumeInterpolationImplicit(self.equation,
                                           self.box_min.to(device),
                                           self.box_size.to(device))

    def eval_density(self, position: Tensor, direction=None, b: int = 0):
        """World position (..., 3) -> (density (...,), is_inside); an
        implicit volume has no batch, so ``b`` is read as the JAX package
        reads it: not at all."""
        fn, smin, smax = IMPLICIT_EQUATIONS[self.equation]
        inside = ((position >= self.box_min).all(dim=-1)
                  & (position <= self.box_min + self.box_size).all(dim=-1))
        p01 = (position - self.box_min) / self.box_size
        p = p01 * (smax - smin) + smin
        return fn(p[..., 0], p[..., 1], p[..., 2]), inside

    def eval_normal(self, position: Tensor, direction=None, b: int = 0,
                    step: float = 1e-3) -> Tensor:
        """Central-difference density gradient (..., 3), step ``step``."""
        offs = torch.eye(3, dtype=position.dtype,
                         device=position.device) * step
        return torch.stack(
            [(self.eval_density(position + offs[i])[0]
              - self.eval_density(position - offs[i])[0]) / (2 * step)
             for i in range(3)], dim=-1)


def create_implicit_grid(resolution: int, equation: str,
                         dtype=torch.float32, *, device="cuda",
                         **params) -> Tensor:
    """The equation voxelized as a (res, res, res) tensor indexed [x, y,
    z] on ``device``: voxel i samples the source box at smin + i * (smax -
    smin) / (res - 1), those coordinates computed in float64 on the host
    and then cast to ``dtype``."""
    fn, smin, smax = IMPLICIT_EQUATIONS[equation]
    coords = smin + np.arange(resolution) * (smax - smin) / (resolution - 1)
    c = torch.as_tensor(coords, dtype=dtype, device=resolve_device(device))
    return fn(c[:, None, None], c[None, :, None], c[None, None, :],
              **params).to(dtype)
