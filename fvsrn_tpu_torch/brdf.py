"""BRDF: local shading of each sample.

Counterpart of ``fvsrn_tpu/brdf.py``: ``BRDFLambert``, an optional
gradient-magnitude opacity scaling and Blinn-Phong-style shading with a
directional or point light. With both off (the default) it passes the
color through. Plain PyTorch; the plain march (``raytracer.dvr.
trace_dvr``) calls it on every sample where the scene asks for normals.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from .utils.vecmath import dot, normalize, safe_normalize

LIGHT_POINT = "point"
LIGHT_DIRECTION = "direction"


def _f32(v) -> float:
    return float(np.float32(v))


def _smoothstep(e0, e1, x: Tensor) -> Tensor:
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _reflect(i: Tensor, n: Tensor) -> Tensor:
    return i - 2.0 * dot(n, i) * n


@dataclass(frozen=True)
class BRDFLambert:
    """Shading parameters; numbers are float32 values, ``light`` the
    light's direction or position."""
    magnitude_scaling: float = 1.0
    ambient: float = 0.1
    specular: float = 0.1
    magnitude_center: float = 0.5
    magnitude_radius: float = 0.1
    light: tuple = (0.0, 0.0, -1.0)
    specular_exponent: int = 8
    enable_magnitude_scaling: bool = False
    enable_phong: bool = False
    light_type: str = LIGHT_DIRECTION

    @classmethod
    def make(cls, enable_phong=False, enable_magnitude_scaling=False,
             magnitude_scaling=1.0, ambient=0.1, specular=0.1,
             magnitude_center=0.5, magnitude_radius=0.1,
             light=(0.0, 0.0, -1.0), light_type=LIGHT_DIRECTION,
             specular_exponent=8) -> "BRDFLambert":
        return cls(magnitude_scaling=_f32(magnitude_scaling),
                   ambient=_f32(ambient), specular=_f32(specular),
                   magnitude_center=_f32(magnitude_center),
                   magnitude_radius=_f32(magnitude_radius),
                   light=tuple(_f32(v) for v in light),
                   specular_exponent=int(specular_exponent),
                   enable_magnitude_scaling=bool(enable_magnitude_scaling),
                   enable_phong=bool(enable_phong), light_type=light_type)

    def eval(self, rgb_absorption: Tensor, position: Tensor,
             gradient: Tensor, ray_dir: Tensor, b: int = 0) -> Tensor:
        """Color and absorption (..., 4) -> shaded (..., 4). ``b``, the
        batch entry, is taken as the JAX package takes it: the shading
        parameters are not batched, so every entry reads the same."""
        if not (self.enable_phong or self.enable_magnitude_scaling):
            return rgb_absorption
        rgb = rgb_absorption[..., :3]
        absorption = rgb_absorption[..., 3:4]
        grad_norm_sqr = torch.sum(gradient * gradient, dim=-1, keepdim=True)
        normal = safe_normalize(gradient)
        if self.enable_magnitude_scaling:
            absorption = absorption * (
                1.0 - torch.exp(-self.magnitude_scaling * grad_norm_sqr))
        if self.enable_phong:
            light = torch.tensor(self.light, dtype=position.dtype,
                                 device=position.device)
            if self.light_type == LIGHT_DIRECTION:
                light_dir = normalize(-light).expand(normal.shape)
            else:
                light_dir = normalize(light - position)
            grad_norm = torch.sqrt(torch.clamp(grad_norm_sqr, min=1e-20))
            phong = _smoothstep(self.magnitude_center - self.magnitude_radius,
                                self.magnitude_center + self.magnitude_radius,
                                grad_norm)
            ambient_strength = 1.0 + (self.ambient - 1.0) * phong
            diffuse = torch.abs(dot(normal, light_dir)) * rgb
            e = float(self.specular_exponent)
            specular = ((e + 2) * 0.159155) * torch.clamp(
                dot(ray_dir, _reflect(light_dir, -normal)), min=0.0) ** e
            rgb = (ambient_strength * rgb
                   + (1.0 - ambient_strength)
                   * (diffuse + self.specular * specular))
        return torch.cat([rgb, absorption], dim=-1)
