"""Phase functions for volumetric path tracing.

Counterpart of ``fvsrn_tpu/phase.py``: Henyey-Greenstein and Rayleigh,
each with ``prob`` (pdf over directions), ``sample_angle`` (importance
sampling of the cosine) and ``sample`` (a direction in the frame of the
incoming one). Tensors are channel-last (..., 3). Scalar parameters are
rounded to float32 and combined in float32, as the JAX package does.

``sample`` takes the uniforms ``u`` and ``u_phi``, or draws them from
the two keys of ``split(key)`` with ``utils.prng.uniform``, JAX's bits
(``raytracer.montecarlo.trace_mc`` passes its per-ray draws).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from .utils import prng
from .utils.vecmath import cross, dot

_1_4PI = 0.07957747154594767
_F1 = np.float32(1.0)
_F2 = np.float32(2.0)


def cos_angle(dir_in: Tensor, dir_out: Tensor) -> Tensor:
    """cos of the angle between -dir_in and dir_out."""
    return dot(-dir_in, dir_out)[..., 0]


def direction_from_angle(dir_in: Tensor, cos_theta: Tensor,
                         u_phi: Tensor) -> Tensor:
    """The direction at cos(angle) ``cos_theta`` to -dir_in with uniform
    azimuth ``u_phi`` in [0, 1), in the pbr-book frame of -dir_in."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
    phi = 2 * math.pi * u_phi
    v1 = -dir_in
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(z)
    v2 = torch.where(use_x[..., None], torch.stack([-z, zero, x], dim=-1),
                     torch.stack([zero, z, -y], dim=-1)) * inv_a[..., None]
    v3 = cross(v1, v2)
    return ((sin_theta * torch.cos(phi))[..., None] * v2
            + (sin_theta * torch.sin(phi))[..., None] * v3
            + cos_theta[..., None] * v1)


def _uniforms(key, dir_in: Tensor, u, u_phi):
    """(u, u_phi): the given ones, or two uniforms a direction drawn from
    the two keys of ``split(key)`` on ``dir_in``'s device, as the JAX
    package draws them."""
    if u is None or u_phi is None:
        k1, k2 = prng.split(key)
        shape = dir_in.shape[:-1]
        u = prng.uniform(k1, shape, device=dir_in.device)
        u_phi = prng.uniform(k2, shape, device=dir_in.device)
    return u, u_phi


@dataclass(frozen=True)
class PhaseFunctionHenyeyGreenstein:
    """Henyey-Greenstein, p(cos) = 1/4pi (1-g^2)/(1+g^2+2g cos)^{3/2}
    with cos measured by :func:`cos_angle` (the reference's convention).
    ``g`` is a float32 value, or one per batch entry (``b`` picks it)."""
    g: tuple = (0.0,)

    @classmethod
    def make(cls, g=0.0) -> "PhaseFunctionHenyeyGreenstein":
        return cls(g=tuple(float(v) for v in
                           np.atleast_1d(np.asarray(g, np.float32))))

    def _g(self, b: int) -> np.float32:
        return np.float32(self.g[b if len(self.g) > 1 else 0])

    def prob_angle(self, cos_theta: Tensor, pos=None, b: int = 0) -> Tensor:
        g = self._g(b)
        denom = float(_F1 + g * g) + float(_F2 * g) * cos_theta
        return float(np.float32(_1_4PI) * (_F1 - g * g)) / (
            denom * torch.sqrt(denom))

    def prob(self, dir_in: Tensor, dir_out: Tensor, pos=None,
             b: int = 0) -> Tensor:
        return self.prob_angle(cos_angle(dir_in, dir_out), pos, b)

    def sample_angle(self, u: Tensor, b: int = 0) -> Tensor:
        g = self._g(b)
        if abs(g) < 1e-3:
            return -(1 - 2 * u)
        sqr_term = float(_F1 - g * g) / (float(_F1 - g) + float(_F2 * g) * u)
        return -((float(_F1 + g * g) - sqr_term ** 2) / float(_F2 * g))

    def sample(self, key, dir_in: Tensor, pos=None, b: int = 0,
               u: Tensor = None, u_phi: Tensor = None) -> Tensor:
        u, u_phi = _uniforms(key, dir_in, u, u_phi)
        return direction_from_angle(dir_in, self.sample_angle(u, b), u_phi)


@dataclass(frozen=True)
class PhaseFunctionRayleigh:
    """Rayleigh scattering, sampled by the analytic inverse of its cdf
    (Cardano)."""

    @classmethod
    def make(cls) -> "PhaseFunctionRayleigh":
        return cls()

    def prob_angle(self, cos_theta: Tensor, pos=None, b: int = 0) -> Tensor:
        return _1_4PI * 0.75 * (1 + cos_theta ** 2)

    def prob(self, dir_in: Tensor, dir_out: Tensor, pos=None,
             b: int = 0) -> Tensor:
        return self.prob_angle(cos_angle(dir_in, dir_out), pos, b)

    def sample_angle(self, u: Tensor, b: int = 0) -> Tensor:
        z = 4 * u - 2
        z2 = torch.sqrt(z * z + 1)

        def cbrt(v):
            return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)
        return cbrt(z + z2) + cbrt(z - z2)

    def sample(self, key, dir_in: Tensor, pos=None, b: int = 0,
               u: Tensor = None, u_phi: Tensor = None) -> Tensor:
        u, u_phi = _uniforms(key, dir_in, u, u_phi)
        return direction_from_angle(dir_in, self.sample_angle(u, b), u_phi)
