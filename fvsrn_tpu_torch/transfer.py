"""Transfer functions.

Counterpart of ``fvsrn_tpu/transfer.py``: the identity, piecewise-linear,
texture (with 1D and 2D preintegration) and sum-of-Gaussians TFs, plain
PyTorch on the device of their parameters (``.to(device)`` moves them).
``eval_normalized(density, normal, previous_density, stepsize)`` takes a
density already mapped to [0, 1] (``previous_density < 0``: no previous
sample) and returns rgba whose absorption channel is already multiplied
by the stepsize. A TF's parameters may carry a leading batch axis
(``batch``), and ``eval_normalized(..., b=)`` reads entry ``b``.
:func:`evaluate` is the tensor-level evaluation of raw (N, 1) densities
that world-space training and importance sampling call.
The fused marches take the piecewise, texture (plain and preintegrated)
and Gaussian TFs (``ops.fused_dvr.fused_tf_args``); the identity TF, and
a Gaussian that is analytic or gradient-scaled, run in the plain
marches.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from .utils.prng import _fma

_SQRT_PI_2 = 0.8862269254527580  # sqrt(pi)/2
# XLA's float32 erf: x clamped to +-erfinv(1 - ulp/2), then x P(x^2) /
# Q(x^2), Horner steps as fused multiply-adds
_ERF_CLAMP = 3.7439211627767994
_ERF_P = (0.00022905065861350646, 0.0034082910107109506,
          0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185,
          0.0010179625278914885, 0.014070470171167667, 0.11098505178285362,
          0.49746925110067538, 1.0)


def _scale_absorption(rgba: Tensor, stepsize) -> Tensor:
    return torch.cat([rgba[..., :3], rgba[..., 3:4] * stepsize], dim=-1)


def _batch_of(param: Tensor, ndim: int) -> int:
    """The batch of a TF parameter whose unbatched form has ``ndim - 1``
    dimensions (1 when unbatched)."""
    return param.shape[0] if param.ndim == ndim else 1


def _entry(param: Tensor, ndim: int, b: int) -> Tensor:
    """Batch entry ``b`` of a TF parameter (the parameter itself when
    unbatched)."""
    return param[b] if param.ndim == ndim else param


def _lerp(a: Tensor, b: Tensor, t: Tensor) -> Tensor:
    return a + (b - a) * t


def _erf(x: Tensor) -> Tensor:
    """erf as XLA computes it in float32 (the analytic Gaussian TF's
    integral is a difference of two erfs over a short density step, so
    the last bit shows)."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x

    def horner(coeffs):
        r = torch.full_like(x2, coeffs[0])
        for c in coeffs[1:]:
            r = _fma(x2, r, torch.full_like(x2, c))
        return r
    return (x * horner(_ERF_P)) / horner(_ERF_Q)


def _prefix_scan(op, x: Tensor, dim: int, identity: float) -> Tensor:
    """Inclusive scan of ``op`` along ``dim`` in the order XLA computes
    JAX's ``cumsum`` and ``cumprod`` on the CPU: sequentially within
    blocks of 16, the blocks' totals scanned the same way and each
    block's carry applied after. The preintegration tables take
    differences of nearby cumulative values, so the order shows."""
    block = 16
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= block:
        out = [x[0]]
        for i in range(1, n):
            out.append(op(out[-1], x[i]))
        return torch.stack(out).movedim(0, dim)
    nb = -(-n // block)
    pad = x.new_full((nb * block,) + x.shape[1:], identity)
    pad[:n] = x
    rows = _prefix_scan(op, pad.reshape((nb, block) + x.shape[1:]), 1,
                        identity)
    carry = _prefix_scan(op, rows[:, -1], 0, identity)
    out = torch.cat([rows[:1], op(rows[1:], carry[:-1, None])], dim=0)
    return out.reshape((nb * block,) + x.shape[1:])[:n].movedim(0, dim)


class TransferFunctionIdentity:
    """density d -> rgb (d * emission)^3, absorption d * absorption *
    stepsize. ``scale_absorption_emission``: (2,) or (B, 2) [absorption,
    emission]."""

    def __init__(self, scale_absorption_emission: Tensor):
        self.scale_absorption_emission = scale_absorption_emission

    @classmethod
    def make(cls, absorption: float = 1.0, emission: float = 1.0
             ) -> "TransferFunctionIdentity":
        return cls(torch.tensor([absorption, emission], dtype=torch.float32))

    def to(self, device) -> "TransferFunctionIdentity":
        return TransferFunctionIdentity(
            self.scale_absorption_emission.to(device))

    def max_absorption(self) -> Tensor:
        return torch.max(torch.atleast_2d(self.scale_absorption_emission)
                         [:, 0])

    @property
    def batch(self) -> int:
        return _batch_of(self.scale_absorption_emission, 2)

    def _params(self, b: int) -> Tensor:
        return _entry(self.scale_absorption_emission, 2, b)

    def eval_normalized(self, density: Tensor, normal=None,
                        previous_density=None, stepsize=1.0,
                        b: int = 0) -> Tensor:
        p = self._params(b)
        d = torch.clamp(density, 0.0, 1.0)
        rgb = (d * p[1])[..., None].expand(d.shape + (3,))
        return torch.cat([rgb, (d * p[0] * stepsize)[..., None]], dim=-1)


class TransferFunctionPiecewiseLinear:
    """Piecewise-linear TF over control points. ``tensor`` is (R, 5) or
    (B, R, 5): [r, g, b, absorption, position], positions ascending in
    [0, 1]."""

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

    @property
    def batch(self) -> int:
        return _batch_of(self.tensor, 3)

    def _params(self, b: int) -> Tensor:
        return _entry(self.tensor, 3, b)

    def eval_normalized(self, density: Tensor, normal=None,
                        previous_density=None, stepsize=1.0,
                        b: int = 0) -> Tensor:
        tf = self._params(b)
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
        return _scale_absorption(val0 + (val1 - val0) * frac[..., None],
                                 stepsize)


class TransferFunctionTexture:
    """An rgba lookup table ``tensor`` (R, 4) or (B, R, 4), read with linear
    interpolation at d * R - 0.5, indices clamped. ``preintegration_mode`` 1
    integrates the TF over the segment [previous density, density] through the
    cumulative table ``preintegrated`` (R2 + 1, 4); mode 2 reads the 2D table
    (R2, R2, 4) of (front, back) density pairs."""

    def __init__(self, tensor: Tensor, preintegrated: Optional[Tensor] = None,
                 preintegration_mode: int = 0):
        self.tensor = tensor
        self.preintegrated = preintegrated
        self.preintegration_mode = preintegration_mode

    def to(self, device) -> "TransferFunctionTexture":
        return TransferFunctionTexture(
            self.tensor.to(device),
            None if self.preintegrated is None
            else self.preintegrated.to(device),
            self.preintegration_mode)

    def max_absorption(self) -> Tensor:
        return torch.max(self.tensor[..., 3])

    @property
    def batch(self) -> int:
        return _batch_of(self.tensor, 3)

    def _params(self, b: int) -> Tensor:
        return _entry(self.tensor, 3, b)

    @staticmethod
    def _lookup(table: Tensor, d: Tensor) -> Tensor:
        r = table.shape[0]
        x = d * r - 0.5
        i = torch.floor(x).to(torch.int64)
        f = x - i
        v0 = table[torch.clamp(i, 0, r - 1)]
        v1 = table[torch.clamp(i + 1, 0, r - 1)]
        return _lerp(v0, v1, f[..., None])

    def with_preintegration(self, resolution: int = 512
                            ) -> "TransferFunctionTexture":
        """The cumulative table V(s) = int_0^s c(d) tau(d) dd (rgb) and
        int_0^s tau(d) dd (w) at ``resolution`` + 1 knots, of batch
        entry 0."""
        tf = self._params(0)
        d = (torch.arange(resolution, dtype=torch.float32, device=tf.device)
             + 0.5) / resolution
        samples = self._lookup(tf, d)
        tau = samples[:, 3:]
        integrand = torch.cat([samples[:, :3] * tau, tau], dim=-1)
        cum = _prefix_scan(torch.add, integrand, 0, 0.0) / resolution
        cum = torch.cat([torch.zeros(1, 4, dtype=cum.dtype,
                                     device=cum.device), cum], dim=0)
        return TransferFunctionTexture(self.tensor, cum, 1)

    def with_preintegration_2d(self, resolution: int = 128,
                               stepsize: float = 1.0 / 256,
                               quadrature_steps: int = 32
                               ) -> "TransferFunctionTexture":
        """The 2D table over (front, back) density pairs: the
        transmittance-weighted emission along a linear density segment of
        length ``stepsize``, premultiplied, by ``quadrature_steps``
        midpoint samples, of batch entry 0."""
        tf = self._params(0)
        f32 = dict(dtype=torch.float32, device=tf.device)
        s = (torch.arange(resolution, **f32) + 0.5) / resolution
        sf = s[:, None, None]
        sb = s[None, :, None]
        k = (torch.arange(quadrature_steps, **f32) + 0.5) / quadrature_steps
        dens = sf + (sb - sf) * k[None, None, :]
        rgba = self._lookup(tf, dens)
        tau = rgba[..., 3] * (stepsize / quadrature_steps)
        a_k = 1.0 - torch.exp(-tau)
        trans = _prefix_scan(torch.mul, 1.0 - a_k, -1, 1.0)
        trans_before = torch.cat([torch.ones_like(trans[..., :1]),
                                  trans[..., :-1]], dim=-1)
        color = torch.sum(rgba[..., :3] * (trans_before * a_k)[..., None],
                          dim=-2)
        alpha = 1.0 - trans[..., -1]
        return TransferFunctionTexture(
            self.tensor, torch.cat([color, alpha[..., None]], dim=-1), 2)

    def eval_normalized(self, density: Tensor, normal=None,
                        previous_density=None, stepsize=1.0,
                        b: int = 0) -> Tensor:
        d = torch.clamp(density, 0.0, 1.0)
        plain = _scale_absorption(self._lookup(self._params(b), d), stepsize)
        if self.preintegration_mode == 0 or previous_density is None:
            return plain
        prev = torch.where(previous_density < 0, d, previous_density)
        table = self.preintegrated
        if self.preintegration_mode == 2:
            r = table.shape[0]
            i = torch.clamp((torch.clamp(prev, 0, 1) * r).to(torch.int64),
                            0, r - 1)
            j = torch.clamp((d * r).to(torch.int64), 0, r - 1)
            rgba = table[i, j]
            w = rgba[..., 3]
            inv = torch.where(w > 1e-5, 1.0 / torch.clamp(w, min=1e-5),
                              torch.ones_like(w))
            return torch.cat([rgba[..., :3] * inv[..., None], w[..., None]],
                             dim=-1)

        def _table(s):
            r = table.shape[0] - 1
            x = torch.clamp(s, 0.0, 1.0) * r
            i = torch.clamp(torch.floor(x).to(torch.int64), 0, r - 1)
            return _lerp(table[i], table[i + 1], (x - i)[..., None])

        vsf = _table(prev)
        vsb = _table(d)
        denom = d - prev
        small = torch.abs(denom) < 1e-3
        safe_denom = torch.where(small, torch.ones_like(denom), denom)
        rgb = stepsize * (vsb[..., :3] - vsf[..., :3]) / safe_denom[..., None]
        alpha = 1 - torch.exp(-stepsize * (vsb[..., 3] - vsf[..., 3])
                              / safe_denom)
        inv_alpha = torch.where(alpha > 1e-5,
                                1.0 / torch.clamp(alpha, min=1e-5),
                                torch.ones_like(alpha))
        pre = torch.cat([rgb * inv_alpha[..., None], alpha[..., None]],
                        dim=-1)
        return torch.where(small[..., None], plain, pre)


class TransferFunctionGaussian:
    """A sum of Gaussians, ``tensor`` (R, 6) or (B, R, 6): [r, g, b,
    opacity, mean, variance] (the last column is used as sigma).
    ``analytic`` integrates each Gaussian over [previous density,
    density] with erf;
    ``scale_with_gradient`` scales sigma by max(1e-5, |normal| / 10)."""

    def __init__(self, tensor: Tensor, analytic: bool = False,
                 scale_with_gradient: bool = False):
        self.tensor = tensor
        self.analytic = analytic
        self.scale_with_gradient = scale_with_gradient

    def to(self, device) -> "TransferFunctionGaussian":
        return TransferFunctionGaussian(self.tensor.to(device), self.analytic,
                                        self.scale_with_gradient)

    def max_absorption(self) -> Tensor:
        """The sum of the Gaussians' positive peak opacities."""
        return torch.sum(torch.clamp(self.tensor[..., 3], min=0.0), dim=-1
                         ).max()

    @property
    def batch(self) -> int:
        return _batch_of(self.tensor, 3)

    def _params(self, b: int) -> Tensor:
        return _entry(self.tensor, 3, b)

    def eval_normalized(self, density: Tensor, normal=None,
                        previous_density=None, stepsize=1.0,
                        b: int = 0) -> Tensor:
        tf = self._params(b)
        d = torch.clamp(density, 0.0, 1.0)[..., None]
        ci, mu, sigma = tf[:, :4], tf[:, 4], tf[:, 5]
        if self.scale_with_gradient:
            if normal is None:
                raise ValueError("gradient-scaled gaussian TF requires "
                                 "normals")
            g = torch.clamp(torch.sqrt(torch.sum(normal * normal, dim=-1,
                                                 keepdim=True)) * 0.1,
                            min=1e-5)
            sigma = sigma * g
        ni = torch.exp(-((d - mu) ** 2) / (sigma ** 2))
        if self.analytic and previous_density is not None:
            prev = previous_density[..., None]
            delta = prev - d
            flat = torch.abs(delta) < 1e-7
            safe_delta = torch.where(flat, torch.ones_like(delta), delta)
            ni_analytic = _SQRT_PI_2 / safe_delta * sigma * (
                _erf((prev - mu) / sigma) + _erf((mu - d) / sigma))
            ni = torch.where((prev < 0) | flat, ni, ni_analytic)
        rgba = torch.sum(ci * ni[..., None], dim=-2)
        return _scale_absorption(rgba, stepsize)


def evaluate(tf, density: Tensor, density_min: float, density_max: float,
             previous_density: Optional[Tensor] = None,
             stepsize: Optional[float] = None,
             gradient: Optional[Tensor] = None) -> Tensor:
    """Colors (N, 4) of densities (N, 1) mapped from [density_min,
    density_max] to [0, 1]; densities below density_min give (0, 0, 0, 0).
    ``previous_density`` (N, 1), where >= 0, is mapped the same way for
    the preintegrating TFs; ``gradient`` (N, 3) is the normal a
    gradient-scaled TF reads. The absorption is scaled by ``stepsize`` (1
    when None)."""
    d = density[..., 0]
    inv_range = 1.0 / (density_max - density_min)
    prev = None
    if previous_density is not None:
        p = previous_density[..., 0]
        prev = torch.where(p >= 0, (p - density_min) * inv_range,
                           torch.full_like(p, -1.0))
    color = tf.eval_normalized((d - density_min) * inv_range, gradient, prev,
                               1.0 if stepsize is None else stepsize)
    return torch.where((d >= density_min)[..., None], color,
                       torch.zeros_like(color))
