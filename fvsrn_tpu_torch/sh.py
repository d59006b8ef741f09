"""Real spherical harmonics up to degree 4.

Counterpart of ``fvsrn_tpu/sh.py``: the real SH basis with the standard
(Sloan) normalization, evaluated over direction tensors (..., 3); the
Monte-Carlo renderer's environment term (``raytracer.montecarlo.
eval_background``).
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

MAX_DEGREE = 4


def max_degree() -> int:
    return MAX_DEGREE


def get_coefficient_count(degree: int) -> int:
    """(degree+1)^2 basis functions for all l <= degree."""
    return (degree + 1) ** 2


def get_index(l: int, m: int) -> int:
    return l * (l + 1) + m


def evaluate(direction: Tensor, degree: int) -> Tensor:
    """Every real SH basis function up to ``degree`` at unit directions
    (..., 3). Returns (..., (degree+1)^2)."""
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree must be in [0, {MAX_DEGREE}]")
    x = direction[..., 0]
    y = direction[..., 1]
    z = direction[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if degree >= 1:
        out += [
            -0.4886025119029199 * y,
            0.4886025119029199 * z,
            -0.4886025119029199 * x,
        ]
    if degree >= 2:
        out += [
            1.0925484305920792 * x * y,
            -1.0925484305920792 * y * z,
            0.31539156525252005 * (3 * z2 - 1.0),
            -1.0925484305920792 * x * z,
            0.5462742152960396 * (x2 - y2),
        ]
    if degree >= 3:
        out += [
            -0.5900435899266435 * y * (3 * x2 - y2),
            2.890611442640554 * x * y * z,
            -0.4570457994644658 * y * (5 * z2 - 1.0),
            0.3731763325901154 * z * (5 * z2 - 3.0),
            -0.4570457994644658 * x * (5 * z2 - 1.0),
            1.445305721320277 * z * (x2 - y2),
            -0.5900435899266435 * x * (x2 - 3 * y2),
        ]
    if degree >= 4:
        out += [
            2.5033429417967046 * x * y * (x2 - y2),
            -1.7701307697799304 * y * z * (3 * x2 - y2),
            0.9461746957575601 * x * y * (7 * z2 - 1.0),
            -0.6690465435572892 * y * z * (7 * z2 - 3.0),
            0.10578554691520431 * (35 * z2 * z2 - 30 * z2 + 3.0),
            -0.6690465435572892 * x * z * (7 * z2 - 3.0),
            0.47308734787878004 * (x2 - y2) * (7 * z2 - 1.0),
            -1.7701307697799304 * x * z * (x2 - 3 * y2),
            0.6258357354491761 * (x2 * (x2 - 3 * y2)
                                  - y2 * (3 * x2 - y2)),
        ]
    return torch.stack(out, dim=-1)


def evaluate_sum(direction: Tensor, coefficients: Tensor) -> Tensor:
    """Sum_k c_k Y_k(dir); coefficients (..., K) broadcastable."""
    degree = int(math.isqrt(coefficients.shape[-1])) - 1
    return torch.sum(evaluate(direction, degree) * coefficients, dim=-1)
