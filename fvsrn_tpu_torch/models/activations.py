"""SRN activation functions.

Counterpart of ``fvsrn_tpu/models/activations.py``: the same seven kinds,
with the same formulas, on torch tensors.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor
import torch.nn.functional as F


def _snake_alt(x: Tensor, p: float) -> Tensor:
    # (x + 1 - cos(2 p x)) / (2 p)
    return (x + 1.0 - torch.cos(2.0 * p * x)) / (2.0 * p)


def _snake(x: Tensor, p: float) -> Tensor:
    # x + sin^2(p x) / p
    return x + torch.sin(p * x) ** 2 / p


ACTIVATIONS: dict[str, Callable[[Tensor, float], Tensor]] = {
    "SnakeAlt": _snake_alt,
    "Snake": _snake,
    "ReLU": lambda x, p: torch.clamp(x, min=0.0),
    "Sine": lambda x, p: torch.sin(p * x),
    "Sigmoid": lambda x, p: torch.sigmoid(x),
    "Softplus": lambda x, p: F.softplus(x),
    "None": lambda x, p: x,
    "NONE": lambda x, p: x,
}


def apply_activation(name: str, x: Tensor, param: float = 1.0) -> Tensor:
    return ACTIVATIONS[name](x, param)


def parse_activation(spec: str) -> tuple[str, float]:
    """'SnakeAlt:2' -> ('SnakeAlt', 2.0)."""
    parts = spec.split(":")
    if parts[0] not in ACTIVATIONS:
        raise ValueError(f"unknown activation {parts[0]}")
    return parts[0], float(parts[1]) if len(parts) > 1 else 1.0
