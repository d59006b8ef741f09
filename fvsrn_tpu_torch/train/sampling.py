"""Position samplers for world-space training.

Counterpart of ``fvsrn_tpu/train/sampling.py``: uniform random, plastic
(additive-recurrence low-discrepancy) and scrambled Halton sequences, each
giving positions in [0, 1]^D. Random positions are JAX's
``random.uniform`` bits (``utils.prng``), drawn on the caller's device;
the plastic and Halton sequences are deterministic by index and computed
with NumPy on the host, as the JAX package computes them (this module
keeps its own copy of that NumPy code).
"""
from __future__ import annotations

import sys

import numpy as np
import torch
from torch import Tensor

from ..utils import prng
from ..utils.device import resolve_device

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23]


def random_positions(key, num_samples: int, dimension: int = 3,
                     device="cuda") -> Tensor:
    """Uniform random positions in [0,1]^D, (N, D) on ``device``."""
    return prng.uniform(key, (num_samples, dimension), device=device)


def plastic_positions(num_samples: int, dimension: int = 3,
                      start_index: int = 0) -> np.ndarray:
    """z_i = (0.5 + alpha (i + 1)) mod 1, alpha from the generalized
    golden ratio."""
    x = 1.0
    for _ in range(20):  # Newton for x^(d+1) = x + 1
        x = x - (x ** (dimension + 1) - x - 1) / (
            (dimension + 1) * x ** dimension - 1)
    alpha = np.asarray([(1 / x) ** (j + 1) % 1.0 for j in range(dimension)])
    i = np.arange(start_index, start_index + num_samples, dtype=np.float64)
    z = (0.5 + alpha[None, :] * (i[:, None] + 1.0)) % 1.0
    # keep strictly inside [0, 1) after the float32 round-trip
    return np.minimum(z.astype(np.float32), 1 - np.float32(2e-7))


def _radical_inverse_vec(a: np.ndarray, base: int,
                         perm: np.ndarray) -> np.ndarray:
    """Scrambled radical inverse of every index in ``a``."""
    a = a.astype(np.int64).copy()
    inv_base = 1.0 / base
    reversed_digits = np.zeros_like(a)
    inv_base_n = np.ones(a.shape, np.float64)
    active = a > 0
    while active.any():
        nxt = a // base
        digit = a - nxt * base
        reversed_digits = np.where(active,
                                   reversed_digits * base + perm[digit],
                                   reversed_digits)
        inv_base_n = np.where(active, inv_base_n * inv_base, inv_base_n)
        a = nxt
        active = a > 0
    vals = inv_base_n * (reversed_digits + inv_base * perm[0] / (1 - inv_base))
    return np.minimum(vals, 1 - sys.float_info.epsilon)


def halton_positions(num_samples: int, dimension: int = 3,
                     start_index: int = 0, seed: int = 0) -> np.ndarray:
    """Scrambled Halton sequence: a digit permutation per dimension from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    idx = np.arange(start_index, start_index + num_samples)
    out = np.empty((num_samples, dimension), np.float32)
    for d in range(dimension):
        base = _PRIMES[d]
        perm = np.arange(base)
        rng.shuffle(perm)
        out[:, d] = _radical_inverse_vec(idx, base, perm)
    return np.minimum(out, 1 - np.float32(2e-7))


def get_sampled_positions(sampler: str, num_samples: int, dimension: int = 3,
                          start_index: int = 0, key=None,
                          device="cuda") -> Tensor:
    """(N, D) float32 positions of ``sampler`` ("random", "plastic" or
    "halton") on ``device``; "random" draws from ``key`` (default
    ``prng_key(start_index)``)."""
    dev = resolve_device(device)
    if sampler == "random":
        if key is None:
            key = prng.prng_key(start_index)
        return random_positions(key, num_samples, dimension, dev)
    if sampler == "plastic":
        pos = plastic_positions(num_samples, dimension, start_index)
    elif sampler == "halton":
        pos = halton_positions(num_samples, dimension, start_index)
    else:
        raise ValueError(f"unknown sampler {sampler}")
    return torch.from_numpy(pos).to(dev)
