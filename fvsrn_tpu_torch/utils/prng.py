"""JAX's Threefry random numbers for raw keys: keys on the host, draws on
the caller's device.

Reproduces what JAX's ``random`` module does with a raw uint32[2] key
under ``jax_threefry_partitionable=True`` (the default of current JAX
releases):

- ``PRNGKey(seed)`` is [0, seed] for a 32-bit seed (the seed's high and
  low words for a wider one);
- ``split(key, n)[i]`` and ``fold_in(key, i)`` are both the Threefry-2x32
  block (20 rounds, Salmon et al. 2011) of the key over the counter
  (0, i);
- ``random_bits(key, shape)``: element i (row-major) is ``b1 ^ b2`` of
  the block over the counter (i >> 32, i & 0xffffffff);
- ``uniform``: the bits' top 23 as the mantissa of a float in [1, 2),
  minus 1, scaled and shifted, then clipped below at ``minval``;
- ``normal``: ``sqrt(2) * erfinv(u)`` of a uniform u in (-1, 1);
- ``permutation``: stable sorts of ``arange(n)`` by fresh random bits,
  ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each with the second key of a
  split.

A key is a tuple of two ints. ``threefry2x32`` also runs on int64 tensors
that hold uint32 values (the draws here and the per-ray draws of
``raytracer/montecarlo.py``): every sum and shift is masked back to 32
bits. The bits, the uniforms and the permutations are JAX's bit for bit on
any device (the multiply-add of ``uniform`` rounded once, as XLA fuses
it); the normals run XLA's ``erf_inv`` polynomial and differ from JAX's by
at most 2 float32 ulps.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of key (k0, k1) over the counter (x0,
    x1): Python ints or int64 tensors holding uint32 values, broadcasting.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for block in range(5):
        for i in range(4):
            r = _ROT[(block % 2) * 4 + i]
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """JAX's ``random.PRNGKey(seed)``: [0, seed mod 2^32] for a seed in the
    int32 range or below 2^32, else its high and low 32-bit words."""
    seed = int(seed)
    if -2 ** 31 <= seed < 2 ** 32:
        return 0, seed & MASK
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key, data: int) -> tuple[int, int]:
    """JAX's ``random.fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & MASK)


def split(key, n: int = 2) -> tuple:
    """JAX's ``random.split(key, n)``: n keys."""
    return tuple(fold_in(key, i) for i in range(n))


def random_bits(key, shape, device="cpu") -> Tensor:
    """JAX's ``random.bits(key, shape)`` (uint32) as an int64 tensor on
    ``device``."""
    shape = tuple(int(d) for d in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(int(key[0]), int(key[1]), idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(shape)


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's fused multiply-add:
    the product of two float32 values is exact in float64, and so is the
    sum wherever |c| is within 2^6 of |a * b|'s scale (every use here)."""
    return (a.double() * b.double() + c.double()).float()


def uniform(key, shape, minval=0.0, maxval=1.0, device="cpu") -> Tensor:
    """JAX's ``random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape, device)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, _fma(one - 1.0, hi - lo, lo))


# XLA's float32 erf_inv (Giles 2010): a degree-8 polynomial in
# w = -log1p(-x^2) - 2.5 where that is below 2.5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: Tensor) -> Tensor:
    """XLA's float32 ``erf_inv`` (``torch.erfinv`` is exact to an ulp and
    reads up to ~1e-5 away from it near +-1); the Horner steps as fused
    multiply-adds. Within 2 ulps of JAX's: ``log1p`` differs by an ulp."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(small, np.float32(_ERFINV_LT5[i]),
                           np.float32(_ERFINV_GE5[i]))
    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape, device="cpu") -> Tensor:
    """JAX's ``random.normal(key, shape)`` in float32."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return np.float32(np.sqrt(2)) * erfinv(u)


def permutation(key, n: int, device="cpu") -> Tensor:
    """JAX's ``random.permutation(key, n)``: a permutation of ``arange(n)``
    (int64) on ``device``."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True)[1]
        x = x[order]
    return x
