"""JAX's Threefry key derivation for raw keys, on the host.

Reproduces, in Python integers, what JAX's ``random`` module does with a raw
uint32[2] key under ``jax_threefry_partitionable=True`` (the default of
current JAX releases):

- ``PRNGKey(seed)`` is [0, seed] for a 32-bit seed (the seed's high and
  low words for a wider one);
- ``split(key, n)[i]`` and ``fold_in(key, i)`` are both the Threefry-2x32
  block (20 rounds, Salmon et al. 2011) of the key over the counter
  (0, i).

A key is a tuple of two ints. ``threefry2x32`` also runs on int64 tensors
that hold uint32 values (the per-ray draws of ``raytracer/montecarlo.py``):
every sum and shift is masked back to 32 bits.
"""
from __future__ import annotations

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
