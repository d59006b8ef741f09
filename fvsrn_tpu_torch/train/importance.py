"""Importance sampling of training positions (rejection sampling).

Counterpart of ``fvsrn_tpu/train/importance.py``:

- ``importance_sampling``: uniform candidates in [0, 1]^3 accepted with
  probability max(value / max_value, min_prob), the value being the raw
  density or, with a TF, its absorption;
- ``importance_sampling_with_probability_grid``: accepted with
  max(trilerp(grid, pos) / max_value, min_prob) (align-corners, pos *
  (size - 1));
- ``loss_probability_grid``: |network - reference| density on a voxel
  grid, the probability of the adaptive dataset rebuild.

Candidates and acceptance draws are JAX's ``random.uniform`` bits
(``utils.prng``), drawn in batches of ``oversample`` times the request on
the caller's device; the accepted ones are gathered by a host
``np.nonzero`` round after round until the request is filled, as the JAX
package does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .. import transfer as transfer_mod
from ..utils import prng
from ..utils.device import resolve_device


def _values_for(volume, tf, positions01: Tensor, density_min: float,
                density_max: float):
    """(density (N, 1), acceptance value (N,), rgba (N, 4) or None)."""
    world = volume.box_min + positions01 * volume.box_size
    density, _ = volume.eval_density(world)
    density = density[..., None]
    if tf is None:
        return density, density[..., 0], None
    color = transfer_mod.evaluate(tf, density, density_min, density_max)
    return density, color[..., 3], color


def importance_sampling(key, volume, num_samples: int, *, tf=None,
                        min_prob: float = 0.01, density_min: float = 0.0,
                        density_max: float = 1.0,
                        max_value: Optional[float] = None,
                        oversample: int = 4, max_rounds: int = 64,
                        device="cuda"):
    """Returns (positions (N, 3) in [0, 1]^3, densities (N, 1), colors
    (N, 4) or None) on ``device``."""
    dev = resolve_device(device)
    volume = volume.to(dev)
    tf = tf.to(dev) if tf is not None else None
    if max_value is None:
        max_value = float(tf.max_absorption()) if tf is not None else 1.0

    def draw(key):
        k1, k2 = prng.split(key)
        pos = prng.uniform(k1, (num_samples * oversample, 3), device=dev)
        density, value, color = _values_for(volume, tf, pos, density_min,
                                            density_max)
        prob = torch.clamp(value / max_value, min=min_prob)
        accept = prob > prng.uniform(k2, prob.shape, device=dev)
        return pos, density, color, accept

    return _fill(key, draw, num_samples, tf is not None, max_rounds)


def _trilerp_align_corners(grid: Tensor, pos: Tensor) -> Tensor:
    """The (X, Y, Z) grid at positions (N, 3) in [0, 1]^3, corner voxels
    at 0 and 1."""
    shape = torch.tensor(grid.shape, device=grid.device)
    gp = pos * (shape.to(torch.float32) - 1)
    i0 = torch.floor(gp).to(torch.int64)
    f = gp - torch.floor(gp)
    lo = torch.minimum(torch.clamp(i0, min=0), shape - 1)
    hi = torch.minimum(torch.clamp(i0 + 1, min=0), shape - 1)

    def g(ix, iy, iz):
        return grid[ix, iy, iz]

    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    c00 = g(lo[:, 0], lo[:, 1], lo[:, 2]) * (1 - fx) \
        + g(hi[:, 0], lo[:, 1], lo[:, 2]) * fx
    c10 = g(lo[:, 0], hi[:, 1], lo[:, 2]) * (1 - fx) \
        + g(hi[:, 0], hi[:, 1], lo[:, 2]) * fx
    c01 = g(lo[:, 0], lo[:, 1], hi[:, 2]) * (1 - fx) \
        + g(hi[:, 0], lo[:, 1], hi[:, 2]) * fx
    c11 = g(lo[:, 0], hi[:, 1], hi[:, 2]) * (1 - fx) \
        + g(hi[:, 0], hi[:, 1], hi[:, 2]) * fx
    return (c00 * (1 - fy) + c10 * fy) * (1 - fz) \
        + (c01 * (1 - fy) + c11 * fy) * fz


def importance_sampling_with_probability_grid(
        key, volume, probability_grid, num_samples: int, *, tf=None,
        min_prob: float = 0.01, density_min: float = 0.0,
        density_max: float = 1.0, max_value: Optional[float] = None,
        oversample: int = 4, max_rounds: int = 64, device="cuda"):
    """Rejection against a per-voxel probability grid (X, Y, Z); returns
    as :func:`importance_sampling`."""
    dev = resolve_device(device)
    volume = volume.to(dev)
    tf = tf.to(dev) if tf is not None else None
    grid = torch.as_tensor(probability_grid, dtype=torch.float32).to(dev)
    if max_value is None:
        max_value = float(torch.max(grid))

    def draw(key):
        k1, k2 = prng.split(key)
        pos = prng.uniform(k1, (num_samples * oversample, 3), device=dev)
        prob = torch.clamp(_trilerp_align_corners(grid, pos) / max_value,
                           min=min_prob)
        accept = prob > prng.uniform(k2, prob.shape, device=dev)
        density, _, color = _values_for(volume, tf, pos, density_min,
                                        density_max)
        return pos, density, color, accept

    return _fill(key, draw, num_samples, tf is not None, max_rounds)


def _fill(key, draw, num_samples, has_tf, max_rounds):
    """Rounds of ``draw(sub)`` with ``key, sub = split(key)``, keeping the
    accepted candidates in order until ``num_samples`` are kept."""
    pos_out, den_out, col_out = [], [], []
    got = 0
    with torch.no_grad():
        for _ in range(max_rounds):
            key, sub = prng.split(key)
            pos, density, color, accept = draw(sub)
            idx = np.nonzero(accept.cpu().numpy())[0][:num_samples - got]
            if idx.size:
                sel = torch.from_numpy(idx).to(pos.device)
                pos_out.append(pos[sel])
                den_out.append(density[sel])
                if has_tf:
                    col_out.append(color[sel])
                got += idx.size
            if got >= num_samples:
                break
        else:
            raise RuntimeError(
                f"importance sampling drew only {got}/{num_samples} samples "
                f"in {max_rounds} rounds; lower min_prob or check max_value")
    colors = torch.cat(col_out) if has_tf else None
    return torch.cat(pos_out), torch.cat(den_out), colors


def loss_probability_grid(network_volume, reference_volume,
                          resolution: int = 64, chunk: int = 65536,
                          device="cuda") -> Tensor:
    """(R, R, R) grid of |network - reference| density at the voxel
    centers, evaluated in chunks of ``chunk`` positions on ``device``."""
    dev = resolve_device(device)
    reference_volume = reference_volume.to(dev)
    axes = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    gx, gy, gz = np.meshgrid(axes, axes, axes, indexing="ij")
    pos = torch.from_numpy(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3))
    outs = []
    with torch.no_grad():
        for i in range(0, pos.shape[0], chunk):
            p = pos[i:i + chunk].to(dev)
            dn, _ = network_volume.eval_density(
                network_volume.box_min + p * network_volume.box_size)
            dr, _ = reference_volume.eval_density(
                reference_volume.box_min + p * reference_volume.box_size)
            outs.append(torch.abs(dn - dr))
    return torch.cat(outs).reshape(resolution, resolution, resolution)
