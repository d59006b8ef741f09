"""Host-side planning of the fused march.

Counterpart of the planning half of ``fvsrn_tpu/ops/fused_dvr.py``:

- ``block_ray_permutation`` regroups row-major rays into pixel blocks so
  that each ray tile of the fused kernel is spatially coherent;
- ``probe_saturation_tmax`` is the camera-static saturation probe: a
  coarse alpha-only march of the same network and TF that clamps each
  ray's march where it saturates. It is plain PyTorch on the device, as
  it is plain JAX (no Pallas kernel) in the JAX package.

The bucket planner of the JAX package (``plan_ray_buckets``) only
reorders whole tiles so that a TPU grid of fixed trip count pays less;
the CUDA kernel loops over each tile's own segments instead, so the
port has no counterpart.
"""
from __future__ import annotations

import torch
from torch import Tensor

from ..utils.device import strict_f32
from ..utils.vecmath import intersect_aabb


def block_ray_permutation(width: int, height: int, block_w: int = 16,
                          block_h: int = 16, *, device="cuda"
                          ) -> tuple[Tensor, Tensor]:
    """(perm, inv) int64: ``rays[perm]`` is ordered by (block_h x
    block_w) pixel blocks, ``out[inv]`` restores row-major order."""
    if width % block_w or height % block_h:
        raise ValueError(f"{width}x{height} is not a multiple of the "
                         f"{block_w}x{block_h} block")
    idx = torch.arange(height * width, device=device).reshape(height, width)
    perm = (idx.reshape(height // block_h, block_h, width // block_w,
                        block_w).permute(0, 2, 1, 3).reshape(-1))
    inv = torch.argsort(perm)
    return perm, inv


@torch.no_grad()
def probe_saturation_tmax(ray_start: Tensor, ray_dir: Tensor, volume, tf, *,
                          stepsize: float, max_steps: int, coarse: int = 8,
                          alpha_threshold: float = 0.999,
                          margin_steps: int = 16,
                          density_min: float = 0.0,
                          density_max: float = 1.0,
                          blend_beer: bool = True) -> Tensor:
    """Per-ray tmax clamped at the estimated saturation depth.

    Marches the same volume and TF at ``coarse * stepsize`` and returns
    min(tmax, t_sat + margin_steps * stepsize), where t_sat is the first
    coarse sample at which alpha reaches ``alpha_threshold``; rays that
    never saturate keep their geometric tmax. Returns (R,) float32."""
    strict_f32()
    h = float(stepsize)
    hc = h * coarse
    n_steps = max(1, -(-int(max_steps) // coarse))
    dtype = ray_start.dtype
    tmin, tmax = intersect_aabb(ray_start, ray_dir,
                                volume.box_min.to(dtype),
                                volume.box_size.to(dtype))
    tmin = torch.clamp(tmin, min=0.0)
    k0 = torch.ceil(tmin / hc)
    lead = ray_start.shape[:-1]
    alpha = torch.zeros(lead + (1,), dtype=dtype, device=ray_start.device)
    tsat = torch.full_like(alpha, float("inf"))
    for i in range(n_steps):
        t = (k0 + float(i)) * hc
        pos = ray_start + ray_dir * t
        value, _ = volume.eval_density(pos, ray_dir)
        value = value[..., None]
        d2 = (value - density_min) / (density_max - density_min)
        require = (t <= tmax) & (value >= density_min)
        rgba = tf.eval_normalized(torch.clamp(d2[..., 0], 0.0, 1.0),
                                  None, None, hc)
        absn = torch.where(require, rgba[..., 3:4], torch.zeros_like(t))
        ca = (1.0 - torch.exp(-absn) if blend_beer
              else torch.clamp(absn, max=1.0))
        alpha = alpha + (1.0 - alpha) * ca
        tsat = torch.where((alpha >= alpha_threshold) & ~torch.isfinite(tsat),
                           t, tsat)
    clip = torch.where(torch.isfinite(tsat), tsat + margin_steps * h, tmax)
    return torch.minimum(tmax, clip)[..., 0]
