"""Direct volume rendering by constant stepping, plain PyTorch.

Counterpart of ``fvsrn_tpu/raytracer/dvr.py``: the reference march and
the oracle of the fused kernel. A Python loop over a fixed step count
with per-ray validity masks, front-to-back compositing, optional
alpha early-out. With ``lattice=True`` samples sit on the global step
lattice t = k*stepsize (first sample at ceil(tmin/stepsize)*stepsize),
the sampling of the fused megakernel; ``tmax_in`` clamps each ray's
march (the saturation clip of the product render), ``tmin_in`` starts it
later, and ``step_offset`` shifts the step indices (the spans of
context-parallel marching, ``parallel.train_step.make_cp_render``).
Color-output (rgbo) volumes skip the TF: the sample's rgb is its color, its absorption o*h.
Where the configuration sets ``need_normals``, each sample's normal
(``volume.eval_normal``) is fed to the TF and to the BRDF and blended
into the ray's normal as its color is.

The march is differentiable (autograd through the loop): it is the
gradient oracle of the fused backward and the plain route of screen
training. ``checkpoint_chunk`` recomputes the network in the backward
instead of storing every step's activations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
from torch import Tensor

from torch.utils.checkpoint import checkpoint

from .. import blending
from ..utils.device import strict_f32
from ..utils.vecmath import intersect_aabb, safe_normalize


class RayEvaluationOutput(NamedTuple):
    color: Tensor   # (..., 4) rgba
    depth: Tensor   # (..., 1) alpha-weighted depth
    normal: Optional[Tensor] = None   # (..., 3), where the evaluator has one


@dataclass(frozen=True)
class RayEvaluationSteppingDvr:
    """Configuration of the stepping evaluator; ``stepsize`` in world
    units. ``need_normals``: evaluate each sample's normal (a gradient-
    scaled TF, a shading BRDF)."""
    stepsize: float = 0.005
    alpha_early_out: float = 0.999
    density_min: float = 0.0
    density_max: float = 1.0
    blend_mode: str = blending.BLEND_BEER_LAMBERT
    enable_early_out: bool = True
    need_normals: bool = False

    @classmethod
    def make(cls, **kwargs) -> "RayEvaluationSteppingDvr":
        """Numbers are rounded to float32, as the JAX package stores
        them, so every path marches with the same stepsize."""
        def f32(v):
            return float(torch.tensor(float(v), dtype=torch.float32))
        return cls(**{k: (f32(v) if isinstance(v, (int, float))
                          and not isinstance(v, bool) else v)
                      for k, v in kwargs.items()})


def max_steps_bound(box_size, stepsize: float) -> int:
    """Step count bound: the box diagonal over the stepsize, plus one."""
    diag = math.sqrt(sum(float(s) ** 2 for s in box_size))
    return int(math.ceil(diag / float(stepsize))) + 1


def trace_dvr(ray_start: Tensor, ray_dir: Tensor, volume: Any, tf: Any,
              config: RayEvaluationSteppingDvr, max_steps: int,
              tmax_in: Optional[Tensor] = None,
              lattice: bool = False,
              checkpoint_chunk: Optional[int] = None,
              brdf: Any = None, b: int = 0,
              tmin_in: Optional[Tensor] = None,
              step_offset: int = 0) -> RayEvaluationOutput:
    """March rays (..., 3) through ``volume`` (``eval_density`` + box)
    with the TF ``tf`` and, where given, the BRDF ``brdf`` (its normal is
    zero unless ``config.need_normals``), each at batch entry ``b``.
    Returns rgba and depth, and the alpha-blended normal when
    ``config.need_normals``.

    ``tmin_in`` (..., 1): the march starts at max(tmin, tmin_in), with a
    fresh previous-density carry (an entry clip). ``step_offset``: the
    step indices run over [step_offset, step_offset + max_steps), so that
    spans of the step axis march apart and composite by
    ``parallel.train_step.compose_over`` (without early-out).

    ``checkpoint_chunk``: None stores every step for the backward; c >= 1
    runs the march in chunks of c steps under ``torch.utils.checkpoint``,
    so the backward keeps one carry per chunk and recomputes the chunk
    (the JAX package's checkpointed chunks of its scan)."""
    skip_tf = getattr(volume, "outputs_color", False)
    strict_f32()
    dtype = ray_start.dtype
    tmin, tmax = intersect_aabb(ray_start, ray_dir,
                                volume.box_min.to(dtype),
                                volume.box_size.to(dtype))
    tmin = torch.clamp(tmin, min=0.0)
    if tmin_in is not None:
        tmin = torch.maximum(tmin, tmin_in.reshape(tmin.shape).to(dtype))
    if tmax_in is not None:
        tmax = torch.minimum(tmax, tmax_in.reshape(tmax.shape).to(dtype))
    h = float(config.stepsize)
    inv_range = 1.0 / (config.density_max - config.density_min)
    lead = ray_start.shape[:-1]
    rgb = torch.zeros(lead + (3,), dtype=dtype, device=ray_start.device)
    alpha = torch.zeros(lead + (1,), dtype=dtype, device=ray_start.device)
    depth = torch.zeros_like(alpha)
    prev = torch.full_like(alpha, -1.0)
    k0 = torch.ceil(tmin / h) if lattice else None

    def step(i, rgb, alpha, depth, prev, normal_acc=None):
        t = (k0 + i) * h if lattice else tmin + i * h
        valid = t <= tmax
        if config.enable_early_out:
            valid = valid & (alpha < config.alpha_early_out)
        position = ray_start + ray_dir * t
        n = None
        if skip_tf:
            # color field: the volume gives rgbo, absorption scaled by h
            value4 = volume.eval_density(position, ray_dir, b=b)[0]
            color = torch.cat([value4[..., :3], value4[..., 3:4] * h], -1)
            color = torch.where(valid, color, torch.zeros_like(color))
            density2 = prev
        else:
            value = volume.eval_density(position, ray_dir, b=b)[0][..., None]
            density2 = (value - config.density_min) * inv_range
            require = valid & (value >= config.density_min)
            if config.need_normals:
                n = volume.eval_normal(position, ray_dir, b=b)
            color = tf.eval_normalized(torch.clamp(density2[..., 0], 0, 1),
                                       n, prev[..., 0], h, b=b)
            color = torch.where(require, color, torch.zeros_like(color))
        if n is None and (brdf is not None or normal_acc is not None):
            n = torch.zeros_like(position)
        shaded = color if brdf is None else brdf.eval(color, position, n,
                                                      ray_dir, b=b)
        contribute = valid & (color[..., 3:4] > 0)
        if normal_acc is None:
            new_rgb, new_alpha, new_depth = blending.blend_step(
                rgb, alpha, shaded, config.blend_mode,
                acc_depth=depth, contrib_depth=t)
            extra = ()
        else:
            new_rgb, new_alpha, new_normal, new_depth = blending.blend_step(
                rgb, alpha, shaded, config.blend_mode,
                acc_normal=normal_acc, contrib_normal=safe_normalize(n),
                acc_depth=depth, contrib_depth=t)
            extra = (torch.where(contribute, new_normal, normal_acc),)
        return (torch.where(contribute, new_rgb, rgb),
                torch.where(contribute, new_alpha, alpha),
                torch.where(contribute, new_depth, depth), density2) + extra

    def chunk(first, n, *carry):
        for i in range(first, first + n):
            carry = step(i, *carry)
        return carry

    carry = (rgb, alpha, depth, prev)
    if config.need_normals:
        carry = carry + (torch.zeros_like(rgb),)
    if checkpoint_chunk is None or not torch.is_grad_enabled():
        carry = chunk(step_offset, max_steps, *carry)
    else:
        c = int(checkpoint_chunk)
        if c < 1:
            raise ValueError("checkpoint_chunk must be >= 1")
        for first in range(0, max_steps, c):
            carry = checkpoint(chunk, step_offset + first,
                               min(c, max_steps - first), *carry,
                               use_reentrant=False)
    rgb, alpha, depth = carry[:3]
    return RayEvaluationOutput(color=torch.cat([rgb, alpha], dim=-1),
                               depth=depth,
                               normal=carry[4] if config.need_normals
                               else None)
