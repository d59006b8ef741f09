"""Monte-Carlo volumetric path tracing: delta tracking, next-event
estimation, multiple bounces.

Counterpart of ``fvsrn_tpu/raytracer/montecarlo.py`` (the reference's
``RayEvaluationMonteCarlo``): Woodcock/delta tracking against the majorant
``max_absorption``, a shadow ray to a spherical area light per bounce, and
phase-function scattering. ``use_fused=True`` evaluates every tracking
round's tentative collisions with the fused sample evaluator
(``ops.fused_eval``: ``csrc/sample_eval.cu`` on the card).

What the port keeps of the JAX package, and how:

- Draws. Keys are host-side pairs of ints (``utils/prng.py``); every key
  split happens on the host. Each ray's draws are a counter function of
  (key, ray id, salt): Threefry-2x32 on int64 lanes masked to 32 bits,
  bit for bit JAX's ``_ray_bits2``; the 24 high bits make a float32
  uniform exactly. Draws that go through ``log``/``cos``/``sqrt`` may
  differ from XLA's by an ulp, so a knife-edge collision may flip: parity
  with JAX is a share of rays, not equality.
- The walk. JAX's ``while_loop`` (while ``it < max_iterations`` and any
  ray walks) is a Python loop over rounds that reads on the host whether
  any ray still walks every ``LIVE_CHECK_EVERY`` rounds; a round in which
  no ray walks changes nothing, and the loop stops exactly at
  ``max_iterations``. With ``steps_per_round`` K > 1 the K tentative
  distances are accumulated one step at a time, the arithmetic of K = 1,
  so the walk is bitwise the same for every K.
- Compaction: live rays first by a stable sort on an integer key, overflow
  rays finished at the current width, the global step carried across
  stages, so the compacted walk equals the uncompacted one bitwise.
- Normals are evaluated once, at the recorded interaction point, unless
  the TF reads them per sample (a gradient-scaled Gaussian,
  ``scale_with_gradient``): then every tentative collision gets its
  normal in the loop, as in the JAX package. With the fused sampler the
  network's adjoint normals come with the values from one launch of the
  sample evaluator's gradient instance a round (``csrc/sample_eval.cu``,
  :func:`make_mc_sampler` with ``want_grad``); finite-difference normals
  (``gradient_mode="fd"``) evaluate the sampler at the three offsets; the
  plain walk calls ``volume.eval_normal``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from ..utils import prng
from ..utils.vecmath import intersect_aabb, normalize, safe_normalize
from .dvr import RayEvaluationOutput

# tracking rounds run since the last reset (every walk of every call), and
# those of them that evaluated in-loop normals
TRACKING_ROUNDS = 0
NORMAL_ROUNDS = 0
# rounds between two host reads of whether any ray still walks: a read
# drains the device's queue, a round past the walk's end costs a round of
# launches (chip_smoke.py phase I times 1, 4, 8 and 16 interleaved)
LIVE_CHECK_EVERY = 4
# floor of the default compaction schedule's widths (any sampler: the
# card's evaluator launches any width)
COMPACT_MIN_WIDTH = 256


def _f32(v) -> float:
    return float(np.float32(v))


@dataclass(frozen=True, eq=False)
class RayEvaluationMonteCarlo:
    """Configuration: spherical area light, scattering bounces, TF-driven
    absorption with ``max_absorption`` as the delta-tracking majorant;
    ``sh_coefficients`` ((deg+1)^2, 3) an optional environment. Numbers are
    float32 values."""
    max_absorption: float = 10.0
    density_min: float = 0.0
    density_max: float = 1.0
    light_position: tuple = (0.0, 2.0, 0.0)
    light_radius: float = 0.5
    light_intensity: float = 1.0
    color_scaling: float = 1.0
    sh_coefficients: Optional[np.ndarray] = None
    num_bounces: int = 2
    max_iterations: int = 512

    @classmethod
    def make(cls, max_absorption=10.0, density_min=0.0, density_max=1.0,
             light_position=(0.0, 2.0, 0.0), light_radius=0.5,
             light_intensity=1.0, color_scaling=1.0, num_bounces=2,
             max_iterations=512, sh_coefficients=None):
        if sh_coefficients is not None:
            sh_coefficients = np.asarray(sh_coefficients, np.float32)
            n = sh_coefficients.shape[0]
            if int(np.sqrt(n)) ** 2 != n or sh_coefficients.shape[1:] != (3,):
                raise ValueError(
                    "sh_coefficients must be ((degree+1)^2, 3) rgb "
                    f"coefficients, got {sh_coefficients.shape}")
        return cls(max_absorption=_f32(max_absorption),
                   density_min=_f32(density_min),
                   density_max=_f32(density_max),
                   light_position=tuple(_f32(v) for v in light_position),
                   light_radius=_f32(light_radius),
                   light_intensity=_f32(light_intensity),
                   color_scaling=_f32(color_scaling),
                   sh_coefficients=sh_coefficients,
                   num_bounces=int(num_bounces),
                   max_iterations=int(max_iterations))


class _DeltaResult(NamedTuple):
    t_out: Tensor         # (..., 1) > 0 iff a medium interaction was sampled
    hit_position: Tensor  # (..., 3)
    hit_color: Tensor     # (..., 4) TF color at the interaction
    hit_normal: Tensor    # (..., 3)


def _ray_bits2(key, ray_id: Tensor, salt: int = 0):
    """Two uint32 streams per ray (int64 tensors), a pure function of
    (key, ray_id, salt): Threefry of the key, its second word plus
    ``salt`` mod 2^32, over the counter (ray_id, 0)."""
    rid = ray_id.reshape(-1).to(torch.int64) & prng.MASK
    return prng.threefry2x32(int(key[0]) & prng.MASK,
                             (int(key[1]) + int(salt)) & prng.MASK, rid,
                             torch.zeros_like(rid))


def _bits_to_unit(bits: Tensor) -> Tensor:
    # the 24 high bits -> [0, 1), exact in float32
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def ray_uniform(key, ray_id: Tensor, dtype=torch.float32, minval=0.0,
                salt: int = 0) -> Tensor:
    """Counter-based per-ray uniform in [minval, 1): the value for a ray
    depends only on (key, ray_id, salt). Returns ray_id.shape + (1,)."""
    b0, _ = _ray_bits2(key, ray_id, salt)
    u = _bits_to_unit(b0)
    if minval:
        u = u * (1.0 - minval) + minval
    return u.to(dtype).reshape(ray_id.shape + (1,))


def ray_normal3(key, ray_id: Tensor, dtype=torch.float32) -> Tensor:
    """Per-ray 3D standard normal by Box-Muller on two counter draws.
    Returns ray_id.shape + (3,)."""
    b0, b1 = _ray_bits2(key, ray_id)
    c0, c1 = _ray_bits2(key, ray_id, salt=1)
    u1 = torch.clamp(_bits_to_unit(b0), min=1e-12)
    u2 = _bits_to_unit(b1)
    u3 = torch.clamp(_bits_to_unit(c0), min=1e-12)
    u4 = _bits_to_unit(c1)
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    a1 = 2.0 * np.pi * u2
    a2 = 2.0 * np.pi * u4
    g = torch.stack([r1 * torch.cos(a1), r1 * torch.sin(a1),
                     r2 * torch.cos(a2)], dim=-1)
    return g.to(dtype).reshape(ray_id.shape + (3,))


def _default_ray_id(lead, device) -> Tensor:
    n = int(np.prod(lead)) if lead else 1
    return torch.arange(n, dtype=torch.int64, device=device).reshape(lead)


class _Walk(NamedTuple):
    it: int           # global tracking step of the next round
    valid: Tensor     # (n, 1) the ray still walks
    tcur: Tensor      # (n, 1)
    t_out: Tensor     # (n, 1)
    hit_pos: Tensor   # (n, 3)
    hit_col: Tensor   # (n, 4)
    hit_nrm: Tensor   # (n, 3) the in-loop normal at the hit (else zeros)


@torch.no_grad()
def delta_tracking(key, ray_start: Tensor, ray_dir: Tensor, volume: Any,
                   tf: Any, config: RayEvaluationMonteCarlo,
                   need_normals: bool = True, b: int = 0,
                   ray_id: Optional[Tensor] = None, sampler: Any = None,
                   steps_per_round: int = 1, active: Optional[Tensor] = None,
                   compact_stages: tuple = ()) -> _DeltaResult:
    """Woodcock/delta tracking from ``ray_start`` (t = 0): free flights
    against the majorant ``max_absorption``; a tentative collision is real
    with probability sigma(x)/majorant. A walk ends on leaving the volume
    (t_out = 0) or on a real collision (t_out = t).

    ``sampler``: ``(position, direction) -> (density, inside)`` in place
    of ``volume.eval_density`` (:func:`make_mc_sampler`); one made with
    ``want_grad`` also returns the density's world-space gradient, which
    the in-loop normals then take.
    ``steps_per_round``: tentative steps evaluated per round as one batch
    (every draw is a function of the global step, so the walk is the same
    for any value). ``active`` ((..., 1) bool): rays that walk at all; the
    others return t_out = 0. ``compact_stages`` ((rounds, width), ...):
    after ``rounds`` more rounds, the first ``width`` live rays continue in
    a narrower batch and the overflow finishes at the current width, with
    the same result. Normals (``need_normals``) are evaluated once, at
    the interaction point after the walk (the port's TFs read no normal
    per sample)."""
    dtype = ray_start.dtype
    dev = ray_start.device
    lead = ray_start.shape[:-1]
    n = int(np.prod(lead)) if lead else 1
    if ray_id is None:
        ray_id = _default_ray_id(lead, dev)
    K = max(1, int(steps_per_round))
    max_it = int(config.max_iterations)
    inv_major = _f32(np.float32(1.0) / np.float32(config.max_absorption))
    inv_range = _f32(np.float32(1.0) / (np.float32(config.density_max)
                                        - np.float32(config.density_min)))
    dmin = config.density_min
    tf_normals = bool(getattr(tf, "scale_with_gradient", False))
    inloop_normals = need_normals and tf_normals
    k0 = int(key[0]) & prng.MASK
    # the key's second word plus every salt the walk can reach: draws
    # 2*step (free flight) and 2*step + 1 (acceptance)
    k1_salts = (int(key[1]) + torch.arange(2 * (max_it + K), device=dev,
                                           dtype=torch.int64)) & prng.MASK

    def eval_density(position, rd_):
        """(value, inside, normal or None), value and inside (..., 1)."""
        normal = None
        if sampler is not None:
            value, inside, *grad = sampler(position, rd_)
            if inloop_normals and grad:
                normal = grad[0]
            elif inloop_normals and getattr(volume, "gradient_mode",
                                            "adjoint") == "fd":
                offs = torch.eye(3, dtype=position.dtype,
                                 device=position.device) * volume.fd_step
                normal = torch.stack(
                    [(sampler(position + offs[i], rd_)[0] - value)
                     / volume.fd_step for i in range(3)], dim=-1)
        else:
            value, inside = volume.eval_density(position, rd_, b=b)
        if inloop_normals and normal is None:
            normal = volume.eval_normal(position, rd_, b=b)
        return value[..., None], inside[..., None], normal

    def body(w: _Walk, rs_, rd_, rid_) -> _Walk:
        global TRACKING_ROUNDS, NORMAL_ROUNDS
        TRACKING_ROUNDS += 1
        NORMAL_ROUNDS += int(inloop_normals)
        k1 = k1_salts[2 * w.it:2 * (w.it + K)].reshape(2 * K, 1)
        bits, _ = prng.threefry2x32(k0, k1, rid_[None],
                                    torch.zeros_like(rid_)[None])
        u = _bits_to_unit(bits)[..., None].to(dtype)     # (2K, n, 1)
        log_u1 = torch.log(u[0::2] * (1.0 - 1e-10) + 1e-10)
        u2 = u[1::2]
        t, ts = w.tcur, []
        for j in range(K):
            t = t - log_u1[j] * inv_major
            ts.append(t)
        t_j = torch.stack(ts)                            # (K, n, 1)
        position = rs_[None] + rd_[None] * t_j           # (K, n, 3)
        value, inside, normal = eval_density(position, rd_)
        if normal is None and tf_normals:
            # a walk without in-loop normals hands the TF zero normals, as
            # the JAX package does (a gradient-scaled TF's narrowest
            # Gaussians)
            normal = torch.zeros_like(position)
        density2 = (value - dmin) * inv_range
        color = tf.eval_normalized(torch.clamp(density2[..., 0], 0.0, 1.0),
                                   normal, None, 1.0, b=b)
        walking, t_out = w.valid, w.t_out
        hit_pos, hit_col, hit_nrm = w.hit_pos, w.hit_col, w.hit_nrm
        for j in range(K):
            # the exit check precedes acceptance at the same step
            exit_now = walking & ~inside[j]
            hit_pos = torch.where(exit_now, position[j], hit_pos)
            t_out = torch.where(exit_now, 0.0, t_out)
            walking = walking & inside[j]
            require = walking & (value[j] >= dmin)
            real_hit = require & (color[j][..., 3:4] * inv_major > u2[j])
            hit_pos = torch.where(real_hit, position[j], hit_pos)
            hit_col = torch.where(real_hit, color[j], hit_col)
            if normal is not None:
                hit_nrm = torch.where(real_hit, normal[j], hit_nrm)
            t_out = torch.where(real_hit, t_j[j], t_out)
            walking = walking & ~real_hit
        tcur = torch.where(walking, t_j[K - 1], w.tcur)
        return _Walk(w.it + K, walking, tcur, t_out, hit_pos, hit_col,
                     hit_nrm)

    def run_rounds(w: _Walk, rounds, rs_, rd_, rid_) -> _Walk:
        """Advance by up to ``rounds`` rounds (None: to the end of the walk
        or the iteration cap)."""
        it0, done = w.it, 0
        while w.it < max_it and (rounds is None or w.it < it0 + rounds):
            if done % LIVE_CHECK_EVERY == 0 and not bool(w.valid.any()):
                break
            w = body(w, rs_, rd_, rid_)
            done += 1
        return w

    rs = ray_start.reshape(n, 3)
    rd = ray_dir.reshape(n, 3)
    rid = ray_id.reshape(n).to(torch.int64) & prng.MASK
    valid0 = (torch.ones(n, 1, dtype=torch.bool, device=dev) if active is None
              else torch.broadcast_to(active, lead + (1,)).reshape(n, 1))
    zeros = dict(dtype=dtype, device=dev)
    w = _Walk(0, valid0, torch.zeros(n, 1, **zeros),
              torch.zeros(n, 1, **zeros), torch.zeros(n, 3, **zeros),
              torch.zeros(n, 4, **zeros), torch.zeros(n, 3, **zeros))
    if not compact_stages:
        w = run_rounds(w, None, rs, rd, rid)
        t_out, hit_pos, hit_col, hit_nrm = w[3:]
    else:
        out = [torch.zeros_like(v) for v in w[3:]]
        cur_idx = torch.arange(n, device=dev)
        rs_c, rd_c, rid_c = rs, rd, rid
        for rounds, width in compact_stages:
            if width >= cur_idx.shape[0]:
                continue
            w = run_rounds(w, rounds, rs_c, rd_c, rid_c)
            live = w.valid[:, 0]
            order = torch.sort((~live).to(torch.int32), stable=True).indices
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.shape[0], device=dev)
            taken = live & (inv < width)
            # overflow (live beyond `width`) and finished rays finish at the
            # current width
            w_of = run_rounds(w._replace(valid=(live & ~taken)[:, None]),
                              None, rs_c, rd_c, rid_c)
            for i, v in enumerate(w_of[3:]):
                out[i][cur_idx] = v
            idx = order[:width]
            cur_idx, rs_c, rd_c, rid_c = (cur_idx[idx], rs_c[idx], rd_c[idx],
                                          rid_c[idx])
            w = _Walk(w.it, taken[idx][:, None], *(v[idx] for v in w[2:]))
        w = run_rounds(w, None, rs_c, rd_c, rid_c)
        for i, v in enumerate(w[3:]):
            out[i][cur_idx] = v
        t_out, hit_pos, hit_col, hit_nrm = out
    if need_normals and not inloop_normals:
        hit_nrm = torch.where(t_out > 0, volume.eval_normal(hit_pos, rd, b=b),
                              hit_nrm)
    return _DeltaResult(t_out.reshape(lead + (1,)),
                        hit_pos.reshape(lead + (3,)),
                        hit_col.reshape(lead + (4,)),
                        hit_nrm.reshape(lead + (3,)))


def _light_center(config: RayEvaluationMonteCarlo, like: Tensor) -> Tensor:
    return torch.tensor(config.light_position, dtype=like.dtype,
                        device=like.device)


def sample_light_position(key, config: RayEvaluationMonteCarlo, shape: tuple,
                          dtype, ray_id: Optional[Tensor] = None,
                          device="cuda") -> Tensor:
    """Uniform point on the light sphere's surface: a normalized gaussian,
    per ray from the counters ``ray_id`` (shape ``shape``, on their
    device), or without them JAX's ``random.normal(key, shape + (3,))``
    drawn on ``device``."""
    if ray_id is not None:
        g = ray_normal3(key, ray_id, dtype)
    else:
        g = prng.normal(key, tuple(shape) + (3,), device=device).to(dtype)
    return normalize(g) * config.light_radius + _light_center(config, g)


def eval_background(ray_start: Tensor, ray_dir: Tensor,
                    config: RayEvaluationMonteCarlo) -> Tensor:
    """Background radiance of escaped rays: the ray / light-sphere
    intersection, plus the spherical-harmonics environment
    (``config.sh_coefficients``) in the escape direction. (..., 4)."""
    radius = np.float32(config.light_radius)
    oc = ray_start - _light_center(config, ray_start)
    a = torch.sum(ray_dir * ray_dir, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(ray_dir * oc, dim=-1, keepdim=True)
    c = torch.sum(oc * oc, dim=-1, keepdim=True) - float(radius * radius)
    is_light = b * b - 4 * a * c > 0
    rgb = torch.where(is_light, config.light_intensity, 0.0).expand(
        ray_dir.shape[:-1] + (3,))
    alpha = is_light.to(ray_start.dtype)
    if config.sh_coefficients is not None:
        from .. import sh
        coeffs = torch.as_tensor(config.sh_coefficients, dtype=ray_dir.dtype,
                                 device=ray_dir.device)
        degree = int(math.isqrt(coeffs.shape[0])) - 1
        basis = sh.evaluate(safe_normalize(ray_dir), degree)
        env = torch.clamp(basis @ coeffs, min=0.0)
        rgb = rgb + torch.where(is_light, 0.0, env)
        alpha = torch.maximum(alpha, (torch.sum(env, dim=-1, keepdim=True)
                                      > 0).to(ray_start.dtype))
    return torch.cat([rgb, alpha], dim=-1)


def make_mc_sampler(volume: Any, *, tile: int = 2048,
                    table_dtype=torch.float32, interpret: bool = False,
                    want_grad: bool = False):
    """The fused density sampler of :func:`trace_mc` over a
    ``VolumeInterpolationNetwork``: one launch of ``csrc/sample_eval.cu``
    per tracking round on the card (the plain version on the CPU); with
    ``want_grad`` its gradient instance, which also returns the density's
    world-space gradient (the in-loop normals)."""
    from ..ops.fused_eval import make_fused_eval
    return make_fused_eval(
        volume.network, volume.box_min.detach().cpu().numpy(),
        volume.box_size.detach().cpu().numpy(),
        time=float(getattr(volume, "time", 0.0)),
        ensemble=float(getattr(volume, "ensemble", 0.0)), tile=tile,
        table_dtype=table_dtype, interpret=interpret, want_grad=want_grad)


def _default_stages(n: int, floor_w: int) -> tuple:
    def wup(w):
        return -(-max(w, floor_w) // floor_w) * floor_w
    if n // 4 > floor_w:
        return (8, wup(n // 4)), (16, wup(n // 16))
    if n > 2 * floor_w:
        return ((8, wup(n // 4)),)
    return ()


@torch.no_grad()
def trace_mc(key, ray_start: Tensor, ray_dir: Tensor, volume: Any, tf: Any,
             phase: Any, config: RayEvaluationMonteCarlo, b: int = 0,
             ray_id: Optional[Tensor] = None, sampler: Any = None,
             use_fused: bool = False, fused_kwargs: Optional[dict] = None,
             compact: bool = False, compact_schedule: Optional[tuple] = None,
             compact_min_width: Optional[int] = None) -> RayEvaluationOutput:
    """Path-traced evaluation of rays (..., 3) with next-event estimation
    to the spherical light, ``config.num_bounces`` scatterings. ``key``: a
    host key (``utils.prng.prng_key``); ``ray_id``: the per-ray counters
    (default arange), so a ray's draws do not depend on the batch.

    ``use_fused=True`` (network volumes) evaluates every tracking round
    with :func:`make_mc_sampler` (``fused_kwargs`` go to it); the draws are
    unchanged. For a gradient-scaled TF and adjoint normals the camera
    walks take its gradient instance (values and normals from one launch
    a round), the shadow walks, which read no normal, the values'. ``compact=True`` starts each walk with only the rays still
    on a path and compacts live rays inside every walk
    (``compact_schedule``, default: N/4 after 8 rounds and N/16 after 16
    more, widths rounded up to multiples of ``compact_min_width``, default
    ``COMPACT_MIN_WIDTH``; the JAX package's default floor is its
    sampler's TPU tile, which the port ignores); the result is bitwise
    the same. Returns color
    (emission, first-bounce alpha), normal and depth."""
    dtype = ray_start.dtype
    lead = ray_start.shape[:-1]
    if ray_id is None:
        ray_id = _default_ray_id(lead, ray_start.device)
    walk_sampler = sampler
    if sampler is None and use_fused:
        sampler = walk_sampler = make_mc_sampler(volume,
                                                 **(fused_kwargs or {}))
        if (getattr(tf, "scale_with_gradient", False)
                and getattr(volume, "gradient_mode", "adjoint") == "adjoint"):
            walk_sampler = make_mc_sampler(volume, want_grad=True,
                                           **(fused_kwargs or {}))
    stages = ()
    if compact:
        if compact_schedule is not None:
            stages = tuple(compact_schedule)
        else:
            floor_w = int(compact_min_width or COMPACT_MIN_WIDTH)
            stages = _default_stages(int(np.prod(lead)) if lead else 1,
                                     floor_w)
    tmin, _ = intersect_aabb(ray_start, ray_dir, volume.box_min.to(dtype),
                             volume.box_size.to(dtype))
    tmin = torch.clamp(tmin, min=0.0)
    zeros = dict(dtype=dtype, device=ray_start.device)
    emission = torch.zeros(lead + (3,), **zeros)
    beta = torch.ones(lead + (3,), **zeros)
    out_alpha = torch.zeros(lead + (1,), **zeros)
    out_depth = torch.zeros(lead + (1,), **zeros)
    out_normal = torch.zeros(lead + (3,), **zeros)
    position = ray_start + tmin * ray_dir
    direction = ray_dir
    valid = torch.ones(lead + (1,), dtype=torch.bool, device=ray_start.device)
    walk = dict(b=b, ray_id=ray_id, compact_stages=stages)

    for bounce in range(config.num_bounces + 1):
        key, k_walk, k_light, k_shadow, k_dir = prng.split(key, 5)
        hit = delta_tracking(k_walk, position, direction, volume, tf, config,
                             active=valid if compact else None,
                             sampler=walk_sampler, **walk)
        any_hit = hit.t_out > 0
        if bounce == 0:
            out_alpha = torch.where(valid, any_hit.to(dtype), out_alpha)
            out_depth = torch.where(valid, hit.t_out, out_depth)
            out_normal = torch.where(valid, hit.hit_normal, out_normal)
        # a medium interaction modulates the throughput
        beta = torch.where(any_hit, beta * hit.hit_color[..., :3]
                           * (hit.hit_color[..., 3:4] * config.color_scaling),
                           beta)
        # 1. direct illumination: a shadow ray to the light sphere
        light_pos = sample_light_position(k_light, config, lead, dtype,
                                          ray_id=ray_id)
        light_dir = normalize(light_pos - hit.hit_position)
        p = phase.prob(direction, light_dir, hit.hit_position, b=b)[..., None]
        shadow = delta_tracking(k_shadow, hit.hit_position, light_dir, volume,
                                tf, config, need_normals=False,
                                active=(valid & any_hit) if compact else None,
                                sampler=sampler, **walk)
        unoccluded = shadow.t_out <= 0
        contrib = beta * (p * config.light_intensity)
        emission = torch.where(any_hit & valid & unoccluded,
                               emission + contrib, emission)
        # 2. scatter into the next direction (per-ray uniforms)
        ku, kphi = prng.split(prng.fold_in(k_dir, 7))
        u_s = ray_uniform(ku, ray_id, dtype)[..., 0]
        uphi_s = ray_uniform(kphi, ray_id, dtype)[..., 0]
        next_dir = phase.sample(k_dir, direction, hit.hit_position, b=b,
                                u=u_s, u_phi=uphi_s)
        pn = phase.prob(direction, next_dir, hit.hit_position, b=b)[..., None]
        go_on = any_hit & valid
        beta = torch.where(go_on, beta * pn, beta)
        position = torch.where(go_on, hit.hit_position, position)
        direction = torch.where(go_on, next_dir, direction)
        valid = valid & any_hit

    return RayEvaluationOutput(
        color=torch.cat([emission, out_alpha], dim=-1),
        depth=out_depth, normal=safe_normalize(out_normal))
