"""Fused SRN volume-rendering march, forward: the CUDA kernel and its
plain PyTorch version.

Replaces ``fvsrn_tpu/ops/fused_mega.py:_mega_fwd_kernel`` (the
non-differentiable launch of ``mega_trace_dvr``). ``mega_trace_dvr``
launches ``csrc/mega_fwd.cu`` for CUDA tensors and runs
``mega_trace_dvr_plain`` for CPU tensors; on a CUDA tensor it never
falls back to the plain version. Both return rgba (R, 4) in the order of
the input rays, and optionally the number of samples each ray tile
evaluated.

What is computed (the semantics of the TPU kernel, not its layout):
rays are cut into tiles of ``tile`` consecutive rays. A tile marches the
global lattice t = k*stepsize from k0t, the minimum over ALL its rays of
ceil(tmin/stepsize), in segments of ``seg`` points. A segment runs when
some ray of the tile has a live point in it (t <= tmax after the clip,
k >= the ray's own first point) and, with the early-out, while some ray
of the tile has alpha < 0.999 at the segment's start.
Each live sample: trilinear latent fetch from the grid stored as bf16
(the product path's table), Fourier features, the MLP in float32, the
density head, the piecewise-linear TF, Beer-Lambert "over".

Bound of the kernel on the H100: operations (about 7.6 kFLOP and 110
transcendentals per sample, 44 bytes per ray). This first kernel runs
the MLP on the float32 CUDA cores, one sample per thread at a time,
weights broadcast from shared memory and the bf16 latent table in L2;
tensor-core layers (mma/wgmma over samples batched per warpgroup) are
later work.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch import Tensor

from ..models.latent import grid_sample_3d
from ..models.srn import SceneRepresentationNetwork, apply_output
from ..utils.device import strict_f32
from ..utils.vecmath import intersect_aabb
from . import _build

# kernel launches since the last reset (the plain version never counts)
LAUNCHES = 0

KERNEL_TILE = 256
HIDDEN = 32
LATENT_CHANNELS = 16
TABLE_DTYPE = torch.bfloat16
EARLY_ALPHA = 0.999      # the tile vote's threshold, as in the JAX package
_PLAIN_CHUNK_SAMPLES = 1 << 21


def ray_packet(ray_start: Tensor, ray_dir: Tensor, box_min, box_size,
               stepsize: float, tmax_clip: Optional[Tensor] = None
               ) -> Tensor:
    """(R, 8) float32: [start xyz, dir xyz, k0_ray, tmax], with k0_ray =
    ceil(max(tmin, 0)/stepsize) and tmax clamped by ``tmax_clip``. A ray
    leaves the box within its diagonal, so tmax is also held below
    tmin + diagonal: exact for every ray that enters the box, and a finite
    bound for degenerate ones."""
    dev = ray_start.device
    rs = ray_start.reshape(-1, 3).to(torch.float32)
    rd = ray_dir.reshape(-1, 3).to(torch.float32)
    bmin = torch.as_tensor(box_min, dtype=torch.float32, device=dev)
    bsize = torch.as_tensor(box_size, dtype=torch.float32, device=dev)
    tmin, tmax = intersect_aabb(rs, rd, bmin, bsize)
    tmin = torch.clamp(tmin, min=0.0)
    if tmax_clip is not None:
        tmax = torch.minimum(tmax, tmax_clip.reshape(tmax.shape).to(
            torch.float32))
    diag = math.sqrt(sum(float(s) ** 2 for s in box_size))
    tmax = torch.minimum(tmax, tmin + (1.001 * diag + 2.0 * stepsize))
    k0 = torch.ceil(tmin / stepsize)
    return torch.cat([rs, rd, k0, tmax], dim=1).contiguous()


def _tf_points(tf_tensor: Tensor) -> Tensor:
    tf = tf_tensor.to(torch.float32)
    if tf.ndim != 2 or tf.shape[1] != 5 or tf.shape[0] < 2:
        raise ValueError("piecewise TF tensor must be (R >= 2, 5)")
    return tf


def _check_network(net: SceneRepresentationNetwork):
    if not net.output_mode.startswith("density"):
        raise NotImplementedError("fused march: density output modes only")
    if net.use_direction:
        raise NotImplementedError("fused march: no direction input")


def _shade(net: SceneRepresentationNetwork, grid: Optional[Tensor],
           tf: Tensor, pos01: Tensor, valid: Tensor, h: float,
           density_min: float, density_max: float):
    """(rgb, absorption) of samples at ``pos01`` (..., 3): the network
    (latent fetch from ``grid``), the density head, the piecewise TF with
    its interior-knot interval choice. Invalid samples absorb nothing."""
    x = pos01.reshape(-1, 3)
    feats = [x] + ([grid_sample_3d(grid, x)] if grid is not None else [])
    y = net.input(torch.cat(feats, dim=1))
    for layer in net.layers:
        y = layer(y)
    value = apply_output(net.output_mode, y).reshape(valid.shape)
    d = torch.clamp((value - density_min) * (1.0 / (density_max
                                                     - density_min)),
                    0.0, 1.0)
    iv = torch.zeros_like(d, dtype=torch.int64)
    for q in range(1, tf.shape[0] - 1):
        iv += (tf[q, 4] <= d).to(torch.int64)
    c0, c1 = tf[iv], tf[iv + 1]
    frac = ((torch.minimum(torch.maximum(d, c0[..., 4]), c1[..., 4])
             - c0[..., 4]) / (c1[..., 4] - c0[..., 4]))
    rgba = c0[..., :4] + frac[..., None] * (c1[..., :4] - c0[..., :4])
    require = valid & (value >= density_min)
    return rgba[..., :3], torch.where(require, rgba[..., 3] * h,
                                      torch.zeros_like(d))


@torch.no_grad()
def mega_trace_dvr_plain(ray_start: Tensor, ray_dir: Tensor,
                         net: SceneRepresentationNetwork, box_min, box_size,
                         tf_tensor: Tensor, *, stepsize: float,
                         tmax_clip: Optional[Tensor] = None,
                         seg: int = 32, tile: int = KERNEL_TILE,
                         density_min: float = 0.0, density_max: float = 1.0,
                         enable_early_out: bool = True,
                         return_samples: bool = False):
    """Plain PyTorch version of :func:`mega_trace_dvr`: the same schedule
    vectorized over tiles and rays, a Python loop over segments."""
    strict_f32()
    _check_network(net)
    rays = ray_packet(ray_start, ray_dir, box_min, box_size, stepsize,
                      tmax_clip)
    if rays.shape[0] % tile:
        raise ValueError(f"ray count {rays.shape[0]} must be a multiple "
                         f"of tile={tile}")
    dev = rays.device
    bmin = torch.as_tensor(box_min, dtype=torch.float32, device=dev)
    bsize = torch.as_tensor(box_size, dtype=torch.float32, device=dev)
    tf = _tf_points(tf_tensor).to(dev)
    grid = net.latent.static_grid
    if grid is not None:
        # the kernel's storage rounding, then float32 math
        grid = grid.to(TABLE_DTYPE).to(torch.float32)
    h = float(stepsize)
    n_tiles = rays.shape[0] // tile
    packet = rays.reshape(n_tiles, tile, 8)
    k0r, tmx = packet[..., 6], packet[..., 7]
    # the tile's lattice base: every ray counts, box-missing ones too
    k0t = torch.where(torch.isnan(k0r), torch.inf, k0r).amin(
        dim=1, keepdim=True)
    rgb = torch.zeros(n_tiles, tile, 3, device=dev)
    alpha = torch.zeros(n_tiles, tile, device=dev)
    samples = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    early = EARLY_ALPHA if enable_early_out else 2.0
    steps = torch.arange(seg, dtype=torch.float32, device=dev)
    chunk = max(1, _PLAIN_CHUNK_SAMPLES // (tile * seg))
    for s in range(1 << 30):
        ka = k0t + float(s * seg)
        first = torch.maximum(k0r, ka) * h
        if not bool((first <= tmx).any()):
            break                        # no tile has lattice points left
        alive = (first <= torch.minimum(tmx, (ka + float(seg - 1)) * h)
                 ).any(dim=1)
        vote = (alpha < early).any(dim=1)
        for idx in torch.nonzero(alive & vote).flatten().split(chunk):
            k = (ka[idx][:, :, None] + steps).expand(-1, tile, -1)
            valid = ((k * h <= tmx[idx][..., None])
                     & (k >= k0r[idx][..., None]))
            p = packet[idx][:, :, None, :]
            pos01 = (p[..., 0:3] + (k * h)[..., None] * p[..., 3:6]
                     - bmin) / bsize
            color, absn = _shade(net, grid, tf, pos01, valid, h,
                                 density_min, density_max)
            ca = 1.0 - torch.exp(-absn)
            a, c = alpha[idx], rgb[idx]
            for j in range(seg):     # front-to-back "over"
                w = (1.0 - a) * ca[..., j]
                c = c + w[..., None] * color[..., j, :]
                a = a + (1.0 - a) * ca[..., j]
            alpha[idx], rgb[idx] = a, c
            samples[idx] += valid.sum(dim=(1, 2))
    out = torch.cat([rgb, alpha[..., None]], -1).reshape(-1, 4)
    return (out, samples) if return_samples else out


def _pack_weights(net: SceneRepresentationNetwork, tf: Tensor) -> Tensor:
    """The kernel's packed float32 weights (layout in csrc/mega_fwd.cu)."""
    dev = tf.device
    f32 = dict(dtype=torch.float32, device=dev)
    fm = net.input.fourier_matrix
    b = (fm.to(**f32) if fm is not None else torch.zeros(0, 3, **f32))
    w1 = net.layers[0].weight.to(**f32)
    cl = net.latent.total_channels
    w1 = torch.cat([w1, torch.zeros(w1.shape[0], LATENT_CHANNELS - cl,
                                    **f32)], dim=1)
    hidden = net.layers[1:-1]
    out = net.layers[-1]
    parts = [b, w1, net.layers[0].bias.to(**f32)]
    parts += [l.weight.to(**f32) for l in hidden]
    parts += [l.bias.to(**f32) for l in hidden]
    parts += [out.weight.to(**f32), out.bias.to(**f32), tf]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def latent_table(net: SceneRepresentationNetwork) -> Tensor:
    """The latent grid (C, D, H, W) as the kernel's channel-last
    (D, H, W, 16) bf16 table, channels zero-padded to 16."""
    grid = net.latent.static_grid
    c = grid.shape[0]
    t = grid.detach().permute(1, 2, 3, 0)
    if c < LATENT_CHANNELS:
        t = torch.cat([t, t.new_zeros(t.shape[:3] + (LATENT_CHANNELS - c,))],
                      dim=3)
    return t.to(TABLE_DTYPE).contiguous()


def _check_kernel_inputs(net, rays: Tensor, tile: int):
    """What the kernel takes: the product network's shape (32-wide
    SnakeAlt layers, ``density:direct`` head, a latent grid of <= 16
    channels, positional Fourier features) and 256-ray tiles."""
    if tile != KERNEL_TILE:
        raise NotImplementedError(f"CUDA kernel: tile={KERNEL_TILE} only")
    if rays.shape[0] % tile:
        raise ValueError(f"ray count {rays.shape[0]} must be a multiple "
                         f"of tile={tile}")
    widths = {l.weight.shape[0] for l in net.layers[:-1]}
    acts = {(l.activation, l.activation_param) for l in net.layers[:-1]}
    if (widths != {HIDDEN} or len(acts) != 1
            or next(iter(acts))[0] != "SnakeAlt"
            or net.output_mode != "density:direct"):
        raise NotImplementedError("CUDA kernel: 32-wide SnakeAlt layers "
                                  "and a density:direct head only")
    grid = net.latent.static_grid
    if grid is None or grid.shape[0] > LATENT_CHANNELS:
        raise NotImplementedError("CUDA kernel: a latent grid of <= 16 "
                                  "channels")
    fm = net.input.fourier_matrix
    if fm is not None and fm.shape[1] != 3:
        raise NotImplementedError("CUDA kernel: positional Fourier only")


def _bind(lib: ctypes.CDLL):
    fn = lib.mega_fwd_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, p, p, i, i, i, i, i, i, i, f, i,
                   f, f, f, f, f, f, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def mega_trace_dvr(ray_start: Tensor, ray_dir: Tensor,
                   net: SceneRepresentationNetwork, box_min, box_size,
                   tf_tensor: Tensor, *, stepsize: float,
                   tmax_clip: Optional[Tensor] = None,
                   seg: int = 32, tile: int = KERNEL_TILE,
                   density_min: float = 0.0, density_max: float = 1.0,
                   enable_early_out: bool = True,
                   return_samples: bool = False):
    """Fused SRN march forward (see the module doc). CUDA tensors launch
    the kernel, CPU tensors run :func:`mega_trace_dvr_plain`. Returns
    rgba (R, 4), and the samples evaluated per tile with
    ``return_samples``."""
    kw = dict(stepsize=stepsize, tmax_clip=tmax_clip, seg=seg, tile=tile,
              density_min=density_min, density_max=density_max,
              enable_early_out=enable_early_out,
              return_samples=return_samples)
    if ray_start.device.type == "cpu":
        return mega_trace_dvr_plain(ray_start, ray_dir, net, box_min,
                                    box_size, tf_tensor, **kw)
    if ray_start.device.type != "cuda":
        raise ValueError(f"unsupported device {ray_start.device}")
    _check_network(net)
    dev = ray_start.device
    rays = ray_packet(ray_start, ray_dir, box_min, box_size, stepsize,
                      tmax_clip)
    _check_kernel_inputs(net, rays, tile)
    tf = _tf_points(tf_tensor).to(dev).contiguous()
    weights = _pack_weights(net, tf)
    table = latent_table(net).to(dev)
    if table.data_ptr() % 16:
        raise ValueError("latent table must be 16-byte aligned")
    for name, t in (("rays", rays), ("weights", weights), ("table", table)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    gz, gy, gx = table.shape[:3]
    n_tiles = rays.shape[0] // tile
    out = torch.empty(rays.shape[0], 4, dtype=torch.float32, device=dev)
    samples = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    bmin = [float(v) for v in box_min]
    bsize = [float(v) for v in box_size]
    launch = _bind(_build.load("mega_fwd"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            rays.data_ptr(), table.data_ptr(), weights.data_ptr(),
            weights.numel(), out.data_ptr(), samples.data_ptr(),
            rays.shape[0], gx, gy, gz, net.input.num_fourier,
            len(net.layers) - 2, tf.shape[0],
            net.layers[0].activation_param, seg, float(stepsize),
            float(density_min), 1.0 / (density_max - density_min),
            EARLY_ALPHA if enable_early_out else 2.0, *bmin, *bsize, stream)
    if err != 0:
        raise RuntimeError(f"mega_fwd launch failed with CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return (out, samples) if return_samples else out
