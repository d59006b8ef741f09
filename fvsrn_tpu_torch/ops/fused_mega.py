"""Fused SRN volume-rendering march: the CUDA kernels and their plain
PyTorch versions, forward and backward.

Replaces the TPU kernels of ``fvsrn_tpu/ops/fused_mega.py``:
``_mega_fwd_kernel`` in its render launch and in its differentiable launch
(``_make_mega_op``'s forward, which also stores the carry entering every
(tile, segment)), and ``_mega_bwd_kernel`` (``_make_mega_op``'s backward).
``mega_trace_dvr`` launches ``csrc/mega_fwd.cu`` (and, for gradients,
``csrc/mega_bwd.cu`` through a ``torch.autograd.Function``) for CUDA
tensors and runs the plain versions for CPU tensors; on a CUDA tensor it
never falls back to a plain version. Both return rgba (R, 4) in the order
of the input rays, and optionally the number of samples each ray tile
evaluated.

What is computed (the semantics of the TPU kernel, not its layout):
rays are cut into tiles of ``tile`` consecutive rays. A tile marches the
global lattice t = k*stepsize from k0t, the minimum over ALL its rays of
ceil(tmin/stepsize), in segments of ``seg`` points. A segment runs when
some ray of the tile has a live point in it (t <= tmax after the clip,
k >= the ray's own first point) and, with the early-out, while some ray
of the tile has alpha < ``alpha_early_out`` (0.999) at the segment's
start; and, with a ``segment_active`` mask (TF-aware empty-space culling,
``ops/occupancy.py``), where the mask keeps the (tile, segment).
Each live sample: trilinear latent fetch (a bf16 table by default for
the render, float32 for training, either on request: ``table_dtype``),
Fourier features of the position (and of the ray
direction, with direction input), the MLP in float32 (any width, one
activation for every hidden layer), the output head: a density head
through the TF (piecewise-linear, texture, 1D- or 2D-preintegrated,
Gaussians: ``tf_mode``, as ``ops.fused_dvr.prepare_tf`` packs it), or
an rgbo head's own color and absorption (the TF is not read); then
Beer-Lambert "over". With ``need_normals`` (density heads; the render,
as in the JAX package) each counting sample's world-space position
gradient, normal and, with a ``brdf``, shading (``ops.fused_dvr.
shade_samples``), the normal and depth blended with the colour's weights:
the normals instances (``csrc/mega_fwd_nrm*.cu``, the piecewise TF) on
the card, and the call returns ``RayEvaluationOutput``.

The gradient is that of the TPU kernel's adjoint. With a bf16 table under
training the table's gradient is summed in float32 and rounded to bf16
once per cell (the JAX kernel's ``slab_dtype`` output), then widened into
the grid by the cast's backward. With ``ray_grads`` the rays get theirs
(the JAX kernel's ``want_ray_grads``): each sample's position cotangent
(the network's position input, the Fourier features and the trilinear
fetch's weights) folded over the segment into d_start = sum d_x / bsize
and d_dir = sum d_x t / bsize (plus the direction input's), ``k0`` and
``tmax`` held constant (the a.e. derivative: lattice sampling makes the
loss a staircase in them). The gradient fixes the subgradients at the
clips: a sample that absorbs nothing passes no
gradient; the TF knot positions get gradients only strictly inside an
interval; the clips of the density (0 < d < 1), of the ``:direct`` heads
(0 < y < 1, y > 0) and ReLU's kink (y > 0) are strict. The plain versions write these gates with
``torch.where`` so that autograd reproduces them, and the backward
replays the forward's tile vote on the stored incoming carries.

Bound of the kernels on the H100: operations (the flagship's forward
about 7.6 kFLOP and 110 transcendentals per sample, a 64:64:64 network's
about 22.5 kFLOP; 44 bytes per ray; the backward about four times the
forward's work per contributing sample). Both batch the samples of
32-ray groups into tiles of (ray, sample) rows and run every layer as a
TF32 three-pass tensor-core product: the forward on tiles a warp owns,
with no block barrier between layers (``csrc/warp_mlp.cuh``), the
backward, its transposed layers and weight gradients on tiles of the
block (``csrc/sample_mlp.cuh``). The hidden width is a template
parameter of both, one source per width (``csrc/mega_fwd.cu``, ``mega_fwd48.cu``,
``mega_fwd64.cu`` and the same for ``mega_bwd``; the forward's other TF
modes and other networks in sources of their own, :func:`_fwd_kind`);
narrower networks are zero-padded to 32, 48 or 64, which is exact.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.srn import SceneRepresentationNetwork
from ..utils.device import as_f32, constant, strict_f32
from ..utils.vecmath import intersect_aabb
from . import _build

# kernel launches since the last reset (the plain versions never count),
# by instance: "<kind>:t<tile>:<bf16|f32>", ":rays" after a backward's
# ray-gradient instance; kind is mega_fwd (the render forward),
# mega_fwd_diff (the differentiable forward), mega_bwd (the backward) or
# mega_fwd_nrm (the render's normals instances, need_normals)
LAUNCHES: collections.Counter = collections.Counter()
# the forward's launches by library (library_name: mega_fwd_anytf48, say),
# the render's and the training forward's
LIBRARY_LAUNCHES: collections.Counter = collections.Counter()


def launches(kind: str) -> int:
    """Launches of ``kind`` since the last reset, over every instance."""
    return sum(n for key, n in LAUNCHES.items()
               if key.split(":")[0] == kind)

KERNEL_TILE = 256        # the product render's tile
# the tiles the kernels are built for (csrc/mega_common.cuh's MEGA_TILE):
# the tile decides the image where the vote fires, JAX's config chooser
# yields multiples of 128, bench.py marches 128, the product render 256
KERNEL_TILES = (128, 256)
KERNEL_SEG = 32          # the backward kernel's segment length
KERNEL_WIDTHS = (32, 48, 64)   # hidden widths of the kernels' instances
LATENT_CHANNELS = 16
MAX_FOURIER = 32         # the kernels' compile-time limits (mega_common.cuh)
MAX_HIDDEN_LAYERS = 6    # hidden->hidden layers
MAX_TF_POINTS = 16
# the kernels' activation and head ids (csrc/march_common.cuh)
_ACTIVATIONS = {"None": 0, "NONE": 0, "ReLU": 1, "Sine": 2, "Sigmoid": 3,
                "Softplus": 4, "Snake": 5, "SnakeAlt": 6}
_HEADS = {"density": 0, "density:direct": 1, "rgbo": 2, "rgbo:direct": 3,
          "rgbo:exp": 4}
TABLE_DTYPE = torch.bfloat16
EARLY_ALPHA = 0.999      # the tile vote's threshold, as in the JAX package
_PLAIN_CHUNK_SAMPLES = 1 << 21


class MarchSpec(NamedTuple):
    """What one march needs besides its tensors."""
    stepsize: float
    seg: int
    tile: int
    density_min: float
    density_max: float
    early_alpha: float          # 2.0 disables the vote
    box_min: tuple
    box_size: tuple
    activations: tuple          # (name, param) of every layer
    output_mode: str
    tf_mode: str = "piecewise"  # ops.fused_dvr.TF_MODES (rgbo: piecewise)
    tf_points: int = 0          # ops.fused_dvr.prepare_tf's tf_points,
    tf_pre_rows: int = 0        # tf_pre_rows
    direction: bool = False     # the ray direction is a network input
    width: int = 32             # the hidden layers' width
    normals: bool = False       # need_normals: the blended normal, depth
    brdf: tuple = ()            # ops.fused_dvr.brdf_tuple's shading


def ray_packet(ray_start: Tensor, ray_dir: Tensor, box_min, box_size,
               stepsize: float, tmax_clip: Optional[Tensor] = None
               ) -> Tensor:
    """(R, 8) float32: [start xyz, dir xyz, k0_ray, tmax], with k0_ray =
    ceil(max(tmin, 0)/stepsize) and tmax clamped by ``tmax_clip``; the
    start and direction columns keep the rays' autograd graph, k0_ray and
    tmax are detached. A ray
    leaves the box within its diagonal, so tmax is also held below
    tmin + diagonal: exact for every ray that enters the box, and a finite
    bound for degenerate ones."""
    dev = ray_start.device
    rs = ray_start.reshape(-1, 3).to(torch.float32)
    rd = ray_dir.reshape(-1, 3).to(torch.float32)
    bmin = as_f32(box_min, dev)
    bsize = as_f32(box_size, dev)
    # k0_ray and tmax are constants of the march (the JAX op's VJP gives
    # them no cotangent); only start and direction carry the rays' graph
    tmin, tmax = intersect_aabb(rs.detach(), rd.detach(), bmin, bsize)
    tmin = torch.clamp(tmin, min=0.0)
    if tmax_clip is not None:
        tmax = torch.minimum(tmax, tmax_clip.detach().reshape(tmax.shape).to(
            torch.float32))
    diag = math.sqrt(sum(float(s) ** 2 for s in box_size))
    tmax = torch.minimum(tmax, tmin + (1.001 * diag + 2.0 * stepsize))
    k0 = torch.ceil(tmin / stepsize)
    return torch.cat([rs, rd, k0, tmax], dim=1).contiguous()


def _check_network(net: SceneRepresentationNetwork):
    """The march evaluates every hidden layer with one activation, as the
    JAX megakernel does."""
    acts = {(l.activation, l.activation_param) for l in net.layers[:-1]}
    if len(acts) != 1:
        raise NotImplementedError("fused march: hidden layers of one "
                                  "activation")


def _density(spec) -> bool:
    return spec.output_mode.startswith("density")


def _spec(net, box_min, box_size, *, stepsize, seg, tile, density_min,
          density_max, enable_early_out,
          alpha_early_out=EARLY_ALPHA, tf_mode="piecewise", tf_points=0,
          tf_pre_rows=0, need_normals=False, brdf=None) -> MarchSpec:
    """The march's spec. The rgbo heads read no TF: their spec is the
    piecewise one with no TF rows, whatever ``tf_mode`` says."""
    from .fused_dvr import brdf_tuple
    if not net.output_mode.startswith("density"):
        tf_mode, tf_points, tf_pre_rows = "piecewise", 0, 0
    return MarchSpec(
        stepsize=float(stepsize), seg=int(seg), tile=int(tile),
        density_min=float(density_min), density_max=float(density_max),
        early_alpha=float(alpha_early_out) if enable_early_out else 2.0,
        box_min=tuple(float(v) for v in box_min),
        box_size=tuple(float(v) for v in box_size),
        activations=tuple((l.activation, l.activation_param)
                          for l in net.layers),
        output_mode=net.output_mode, tf_mode=tf_mode,
        tf_points=int(tf_points), tf_pre_rows=int(tf_pre_rows),
        direction=bool(net.use_direction),
        width=int(net.layers[0].weight.shape[0]),
        normals=bool(need_normals), brdf=brdf_tuple(brdf, need_normals))


def _params(net: SceneRepresentationNetwork, tf: Tensor) -> list:
    """The march's differentiable inputs, in the autograd Functions'
    order: TF, Fourier matrix ((0, 3) when there is none), latent grid,
    then every layer's weight and bias."""
    fm = net.input.fourier_matrix
    if fm is None:
        fm = torch.zeros(0, 3, device=tf.device)
    out = [tf, fm, net.latent.static_grid]
    for layer in net.layers:
        out += [layer.weight, layer.bias]
    return out


# ---------------------------------------------------------------------------
# plain versions


def _gated_clip01(x: Tensor) -> Tensor:
    """clip(x, 0, 1) whose gradient passes only where 0 < x < 1."""
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, torch.ones_like(x), x))


def _absorb(valid: Tensor, rgb: Tensor, absn: Tensor):
    """(rgb, ca) of samples of absorption ``absn`` where ``valid`` says
    they count: the others absorb nothing, and a sample that absorbs
    nothing passes no gradient."""
    absn = torch.where(valid, absn, torch.zeros_like(absn))
    ca = 1.0 - torch.exp(-absn)
    contrib = valid & (absn > 0)
    return (torch.where(contrib[..., None], rgb, rgb.detach()),
            torch.where(contrib, ca, ca.detach()))


def _shade(spec: MarchSpec, params: list, pos01: Tensor,
           dirs: Optional[Tensor], valid: Tensor,
           prev_in: Optional[Tensor] = None, first: Optional[Tensor] = None,
           world=None):
    """(rgb, ca, last density, normal) of samples at ``pos01`` (..., seg,
    3) along rays of direction ``dirs`` (the same shape, or None without
    direction input): the per-segment engine's plain network
    (``ops.fused_dvr._network_values``: Fourier features, latent fetch,
    the layers, the output head), then an rgbo head's own color and
    absorption, or a density head's TF (the piecewise TF with its
    interior-knot interval choice, or the other modes by
    ``ops.fused_dvr.tf_shade``, whose preintegrating modes read
    ``prev_in`` and ``first``), Beer-Lambert alpha. Samples that do not
    count absorb nothing; samples that absorb nothing pass no gradient.
    The last density (the segment's last sample's, normalized) is None
    for the piecewise TF. With normals (``world``: the samples' world
    positions and ray directions) each sample's position gradient and
    ``ops.fused_dvr.shade_samples``; else the normal is None."""
    from .fused_dvr import (_network_values, network_position_grad,
                            shade_samples, tf_shade)
    tf = params[0]
    h = spec.stepsize
    net = dict(direction=spec.direction, activation=spec.activations[0],
               output_mode=spec.output_mode)
    x01 = pos01.reshape(-1, 3)
    d01 = None if dirs is None else dirs.reshape(-1, 3)
    if spec.normals:
        vals, g01 = network_position_grad(params, x01, d01, **net)
        vals = vals[:, None]
        bsize = torch.tensor(spec.box_size, dtype=torch.float32,
                             device=pos01.device)
        grad = g01.reshape(pos01.shape) / bsize
    else:
        vals = _network_values(params, x01, d01, **net)
    vals = vals.reshape(valid.shape + vals.shape[-1:])
    if not _density(spec):
        return _absorb(valid, vals[..., :3], vals[..., 3] * h) + (None, None)
    value = vals[..., 0]
    density2 = ((value - spec.density_min)
                * (1.0 / (spec.density_max - spec.density_min)))
    require = valid & (value >= spec.density_min)
    last = None
    if spec.tf_mode != "piecewise":
        rgb, absn = tf_shade(spec, tf, density2, prev_in, first)
        last = density2[..., -1]
    else:
        rgb, absn = _piecewise_rgba(tf, density2, h)
    nrm = None
    if spec.normals:
        rgb, absn, nrm = shade_samples(spec.brdf, rgb, absn, grad, *world)
    return _absorb(require, rgb, absn) + (last, nrm)


def _piecewise_rgba(tf: Tensor, density2: Tensor, h: float):
    """(rgb, absorption) of the piecewise TF at normalized densities
    ``density2``."""
    d = _gated_clip01(density2)
    iv = torch.zeros_like(d, dtype=torch.int64)
    for q in range(1, tf.shape[0] - 1):
        iv += (tf[q, 4] <= d).to(torch.int64)
    # the knots as one-hot products, not gathers: the TF's gradient is
    # then a reduction over the samples, where a gather's backward adds
    # millions of samples one by one into a few rows
    n_knots = tf.shape[0]
    c0 = F.one_hot(iv, n_knots).to(tf.dtype) @ tf
    c1 = F.one_hot(iv + 1, n_knots).to(tf.dtype) @ tf
    p0, p1 = c0[..., 4], c1[..., 4]
    interior = (d > p0) & (d < p1)
    frac = torch.where(interior, (d - p0) / (p1 - p0), (d >= p1).to(d.dtype))
    rgba = c0[..., :4] + frac[..., None] * (c1[..., :4] - c0[..., :4])
    return rgba[..., :3], rgba[..., 3] * h


def _tile_geometry(rays: Tensor, tile: int):
    """(packet (T, tile, 8), k0r, tmx (T, tile), k0t (T, 1)); the packet
    keeps the rays' graph, the lattice geometry is detached (constants of
    the march, as in the JAX op)."""
    n_tiles = rays.shape[0] // tile
    packet = rays.reshape(n_tiles, tile, 8)
    k0r, tmx = packet[..., 6].detach(), packet[..., 7].detach()
    # the tile's lattice base: every ray counts, box-missing ones too
    k0t = torch.where(torch.isnan(k0r), torch.inf, k0r).amin(
        dim=1, keepdim=True)
    return packet, k0r, tmx, k0t


def _check_mask(segment_active: Optional[Tensor], n_tiles: int,
                dev) -> Optional[Tensor]:
    """The occupancy mask as the kernels read it: (n_tiles, n_cols) uint8 on
    ``dev``, nonzero where a (tile, segment) may run. Raises on another
    shape. A segment past the last column is not culled (the JAX package
    asks for at least its certified segment count; the port's march stops
    by itself, so a short mask only culls less)."""
    if segment_active is None:
        return None
    m = torch.as_tensor(segment_active, device=dev)
    if m.ndim != 2 or m.shape[0] != n_tiles or m.shape[1] < 1:
        raise ValueError(f"segment_active shape {tuple(m.shape)} "
                         f"incompatible with (n_tiles, >=1 segments) = "
                         f"({n_tiles}, n_seg)")
    if m.dtype.is_floating_point or m.dtype.is_complex:
        raise ValueError("segment_active must be a bool or integer mask")
    return (m != 0).to(torch.uint8).contiguous()


def _masked(run: Tensor, mask: Optional[Tensor], s: int) -> Tensor:
    """``run`` (per tile) ANDed with column ``s`` of the occupancy mask."""
    if mask is None or s >= mask.shape[1]:
        return run
    return run & mask[:, s].bool()


def _segment_state(spec, k0r, tmx, k0t, s):
    """(later, alive) per tile at segment ``s``: some ray has a lattice
    point at or after the segment's start / inside the segment."""
    h = spec.stepsize
    ka = k0t + float(s * spec.seg)
    first = torch.maximum(k0r, ka) * h
    later = (first <= tmx).any(dim=1)
    alive = (first <= torch.minimum(tmx, (ka + float(spec.seg - 1)) * h)
             ).any(dim=1)
    return later, alive


def _segment(spec, params, packet, k0t, s, carry):
    """March segment ``s`` of the tiles in ``packet`` (n, tile, 8) from
    their incoming ``carry`` (n, tile, 4), or (n, tile, 5) with the last
    density in the TF modes (a ray's first lattice point reads none), (n,
    tile, 9) with normals (``ops.fused_dvr.carry_width``). Returns
    (outgoing carry, samples evaluated per tile)."""
    from .fused_dvr import composite
    h = spec.stepsize
    dev = packet.device
    bmin = constant(spec.box_min, torch.float32, dev)
    bsize = constant(spec.box_size, torch.float32, dev)
    steps = torch.arange(spec.seg, dtype=torch.float32, device=dev)
    k = (k0t + float(s * spec.seg))[:, :, None] + steps
    k = k.expand(-1, packet.shape[1], -1)
    valid = ((k * h <= packet[..., 7:8]) & (k >= packet[..., 6:7]))
    p = packet[:, :, None, :]
    t = k * h
    pos01 = (p[..., 0:3] + t[..., None] * p[..., 3:6] - bmin) / bsize
    dirs = p[..., 3:6].expand(pos01.shape) if spec.direction else None
    tfm = spec.tf_mode != "piecewise"
    world = ((p[..., 0:3] + t[..., None] * p[..., 3:6], p[..., 3:6])
             if spec.normals else None)
    color, ca, last, nrm = _shade(spec, params, pos01, dirs, valid,
                                  carry[..., 4] if tfm else None,
                                  k == packet[..., 6:7] if tfm else None,
                                  world)
    nd = torch.cat([nrm, t[..., None]], dim=-1) if spec.normals else None
    return (composite(spec, carry, color, ca, last, nd),
            valid.sum(dim=(1, 2)))


def _chunks(idx: Tensor, spec: MarchSpec):
    return idx.split(max(1, _PLAIN_CHUNK_SAMPLES // (spec.tile * spec.seg)))


def _plain_march(spec: MarchSpec, rays: Tensor, params: list, *,
                 store: bool = False, mask: Optional[Tensor] = None):
    """The plain forward: (rgba (R, 4), samples per tile, carries
    (T, S, tile, 4 or 5) or None, segments visited per tile or None). A
    segment the tile does not run leaves its carry alone, the last
    density too."""
    from .fused_dvr import initial_carry, march_output
    tile = spec.tile
    packet, k0r, tmx, k0t = _tile_geometry(rays, tile)
    n_tiles = packet.shape[0]
    dev = rays.device
    carry = initial_carry(spec, (n_tiles, tile), dev)
    samples = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    count = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    stopped = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    carries = []
    for s in range(1 << 30):
        later, alive = _segment_state(spec, k0r, tmx, k0t, s)
        if not bool(later.any()):
            break                        # no tile has lattice points left
        vote = (carry[..., 3] < spec.early_alpha).any(dim=1)
        if store:
            visiting = later & ~stopped
            carries.append(carry.clone())
            count[visiting] = s + 1
            stopped |= visiting & ~vote
        run = _masked(alive & vote, mask, s)
        for idx in _chunks(torch.nonzero(run).flatten(), spec):
            carry[idx], n = _segment(spec, params, packet[idx], k0t[idx], s,
                                     carry[idx])
            samples[idx] += n
    out = march_output(spec, carry.reshape(-1, carry.shape[-1]))
    if not store:
        return out, samples, None, None
    stack = (torch.stack(carries, dim=1) if carries
             else carry.new_zeros(n_tiles, 0, tile, carry.shape[-1]))
    return out, samples, stack, count


def _plain_backward(spec: MarchSpec, rays: Tensor, params: list,
                    carries: Tensor, count: Tensor, d_out: Tensor,
                    mask: Optional[Tensor] = None, want_rays: bool = False):
    """(gradients of ``params``, the ray packet's (R, 8) or None) from the
    rgba cotangent: segments in reverse, the vote replayed on the stored
    carries, each segment re-run from its stored carry under autograd
    (with ``want_rays`` the tiles' packets are leaves too: only their
    start and direction columns reach the samples' positions)."""
    tile = spec.tile
    packet, k0r, tmx, k0t = _tile_geometry(rays, tile)
    d_packet = torch.zeros_like(packet) if want_rays else None
    leaves = [None if p is None else p.detach().requires_grad_()
              for p in params]
    grads = [None if p is None else torch.zeros_like(p) for p in params]
    used = [i for i, p in enumerate(leaves) if p is not None]
    dcarry = torch.zeros(d_out.shape[0] // tile, tile, carries.shape[-1],
                         dtype=torch.float32, device=d_out.device)
    dcarry[..., :4] = d_out.reshape(-1, tile, 4)
    for s in reversed(range(carries.shape[1])):
        _, alive = _segment_state(spec, k0r, tmx, k0t, s)
        cs = carries[:, s]
        vote = (cs[..., 3] < spec.early_alpha).any(dim=1)
        run = _masked((count > s) & alive & vote, mask, s)
        for idx in _chunks(torch.nonzero(run).flatten(), spec):
            with torch.enable_grad():
                cin = cs[idx].detach().requires_grad_()
                pk = packet[idx].detach().requires_grad_(want_rays)
                cout, _ = _segment(spec, leaves, pk, k0t[idx], s, cin)
                g = torch.autograd.grad(
                    cout, [cin] + [leaves[i] for i in used]
                    + ([pk] if want_rays else []), dcarry[idx],
                    allow_unused=True)
            dcarry[idx] = g[0]
            for i, gi in zip(used, g[1:1 + len(used)]):
                if gi is not None:
                    grads[i] += gi
            if want_rays and g[-1] is not None:
                d_packet[idx] += g[-1]
    return grads, (d_packet.reshape(-1, 8) if want_rays else None)


class _PlainMarch(torch.autograd.Function):
    """The plain differentiable march: the forward stores the carries
    entering every visited segment, the backward re-runs the segments in
    reverse (``_plain_backward``)."""

    @staticmethod
    def forward(ctx, rays, spec, mask, *params):
        out, samples, carries, count = _plain_march(spec, rays, list(params),
                                                    store=True, mask=mask)
        ctx.spec = spec
        ctx.mask = mask
        ctx.has_grid = params[2] is not None
        saved = [p for p in params if p is not None]
        ctx.save_for_backward(rays, carries, count, *saved)
        ctx.mark_non_differentiable(samples)
        return out, samples

    @staticmethod
    def backward(ctx, d_out, _d_samples):
        rays, carries, count, *saved = ctx.saved_tensors
        params = list(saved)
        if not ctx.has_grid:
            params.insert(2, None)
        grads, d_rays = _plain_backward(ctx.spec, rays, params, carries,
                                        count, d_out, ctx.mask,
                                        ctx.needs_input_grad[0])
        return (d_rays, None, None, *grads)


def mega_trace_dvr_plain(ray_start: Tensor, ray_dir: Tensor,
                         net: SceneRepresentationNetwork, box_min, box_size,
                         tf_tensor: Tensor, *, stepsize: float,
                         tmax_clip: Optional[Tensor] = None,
                         seg: int = 32, tile: int = KERNEL_TILE,
                         density_min: float = 0.0, density_max: float = 1.0,
                         alpha_early_out: float = EARLY_ALPHA,
                         enable_early_out: bool = True,
                         differentiable: bool = False,
                         table_dtype: Optional[torch.dtype] = None,
                         segment_active: Optional[Tensor] = None,
                         tf_mode: str = "piecewise",
                         tf_pre: Optional[Tensor] = None,
                         need_normals: bool = False, brdf=None,
                         time=0.0, ensemble=0.0, ray_grads: bool = False,
                         return_samples: bool = False):
    """Plain PyTorch version of :func:`mega_trace_dvr`: the same schedule
    vectorized over tiles and rays, a Python loop over segments; with
    ``differentiable`` an autograd Function with the kernels' gradient
    (and, with ``ray_grads``, the rays' through autograd of the samples'
    positions); with ``need_normals`` each sample's position gradient by
    ``ops.fused_dvr.network_position_grad``."""
    from .fused_dvr import (_check_normals_request, prepare_tf,
                            resolve_network)
    strict_f32()
    net = resolve_network(net, time, ensemble)
    _check_normals_request(net, differentiable=differentiable,
                           need_normals=need_normals, iso_value=None)
    _check_network(net)
    ray_start, ray_dir = _ray_leaves(ray_start, ray_dir, differentiable,
                                     ray_grads)
    rays = ray_packet(ray_start, ray_dir, box_min, box_size, stepsize,
                      tmax_clip)
    if rays.shape[0] % tile:
        raise ValueError(f"ray count {rays.shape[0]} must be a multiple "
                         f"of tile={tile}")
    table, tf_points, tf_pre_rows = prepare_tf(tf_tensor, tf_mode, tf_pre,
                                               rays.device)
    spec = _spec(net, box_min, box_size, stepsize=stepsize, seg=seg,
                 tile=tile, density_min=density_min,
                 density_max=density_max, enable_early_out=enable_early_out,
                 alpha_early_out=alpha_early_out, tf_mode=tf_mode,
                 tf_points=tf_points, tf_pre_rows=tf_pre_rows,
                 need_normals=need_normals, brdf=brdf)
    params = _params(net, table)
    mask = _check_mask(segment_active, rays.shape[0] // tile, rays.device)
    table_dtype = _table_dtype(table_dtype, differentiable)
    if params[2] is not None and table_dtype != torch.float32:
        # the kernel's storage rounding, then float32 math
        params[2] = params[2].to(table_dtype).to(torch.float32)
    if differentiable:
        out, samples = _PlainMarch.apply(rays, spec, mask, *params)
    else:
        with torch.no_grad():
            out, samples, _, _ = _plain_march(spec, rays, params, mask=mask)
    return (out, samples) if return_samples else out


def _ray_leaves(ray_start: Tensor, ray_dir: Tensor, differentiable: bool,
                ray_grads: bool):
    """The rays as the march reads them: their graph kept only for ray
    gradients of a differentiable march, else detached (the JAX op gives
    the rays a zero cotangent without ``ray_grads``)."""
    if differentiable and ray_grads:
        return ray_start, ray_dir
    return ray_start.detach(), ray_dir.detach()


def _table_dtype(table_dtype, differentiable: bool) -> torch.dtype:
    """The latent table's type: bf16 for the render and float32 for
    training unless the caller chooses (both take either, as the JAX
    megakernel's ``table_dtype``)."""
    if table_dtype is None:
        return torch.float32 if differentiable else TABLE_DTYPE
    if table_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported latent table dtype {table_dtype}")
    return table_dtype


# ---------------------------------------------------------------------------
# the CUDA kernels


def kernel_width(net) -> int:
    """The hidden width of the kernel instance (either engine's) that
    takes ``net``: its hidden layers' width rounded up to 32, 48 or 64
    (zero padding is exact: a padded neuron's outgoing weights are zero,
    whatever its activation gives); raises ``NotImplementedError`` for
    layers of several widths or wider than 64."""
    widths = {l.weight.shape[0] for l in net.layers[:-1]}
    if len(widths) != 1 or max(widths) > KERNEL_WIDTHS[-1]:
        raise NotImplementedError("CUDA kernels: hidden layers of one "
                                  f"width <= {KERNEL_WIDTHS[-1]} only")
    return _padded(next(iter(widths)))


def _padded(width: int) -> int:
    return next(w for w in KERNEL_WIDTHS if w >= width)


def _n_in(spec: MarchSpec) -> int:
    """The network's direct inputs: position, and direction with
    direction input."""
    return 6 if spec.direction else 3


def _pack_weights(params: list, spec: MarchSpec) -> Tensor:
    """The kernels' packed float32 weights (layout in csrc/mega_common.cuh,
    ``weight_offsets``), the hidden width zero-padded to
    :func:`kernel_width`: Fourier B over the position and, with direction
    input, Bd over the direction (zeros when the Fourier features read no
    direction); layer 1 over [position, direction, cos, sin, latent] with
    its latent columns zero-padded to 16, its bias; the hidden layers,
    their biases; the output rows (1 for a density head, 4 for rgbo) and
    biases; a density head's TF (the preint2d table apart: the kernels
    read it as its own array)."""
    tf, fourier, layers = params[0], params[1], params[3:]
    f32 = dict(dtype=torch.float32, device=tf.device)
    hp = _padded(spec.width)

    def pad(t, shape):
        out = torch.zeros(shape, **f32)
        out[tuple(slice(0, n) for n in t.shape)] = t.detach().to(**f32)
        return out

    nf = fourier.shape[0]
    k1 = _n_in(spec) + 2 * nf + LATENT_CHANNELS
    parts = [fourier[:, :3]]
    if spec.direction:
        parts.append(pad(fourier[:, 3:6], (nf, 3)))
    parts += [pad(layers[0], (hp, k1)), pad(layers[1], (hp,))]
    parts += [pad(w, (hp, hp)) for w in layers[2:-2:2]]
    parts += [pad(b, (hp,)) for b in layers[3:-2:2]]
    parts += [pad(layers[-2], (layers[-2].shape[0], hp)), layers[-1]]
    if _density(spec) and spec.tf_mode != "preint2d":
        parts.append(tf)
    return torch.cat([p.detach().to(**f32).reshape(-1)
                      for p in parts]).contiguous()


def _unpack_grads(dw: Tensor, params: list, spec: MarchSpec,
                  d_tf2d: Optional[Tensor] = None) -> list:
    """Per-parameter gradients from the packed gradient ``dw`` (the
    inverse of :func:`_pack_weights`; what lies in the padding, and Bd's
    where the Fourier features read no direction, is dropped); the
    preint2d table's is ``d_tf2d``, an rgbo head's TF gets zeros."""
    tf, fourier, layers = params[0], params[1], params[3:]
    n_hidden = len(layers) // 2 - 2
    hp, width = _padded(spec.width), spec.width
    nf = fourier.shape[0]
    n_out = layers[-2].shape[0]
    k1 = _n_in(spec) + 2 * nf + LATENT_CHANNELS
    tf_floats = (tf.numel() if _density(spec) and d_tf2d is None else 0)
    sizes = [("B", nf * 3), ("Bd", nf * 3 if spec.direction else 0),
             ("w1", hp * k1), ("b1", hp), ("wh", n_hidden * hp * hp),
             ("bh", n_hidden * hp), ("wo", n_out * hp), ("bo", n_out),
             ("tf", tf_floats)]
    parts = dict(zip([n for n, _ in sizes],
                     dw.split([n for _, n in sizes])))
    d_layers = [parts["w1"].reshape(hp, k1)[:width, :layers[0].shape[1]],
                parts["b1"][:width]]
    wh = parts["wh"].reshape(n_hidden, hp, hp)
    bh = parts["bh"].reshape(n_hidden, hp)
    for i in range(n_hidden):
        d_layers += [wh[i, :width, :width], bh[i, :width]]
    d_layers += [parts["wo"].reshape(n_out, hp)[:, :width], parts["bo"]]
    d_fm = parts["B"].reshape(nf, 3)
    if fourier.shape[1] == 6:
        d_fm = torch.cat([d_fm, parts["Bd"].reshape(nf, 3)], dim=1)
    if d_tf2d is not None:
        d_tf = d_tf2d.reshape(tf.shape)
    elif _density(spec):
        d_tf = parts["tf"].reshape(tf.shape)
    else:
        d_tf = torch.zeros_like(tf)
    return [d_tf, d_fm, None] + d_layers


def latent_table(grid: Tensor, dtype: torch.dtype = TABLE_DTYPE) -> Tensor:
    """The latent grid (C, D, H, W) as the kernels' channel-last
    (D, H, W, 16) table, channels zero-padded to 16."""
    c = grid.shape[0]
    t = grid.detach().permute(1, 2, 3, 0)
    if c < LATENT_CHANNELS:
        t = torch.cat([t, t.new_zeros(t.shape[:3] + (LATENT_CHANNELS - c,))],
                      dim=3)
    return t.to(dtype).contiguous()


def _kernel_table(grid: Optional[Tensor], dtype: torch.dtype,
                  device) -> Tensor:
    """The kernels' table of ``grid``; without a grid, one zero voxel
    (every latent feature 0, no latent channel read back)."""
    if grid is None:
        return torch.zeros(1, 1, 1, LATENT_CHANNELS, dtype=dtype,
                           device=device)
    return latent_table(grid, dtype)


def _check_kernel_inputs(net, rays: Tensor, tile: int, seg: int = 32,
                         differentiable: bool = False,
                         tf_floats: Optional[int] = None,
                         tf_mode: str = "piecewise",
                         need_normals: bool = False, masked: bool = False):
    """What the kernels take: hidden layers of one width <= 64 (narrower
    zero-padded to 32, 48 or 64) and one activation, 1 to
    ``MAX_HIDDEN_LAYERS + 1`` of them, every output head, direction input,
    no latent grid or one of <= 16 channels, at most ``MAX_FOURIER``
    Fourier features; every TF mode on a density head of a SnakeAlt
    network without direction input, and on every other network on
    256-ray tiles the texture, 1D- and 2D-preintegrated TFs in the render
    and in training (``mega_fwd_anytf``) and the Gaussians in training
    without an occupancy mask (``masked``; ``mega_fwd_anyg``: the render
    refuses Gaussians); tiles of 128 or 256 rays (``KERNEL_TILES``), and
    for the backward 32-point segments; and a shared-memory plan that
    fits. The normals instances take every such network with a density
    head, the piecewise TF and 256-ray tiles. Everything else raises
    ``NotImplementedError``."""
    from .sample_mlp import check_fwd_plan, check_plan
    if need_normals and tf_mode != "piecewise":
        raise NotImplementedError(f"CUDA kernel: normals with TF mode "
                                  f"{tf_mode!r} are not ported yet "
                                  "(piecewise only)")
    if tile not in KERNEL_TILES:
        # the tile is part of the result (the vote is per tile); the
        # kernels are built for the JAX chooser's and bench.py's 128 and
        # the product render's 256
        raise NotImplementedError(f"CUDA kernel: tiles of {KERNEL_TILES} "
                                  f"rays only, not {tile}")
    if need_normals and tile != KERNEL_TILE:
        # the shaded render marches 256-ray tiles; no 128-ray normals
        # instance is built
        raise NotImplementedError(f"CUDA kernel: normals on tiles of "
                                  f"{KERNEL_TILE} rays only, not {tile}")
    if rays.shape[0] % tile:
        raise ValueError(f"ray count {rays.shape[0]} must be a multiple "
                         f"of tile={tile}")
    hp = kernel_width(net)
    n_hidden = len(net.layers) - 2
    if n_hidden > MAX_HIDDEN_LAYERS:
        raise NotImplementedError(f"CUDA kernel: at most "
                                  f"{MAX_HIDDEN_LAYERS + 1} hidden layers")
    act = net.layers[0].activation
    if act not in _ACTIVATIONS:
        raise NotImplementedError(f"CUDA kernel: activation {act}")
    grid = net.latent.static_grid
    if grid is not None and grid.shape[0] > LATENT_CHANNELS:
        raise NotImplementedError("CUDA kernel: a latent grid of <= 16 "
                                  "channels")
    nf = net.input.num_fourier
    if nf > MAX_FOURIER:
        raise NotImplementedError(f"CUDA kernel: at most {MAX_FOURIER} "
                                  "Fourier features")
    density = net.output_mode.startswith("density")
    if not density:
        tf_mode, tf_floats = "piecewise", 0
    if tf_mode != "piecewise" and (act != "SnakeAlt" or net.use_direction):
        if tf_mode == "gaussian" and (masked or not differentiable):
            raise NotImplementedError(
                f"CUDA kernel: TF mode 'gaussian' on a {act} network"
                + (" with direction input" if net.use_direction else "")
                + " in training without an occupancy mask only")
        if tile != KERNEL_TILE:
            raise NotImplementedError(
                f"CUDA kernel: TF mode {tf_mode!r} on a {act} network"
                + (" with direction input" if net.use_direction else "")
                + f" on tiles of {KERNEL_TILE} rays only, not {tile}")
    direction = bool(net.use_direction)
    check_fwd_plan("CUDA kernel", hp, nf, 1, n_hidden, MAX_TF_POINTS,
                   warps=tile // 32, direction=direction, tf_floats=tf_floats)
    if differentiable and seg != KERNEL_SEG:
        raise NotImplementedError(f"CUDA backward: seg={KERNEL_SEG} only")
    if differentiable:
        check_plan("CUDA backward", hp,
                   (6 if direction else 3) + 2 * nf + LATENT_CHANNELS,
                   n_hidden, nf, MAX_TF_POINTS, tf_floats,
                   tf_mode != "piecewise")


def _lib(kind: str, hidden: int, tile: int = KERNEL_TILE) -> ctypes.CDLL:
    """The library of ``kind`` ("mega_fwd", "mega_fwd_tf", "mega_fwd_any",
    "mega_fwd_anytf", "mega_fwd_anyg", "mega_fwd_nrm" or "mega_bwd") for
    the padded width ``hidden`` and the ray tile ``tile``
    (:func:`library_name`)."""
    return _build.load(library_name(kind, hidden, tile))


def library_name(kind: str, hidden: int, tile: int = KERNEL_TILE) -> str:
    """One source per kind, width and tile: ``csrc/mega_fwd.cu`` (32, 256
    rays), ``mega_fwd48.cu``, ``mega_fwd64.cu``, ``mega_fwd_t128.cu`` (32,
    128 rays), ``mega_fwd48_t128.cu``, ``mega_fwd64_t128.cu`` and the same
    for the forward's other parts (:func:`_fwd_kind`) and the backward;
    ``mega_fwd_anytf``, ``mega_fwd_anyg`` and the normals instances on
    256-ray tiles only."""
    name = kind if hidden == 32 else f"{kind}{hidden}"
    return name if tile == KERNEL_TILE else f"{name}_t{tile}"


def _fwd_kind(spec: MarchSpec, net_args: tuple) -> str:
    """The forward's library part (csrc/mega_fwd.cuh's MEGA_PART) for this
    march: "mega_fwd" for SnakeAlt networks without direction input on the
    piecewise TF, "mega_fwd_tf" for their other TF modes, "mega_fwd_any"
    for every other network on the piecewise TF, "mega_fwd_anytf" for
    every other network on the texture and preintegrated TFs and
    "mega_fwd_anyg" on the Gaussians."""
    generic = net_args[1] != _ACTIVATIONS["SnakeAlt"] or net_args[4]
    if spec.tf_mode == "piecewise":
        return "mega_fwd_any" if generic else "mega_fwd"
    if not generic:
        return "mega_fwd_tf"
    return "mega_fwd_anyg" if spec.tf_mode == "gaussian" else "mega_fwd_anytf"


def device_fwd_plan(n_fourier: int, n_hidden: int, tf_points: int,
                    tf_floats: Optional[int] = None, hidden: int = 32,
                    direction: bool = False, tile: int = KERNEL_TILE):
    """(bytes, warps a block, matrices pre-split) of the shared-memory
    plan csrc/mega_fwd.cu takes for these widths (``tf_floats`` staged TF
    floats, 5 a piecewise knot by default), or None when it does not fit
    (the device's own ``choose_fwd_plan`` at tile / 32 warps;
    ``ops.sample_mlp.fwd_plan`` mirrors it)."""
    fn = _lib("mega_fwd", hidden, tile).mega_fwd_smem
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_long * 3)()
    if fn(n_fourier, n_hidden,
          5 * tf_points if tf_floats is None else tf_floats, int(direction),
          out) != 0:
        return None
    return int(out[0]), int(out[1]), bool(out[2])


def _check_tensors(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count(kind: str, tile: int, table: Tensor, rays: bool = False):
    """One launch of ``kind`` into LAUNCHES, keyed by its tile and table
    type."""
    dtype = "bf16" if table.dtype == torch.bfloat16 else "f32"
    LAUNCHES[f"{kind}:t{tile}:{dtype}" + (":rays" if rays else "")] += 1


def _bind_fwd(lib: ctypes.CDLL):
    fn = lib.mega_fwd_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, f,
                   i, i, i, i, f, f, f, f, f, f, f, f, f, f, p, i, i, i, i,
                   p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.mega_bwd_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                   i, i, f, i, i, i, i, f, f, f, f, f, f, f, f, f, f, p, i,
                   i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _knots(spec: MarchSpec, tf_points: int) -> int:
    """The piecewise knots a launch stages: none for an rgbo head, which
    reads no TF (its spec is piecewise with no rows)."""
    return tf_points if _density(spec) else 0


def _net_args(spec: MarchSpec) -> tuple:
    """The network arguments of a launch: padded width, activation id and
    parameter, head id, direction input."""
    name, param = spec.activations[0]
    return (_padded(spec.width), _ACTIVATIONS[name], param,
            _HEADS[spec.output_mode], int(spec.direction))


def segments_needed(rays: Tensor, spec: MarchSpec) -> int:
    """Segments the longest tile can visit, from this call's rays: the
    lattice points between the tile's base k0t and its last live point
    (at most ``max_steps_bound`` plus the tile's spread of entry points),
    plus one segment of slack for rounding. Syncs with the device once."""
    _, k0r, tmx, k0t = _tile_geometry(rays, spec.tile)
    return _segments_needed(k0r, tmx, k0t, spec.stepsize, spec.seg)


def _segments_needed(k0r: Tensor, tmx: Tensor, k0t: Tensor, h: float,
                     seg: int) -> int:
    """:func:`segments_needed` from the tile geometry of
    :func:`_tile_geometry`."""
    live = k0r * h <= tmx
    last = torch.where(live, torch.floor(tmx / h), -torch.inf).amax(dim=1)
    need = torch.where(live.any(dim=1),
                       torch.floor((last - k0t[:, 0]) / seg) + 1.0,
                       torch.zeros_like(last))
    return int(need.max().item()) + 1 if need.numel() else 1


def _mask_args(mask: Optional[Tensor]):
    """(pointer, columns) of an occupancy mask from :func:`_check_mask`."""
    return (None, 0) if mask is None else (mask.data_ptr(), mask.shape[1])


class TfCarries(NamedTuple):
    """The stored carries of the TF modes: rgba (T, S, tile, 4) and the
    last density (T, S, tile) entering each visited segment."""
    rgba: Tensor
    dens: Tensor


def _tf_args(spec: MarchSpec, tf: Optional[Tensor], tf_points: int):
    """The TF arguments of a launch: (rows, mode id, cumulative rows, packed
    TF floats, preint2d table pointer or None); ``tf`` is
    ``ops.fused_dvr.prepare_tf``'s table (None: piecewise knots)."""
    from .fused_dvr import TF_MODES
    from .sample_mlp import tf_floats_of
    if spec.tf_mode == "piecewise":
        return tf_points, 0, 0, 5 * tf_points, None
    return (spec.tf_points, TF_MODES.index(spec.tf_mode), spec.tf_pre_rows,
            tf_floats_of(spec.tf_mode, tf),
            tf.data_ptr() if spec.tf_mode == "preint2d" else None)


def _launch_fwd(rays: Tensor, weights: Tensor, table: Tensor, spec: MarchSpec,
                n_fourier: int, n_hidden: int, tf_points: int,
                n_seg_max: Optional[int] = None,
                mask: Optional[Tensor] = None, tf: Optional[Tensor] = None):
    """Launch csrc/mega_fwd.cu. With ``n_seg_max`` it also stores the
    incoming carries (a :class:`TfCarries` in the TF modes) and the
    segments visited; ``mask`` is a :func:`_check_mask` occupancy mask or
    None; ``tf`` the TF modes' table (``ops.fused_dvr.prepare_tf``'s).
    Returns (out, samples, carries or None, count or None)."""
    dev = rays.device
    n_tiles = rays.shape[0] // spec.tile
    f32 = table.dtype == torch.float32
    out = torch.empty(rays.shape[0], 4, dtype=torch.float32, device=dev)
    samples = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    carries = count = dens = None
    if n_seg_max is not None:
        carries = torch.empty(n_tiles, n_seg_max, spec.tile, 4,
                              dtype=torch.float32, device=dev)
        count = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        if spec.tf_mode != "piecewise":
            dens = torch.empty(n_tiles, n_seg_max, spec.tile,
                               dtype=torch.float32, device=dev)
    _check_tensors(dev, rays=rays, weights=weights, table=table)
    if tf is not None:
        _check_tensors(dev, tf=tf)
    rows, *tf_args = _tf_args(spec, tf, _knots(spec, tf_points))
    gz, gy, gx = table.shape[:3]
    net_args = _net_args(spec)
    lib = library_name(_fwd_kind(spec, net_args), net_args[0], spec.tile)
    launch = _bind_fwd(_build.load(lib))
    with torch.cuda.device(dev):
        err = launch(
            rays.data_ptr(), table.data_ptr(), int(f32), weights.data_ptr(),
            weights.numel(), out.data_ptr(), samples.data_ptr(),
            carries.data_ptr() if carries is not None else None,
            count.data_ptr() if count is not None else None,
            rays.shape[0], gx, gy, gz, n_fourier, n_hidden, rows,
            *net_args, spec.seg,
            n_seg_max if n_seg_max is not None else 1 << 30,
            spec.stepsize, spec.density_min,
            1.0 / (spec.density_max - spec.density_min), spec.early_alpha,
            *spec.box_min, *spec.box_size, *_mask_args(mask), *tf_args,
            dens.data_ptr() if dens is not None else None, _stream(dev))
    if err != 0:
        raise RuntimeError(f"mega_fwd launch failed with CUDA error {err}")
    LIBRARY_LAUNCHES[lib] += 1
    if dens is not None:
        carries = TfCarries(carries, dens)
    return out, samples, carries, count


def _bind_nrm(lib: ctypes.CDLL):
    fn = lib.mega_fwd_nrm_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p, p, i, p, i, p, i, i, p, p, p] + [i] * 9 + [f, i, i, i]
                   + [f] * 10 + [p, i, p, p, p])
    fn.restype = ctypes.c_int
    return fn


def _launch_nrm(rays: Tensor, net, params: list, spec: MarchSpec,
                table_dtype: torch.dtype, mask: Optional[Tensor] = None):
    """Launch the normals instance of csrc/mega_fwd.cuh (the library
    ``mega_fwd_nrm`` of the padded width): the render with each counting
    sample's position gradient, shading (``spec.brdf``) and the blended
    normal and depth. The scalar network of the gradient reads the
    per-segment engine's packed weights. Returns (RayEvaluationOutput,
    samples per tile)."""
    from ..raytracer.dvr import RayEvaluationOutput
    from .fused_dvr import _latent_chunks, pack_segment_weights, shade_args
    dev = rays.device
    n_tiles = rays.shape[0] // spec.tile
    rgba = torch.empty(rays.shape[0], 4, dtype=torch.float32, device=dev)
    nd = torch.empty(rays.shape[0], 4, dtype=torch.float32, device=dev)
    samples = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    weights = _pack_weights(params, spec)
    nweights = pack_segment_weights(net, params[0])
    table = _kernel_table(params[2], table_dtype, dev)
    _check_tensors(dev, rays=rays, weights=weights, nweights=nweights,
                   table=table)
    n_fourier, n_hidden, tf_points, _ = _widths(params)
    net_args = _net_args(spec)
    gz, gy, gx = table.shape[:3]
    si, sf = shade_args(spec.brdf)
    launch = _bind_nrm(_lib("mega_fwd_nrm", net_args[0], spec.tile))
    with torch.cuda.device(dev):
        err = launch(
            rays.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.float32), weights.data_ptr(),
            weights.numel(), nweights.data_ptr(), nweights.numel(),
            _latent_chunks(net), rgba.data_ptr(), nd.data_ptr(),
            samples.data_ptr(), rays.shape[0], gx, gy, gz, n_fourier,
            n_hidden, tf_points, *net_args, spec.seg, spec.stepsize,
            spec.density_min, 1.0 / (spec.density_max - spec.density_min),
            spec.early_alpha, *spec.box_min, *spec.box_size,
            *_mask_args(mask), si, sf, _stream(dev))
    if err != 0:
        raise RuntimeError(f"mega_fwd_nrm launch failed with CUDA error "
                           f"{err}")
    _count("mega_fwd_nrm", spec.tile, table)
    return RayEvaluationOutput(color=rgba, depth=nd[:, 3:4],
                               normal=nd[:, :3]), samples


def _launch_bwd(rays, weights, table, carries, count, d_out, spec,
                n_fourier, n_hidden, tf_points, n_lat, mask=None,
                partial_rows=False, tf=None, d_tf2d=None,
                ray_grads=False):
    """Launch csrc/mega_bwd.cu on the forward's ``carries`` (a
    :class:`TfCarries` in the TF modes, whose table ``tf`` is) and its
    latent ``table`` (bf16 or float32). Returns (packed weight gradient
    summed over tiles, or with ``partial_rows`` the tiles' rows, float32
    table gradient (D, H, W, 16), (tiles, 2) samples replayed and
    contributing, the rays' (R, 8) cotangent with ``ray_grads`` (the
    ray-gradient instance; columns 6-7 zero) or None). preint2d adds its
    table's gradient into ``d_tf2d`` (zeros like ``tf``)."""
    dev = rays.device
    n_tiles = rays.shape[0] // spec.tile
    d_out = d_out.to(torch.float32).contiguous()
    dens = None
    if isinstance(carries, TfCarries):
        carries, dens = carries
    d_rows = torch.empty(n_tiles, weights.numel(), dtype=torch.float32,
                         device=dev)
    d_table = torch.zeros_like(table, dtype=torch.float32)
    work = torch.empty(n_tiles, 2, dtype=torch.int32, device=dev)
    d_rays = (torch.zeros(rays.shape[0], 8, dtype=torch.float32, device=dev)
              if ray_grads else None)
    if (spec.tf_mode == "preint2d") != (d_tf2d is not None):
        raise ValueError("d_tf2d takes the gradient of a preint2d table")
    _check_tensors(dev, rays=rays, weights=weights, table=table,
                   carries=carries, count=count, d_out=d_out)
    if (table.dtype not in (torch.float32, torch.bfloat16)
            or d_out.shape != (rays.shape[0], 4)):
        raise ValueError("backward: a float32 or bf16 table and an (R, 4) "
                         "cotangent")
    rows, *tf_args = _tf_args(spec, tf, _knots(spec, tf_points))
    gz, gy, gx = table.shape[:3]
    net_args = _net_args(spec)
    launch = _bind_bwd(_lib("mega_bwd", net_args[0], spec.tile))
    with torch.cuda.device(dev):
        err = launch(
            rays.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.float32), weights.data_ptr(),
            weights.numel(), carries.data_ptr(), count.data_ptr(),
            d_out.data_ptr(), d_rows.data_ptr(), d_table.data_ptr(),
            work.data_ptr(), rays.shape[0], gx, gy, gz, n_lat, n_fourier,
            n_hidden, rows, *net_args, spec.seg,
            carries.shape[1],
            spec.stepsize, spec.density_min,
            1.0 / (spec.density_max - spec.density_min), spec.early_alpha,
            *spec.box_min, *spec.box_size, *_mask_args(mask), *tf_args,
            d_tf2d.data_ptr() if d_tf2d is not None else None,
            dens.data_ptr() if dens is not None else None,
            d_rays.data_ptr() if d_rays is not None else None, _stream(dev))
    if err != 0:
        raise RuntimeError(f"mega_bwd launch failed with CUDA error {err}")
    return ((d_rows if partial_rows else d_rows.sum(dim=0)), d_table, work,
            d_rays)


def _widths(params: list) -> tuple[int, int, int, int]:
    """(n_fourier, n_hidden, tf_points, latent channels)."""
    return (params[1].shape[0], len(params[3:]) // 2 - 2, params[0].shape[0],
            0 if params[2] is None else params[2].shape[0])


class _KernelMarch(torch.autograd.Function):
    """The differentiable march on the card: the forward launches
    csrc/mega_fwd.cu storing the carries, the backward csrc/mega_bwd.cu
    (its ray-gradient instance where the rays need a gradient), both on
    the latent table of ``table_dtype``. The table's gradient returns in
    float32 for ``params[2]``: with a bf16 table that is the grid cast to
    bf16 and back, whose backward rounds it once per cell."""

    @staticmethod
    def forward(ctx, rays, spec, mask, table_dtype, *params):
        params = list(params)
        n_fourier, n_hidden, tf_points, n_lat = _widths(params)
        tf = (params[0].detach().contiguous()
              if spec.tf_mode != "piecewise" else None)
        weights = _pack_weights(params, spec)
        table = _kernel_table(params[2], table_dtype, rays.device)
        out, samples, carries, count = _launch_fwd(
            rays, weights, table, spec, n_fourier, n_hidden, tf_points,
            n_seg_max=segments_needed(rays, spec), mask=mask, tf=tf)
        _count("mega_fwd_diff", spec.tile, table)
        ctx.spec = spec
        ctx.mask = mask
        ctx.tf_mode = tf is not None
        if isinstance(carries, TfCarries):
            carries, dens = carries
        else:
            dens = None
        ctx.save_for_backward(rays, weights, table, carries, dens, count, tf,
                              *params)
        ctx.mark_non_differentiable(samples)
        return out, samples

    @staticmethod
    def backward(ctx, d_out, _d_samples):
        rays, weights, table, carries, dens, count, tf, *params = \
            ctx.saved_tensors
        n_fourier, n_hidden, tf_points, n_lat = _widths(params)
        if dens is not None:
            carries = TfCarries(carries, dens)
        d_tf2d = (torch.zeros_like(tf) if ctx.spec.tf_mode == "preint2d"
                  else None)
        dw, d_table, _, d_rays = _launch_bwd(
            rays, weights, table, carries, count, d_out, ctx.spec, n_fourier,
            n_hidden, tf_points, n_lat, ctx.mask, tf=tf, d_tf2d=d_tf2d,
            ray_grads=ctx.needs_input_grad[0])
        _count("mega_bwd", ctx.spec.tile, table, ctx.needs_input_grad[0])
        grads = _unpack_grads(dw, params, ctx.spec, d_tf2d)
        if n_lat:
            grads[2] = d_table[..., :n_lat].permute(3, 0, 1, 2).contiguous()
        return (d_rays, None, None, None, *grads)


def mega_trace_dvr(ray_start: Tensor, ray_dir: Tensor,
                   net: SceneRepresentationNetwork, box_min, box_size,
                   tf_tensor: Tensor, *, stepsize: float,
                   tmax_clip: Optional[Tensor] = None,
                   seg: int = 32, tile: int = KERNEL_TILE,
                   density_min: float = 0.0, density_max: float = 1.0,
                   alpha_early_out: float = EARLY_ALPHA,
                   enable_early_out: bool = True,
                   differentiable: bool = False,
                   table_dtype: Optional[torch.dtype] = None,
                   segment_active: Optional[Tensor] = None,
                   tf_mode: str = "piecewise",
                   tf_pre: Optional[Tensor] = None,
                   need_normals: bool = False, brdf=None,
                   time=0.0, ensemble=0.0, ray_grads: bool = False,
                   return_samples: bool = False):
    """Fused SRN march (see the module doc). CUDA tensors launch the
    kernels, CPU tensors run :func:`mega_trace_dvr_plain`. The render
    (``differentiable=False``) reads a bf16 latent table by default; with
    ``differentiable=True`` the result carries gradients to the network's
    parameters and to ``tf_tensor`` (and ``tf_pre``), from a float32
    table by default or a bf16 one (``table_dtype``, bench.py's training
    step), and with ``ray_grads`` to ``ray_start`` and ``ray_dir`` (else
    the rays are detached: the JAX op gives them a zero cotangent).
    ``tile``: 128 or 256 rays a tile (the vote is per tile, so the tile
    is part of the image). ``tf_mode`` (``ops.fused_dvr.TF_MODES``) and
    ``tf_pre`` choose the TF as in the JAX package
    (``ops.fused_dvr.prepare_tf``).
    ``segment_active``: an (n_tiles, n_seg) bool occupancy mask ANDed into
    every (tile, segment)'s activity, forward and backward: a culled
    segment evaluates no sample and leaves the carry alone, the last
    density too (image error bounded by the occupancy threshold; TF
    gradients of culled samples are dropped, the network's are exact
    where the culled samples are transparent). ``need_normals`` and
    ``brdf`` (a ``brdf.BRDFLambert``) shade as the module doc says.
    ``time``/``ensemble`` condition a network with keyframed grids or
    latent vectors (``ops.fused_dvr.resolve_network``: the grid the
    kernels read is resolved once a call, the vectors fold into layer 0's
    bias; gradients reach both). Returns rgba (R, 4), or
    ``RayEvaluationOutput`` with normals, and the samples evaluated per
    tile with ``return_samples``."""
    from .fused_dvr import resolve_network
    net = resolve_network(net, time, ensemble)
    kw = dict(stepsize=stepsize, tmax_clip=tmax_clip, seg=seg, tile=tile,
              density_min=density_min, density_max=density_max,
              alpha_early_out=alpha_early_out,
              enable_early_out=enable_early_out,
              differentiable=differentiable, table_dtype=table_dtype,
              segment_active=segment_active, tf_mode=tf_mode, tf_pre=tf_pre,
              need_normals=need_normals, brdf=brdf, ray_grads=ray_grads,
              return_samples=return_samples)
    if ray_start.device.type == "cpu":
        return mega_trace_dvr_plain(ray_start, ray_dir, net, box_min,
                                    box_size, tf_tensor, **kw)
    if ray_start.device.type != "cuda":
        raise ValueError(f"unsupported device {ray_start.device}")
    from .fused_dvr import _check_normals_request, prepare_tf
    from .sample_mlp import tf_floats_of
    _check_normals_request(net, differentiable=differentiable,
                           need_normals=need_normals, iso_value=None)
    _check_network(net)
    dev = ray_start.device
    ray_start, ray_dir = _ray_leaves(ray_start, ray_dir, differentiable,
                                     ray_grads)
    rays = ray_packet(ray_start, ray_dir, box_min, box_size, stepsize,
                      tmax_clip)
    tf, tf_points, tf_pre_rows = prepare_tf(tf_tensor, tf_mode, tf_pre, dev)
    tf_floats = tf_floats_of(tf_mode, tf)
    _check_kernel_inputs(net, rays, tile, seg, differentiable, tf_floats,
                         tf_mode, need_normals,
                         masked=segment_active is not None)
    if (net.output_mode.startswith("density")
            and tf_mode in ("piecewise", "gaussian")
            and tf_points > MAX_TF_POINTS):
        raise NotImplementedError(f"CUDA kernel: at most {MAX_TF_POINTS} "
                                  f"{tf_mode} TF points")
    spec = _spec(net, box_min, box_size, stepsize=stepsize, seg=seg,
                 tile=tile, density_min=density_min,
                 density_max=density_max, enable_early_out=enable_early_out,
                 alpha_early_out=alpha_early_out, tf_mode=tf_mode,
                 tf_points=tf_points, tf_pre_rows=tf_pre_rows,
                 need_normals=need_normals, brdf=brdf)
    params = _params(net, tf)
    mask = _check_mask(segment_active, rays.shape[0] // tile, dev)
    table_dtype = _table_dtype(table_dtype, differentiable)
    if need_normals:
        with torch.no_grad():
            out, samples = _launch_nrm(rays, net, params, spec, table_dtype,
                                       mask)
    elif differentiable:
        if params[2] is not None and table_dtype != torch.float32:
            # the table's gradient goes back through the storage cast,
            # whose backward rounds it once per cell (the JAX op's
            # slab_dtype output)
            params[2] = params[2].to(table_dtype).to(torch.float32)
        out, samples = _KernelMarch.apply(rays, spec, mask, table_dtype,
                                          *params)
    else:
        with torch.no_grad():
            n_fourier, n_hidden, tf_points, _ = _widths(params)
            table = _kernel_table(params[2], table_dtype, dev)
            out, samples, _, _ = _launch_fwd(
                rays, _pack_weights(params, spec), table, spec, n_fourier,
                n_hidden, tf_points, mask=mask,
                tf=tf.detach().contiguous() if spec.tf_mode != "piecewise"
                else None)
        _count("mega_fwd", spec.tile, table)
    return (out, samples) if return_samples else out
