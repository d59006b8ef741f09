"""The per-segment fused march and the host-side planning of the fused
render.

Counterpart of ``fvsrn_tpu/ops/fused_dvr.py``:

- ``fused_trace_dvr`` is the per-segment engine (the TPU kernel
  ``_segment_kernel``): CUDA tensors launch ``csrc/segment_fwd.cu``, CPU
  tensors run ``fused_trace_dvr_plain``; on a CUDA tensor it never falls
  back to the plain version. With ``differentiable=True`` it applies the
  autograd Functions of ``ops.fused_dvr_bwd`` (the TPU's
  ``make_segment_op``: the forward storing carries, the backward
  ``csrc/segment_bwd.cu``);
- ``fused_trace_iso`` is the isosurface render on that engine: the
  kernel's first-hit epilogue, then per-ray bisection and shading in plain
  PyTorch (``raytracer.iso.refine_and_shade``), as in the JAX package;
- ``plan_ray_buckets`` / ``fused_trace_dvr_bucketed`` run the engine once
  per march-length bucket of ray tiles, the route of latent grids that
  fail ``mega_supported``;
- ``block_ray_permutation`` regroups row-major rays into pixel blocks so
  that each ray tile is spatially coherent;
- ``probe_saturation_tmax`` is the camera-static saturation probe: a
  coarse alpha-only march of the same network and TF that clamps each
  ray's march where it saturates. It is plain PyTorch on the device, as
  it is plain JAX (no Pallas kernel) in the JAX package.

What ``fused_trace_dvr`` computes (the semantics of the TPU engine, not
its layout). Segments of ``seg`` samples, per-ray sampling t = tmin + k*h,
or with ``latent_mode="boxfeat"`` and a grid of <= 16 channels the global
lattice t = k*h from the ray tile's base k0t (the minimum of
ceil(tmin/h) over the ``tile`` rays; a sample counts from the ray's own
k0 on). The stop is global to the call: segment s runs for every ray
while some ray of the call is alive at s (segment start <= tmax, alpha <
``alpha_early_out`` on entry), at most ``n_seg`` segments; so a saturated
ray keeps compositing until the call's last live ray is done. Latent
features: a grid of <= 16 channels is read rounded to ``table_dtype``
(the JAX package's neighborhood table), a wider one in float32. Each
valid sample: the network (every activation, the five output heads,
direction input), then the TF (density heads; a sample counts when its
value >= density_min) or the head's own rgb with absorption o*h (rgbo
heads), Beer-Lambert or alpha "over". The TF is ``tf_mode``'s
(:data:`TF_MODES`, :func:`prepare_tf`, :func:`tf_shade`): piecewise,
texture, the 1D and 2D preintegrations, which read each sample's
previous density (carried across segments), or Gaussians. With
``iso_value`` the march records the first sample whose density exceeds
it: rgba = (depth, 0, 0, found), and a hit ray is dead. The
differentiable march has no early-out (every segment runs; the JAX
package's fixed-count scan) and reads a float32 or a bf16 table
(``table_dtype``; its gradient summed in float32 and rounded once per
cell); normals and shading under ``differentiable=True`` raise
``NotImplementedError``. With ``need_normals`` (density heads) each valid
sample also gets the network's world-space position gradient (the
adjoint sweep of the JAX package's ``_mlp_position_grad_T``), its
normalised normal (zero where |g|^2 <= 1e-12), and with a ``brdf``
gradient-magnitude opacity scaling and Blinn-Phong shading
(:func:`shade_samples`); the normal and the depth t blend with the
colour's weights, and the call returns ``RayEvaluationOutput(color,
depth, normal)``.

Bound of the kernel on the H100: operations (the dense flagship's sample
costs ~7.6 kFLOP and ~110 transcendentals against 32 bytes per ray). A
warp owns 32 rays and evaluates their valid samples as tiles of 32 rows,
every layer a TF32 three-pass tensor-core product (float32-accurate;
``csrc/warp_mlp.cuh``), composited in order by a segmented scan.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.activations import apply_activation
from ..models.latent import grid_sample_3d, interp1d, resolve_grid
from ..models.srn import SceneRepresentationNetwork
from ..raytracer.dvr import RayEvaluationOutput
from ..utils.device import as_f32, constant, strict_f32
from ..utils.vecmath import intersect_aabb
from . import _build
from .fused_mega import (_ACTIVATIONS, _HEADS, SMEM_MAX_WIDTH, TfCarries,
                         _gated_clip01, _params, _tf_args,
                         check_kernel_width, kernel_width)

# kernel launches since the last reset (two a call: the march and its
# continuation up to the call's stop), the normals instances' apart; the
# plain version never counts
SEGMENT_LAUNCHES = 0
SEGMENT_NRM_LAUNCHES = 0
# the forward's launches by library (segment_library; the normals
# instances' width_library), the render's and the training forward's,
# reset with the counts above
LIBRARY_LAUNCHES: collections.Counter = collections.Counter()

# the JAX megakernel's VMEM budget for its latent slab: the route rule of
# the fused render (a grid over it takes the bucketed per-segment engine)
SLAB_VMEM_LIMIT = 6 * 2 ** 20
MAX_LATENT_CHANNELS = 64
MAX_FOURIER = 32                 # the kernel's limits (segment_fwd.cu)
MAX_HIDDEN_LAYERS = 6
MAX_BWD_SEG = 32                 # segment_bwd.cu's segment length limit
_PLAIN_CHUNK_SAMPLES = 1 << 21
_FAR = 3.0e38
# the TF modes of the fused marches (the JAX package's tf_mode), in the
# order of the kernels' TF template parameter (csrc/march_common.cuh)
TF_MODES = ("piecewise", "texture", "preint1d", "preint2d", "gaussian")


def mega_supported(grid_shape, table_dtype=torch.float32) -> bool:
    """Whether a (C, D, H, W) latent grid fits the JAX megakernel's
    VMEM-resident slab (worst-case y padding assumed): the JAX formula,
    kept as the port's route rule, since the route decides the image."""
    if grid_shape is None:
        return True
    c, d, h, w = grid_shape
    if c > 16:
        return False
    nxb_tot = (w + 2 + 7) // 8
    yp = -(-(h + 2) // 8) * 8 + 24
    itemsize = torch.empty(0, dtype=table_dtype).element_size()
    return (d + 2) * yp * nxb_tot * 128 * itemsize <= SLAB_VMEM_LIMIT


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
    prev = torch.full(lead, -1.0, dtype=dtype, device=ray_start.device)
    for i in range(n_steps):
        t = (k0 + float(i)) * hc
        pos = ray_start + ray_dir * t
        value, _ = volume.eval_density(pos, ray_dir)
        value = value[..., None]
        d2 = (value - density_min) / (density_max - density_min)
        require = (t <= tmax) & (value >= density_min)
        # the previous coarse sample's density, as the JAX probe carries
        # it (the preintegrating TFs read it), and zero normals
        rgba = tf.eval_normalized(torch.clamp(d2[..., 0], 0.0, 1.0),
                                  torch.zeros_like(pos), prev, hc)
        prev = d2[..., 0]
        absn = torch.where(require, rgba[..., 3:4], torch.zeros_like(t))
        ca = (1.0 - torch.exp(-absn) if blend_beer
              else torch.clamp(absn, max=1.0))
        alpha = alpha + (1.0 - alpha) * ca
        tsat = torch.where((alpha >= alpha_threshold) & ~torch.isfinite(tsat),
                           t, tsat)
    clip = torch.where(torch.isfinite(tsat), tsat + margin_steps * h, tmax)
    return torch.minimum(tmax, clip)[..., 0]


# ---------------------------------------------------------------------------
# planning of the bucketed route


def _slab_exit(rs: np.ndarray, rd: np.ndarray, box_min, box_size):
    """(tmin >= 0, tmax) of the planner's slab test (zero direction
    components replaced by 1e-12), numpy float32."""
    bmin = np.asarray(box_min, np.float32)
    bsize = np.asarray(box_size, np.float32)
    inv = 1.0 / np.where(rd == 0, 1e-12, rd)
    t0 = (bmin - rs) * inv
    t1 = (bmin + bsize - rs) * inv
    tmin = np.maximum(np.minimum(t0, t1).max(axis=1), 0.0)
    return tmin, np.maximum(t0, t1).min(axis=1)


def certify_segments(ray_start, ray_dir, box_min, box_size, *,
                     stepsize: float, seg: int, tile: int,
                     tmax_clip=None) -> int:
    """The lattice march's segment count for a concrete ray set: the
    longest tile's span from its base k0t (every ray counts) to its last
    lattice point, over ``seg`` (the n_seg of the JAX package's
    ``certify_boxfeat``; its footprint sizes serve a TPU gather and have
    no counterpart here)."""
    rs = np.asarray(ray_start, np.float32)
    rd = np.asarray(ray_dir, np.float32)
    h = np.float32(stepsize)
    tmin, tmax = _slab_exit(rs, rd, box_min, box_size)
    tmin = tmin.astype(np.float32)
    tmax = tmax.astype(np.float32)
    if tmax_clip is not None:
        tmax = np.minimum(tmax, np.asarray(tmax_clip, np.float32))
    n_tiles = rs.shape[0] // tile
    k0t = np.ceil(tmin / h).reshape(n_tiles, tile).min(axis=1)
    span = np.floor(tmax / h).reshape(n_tiles, tile).max(axis=1) - k0t + 1
    return max(1, int(np.ceil(max(float(span.max()), 1.0) / seg)))


class RayBucketPlan(NamedTuple):
    """Static plan of march-length tile buckets (see
    :func:`plan_ray_buckets`)."""
    perm: np.ndarray          # (R,) tile-granular ray permutation
    inv: np.ndarray           # its inverse
    group_sizes: tuple        # rays per live group (multiples of tile)
    group_steps: tuple        # max_steps per group
    group_segments: tuple     # the engine's segment count per group
    dead: int                 # leading rays whose tiles never hit the box
    tmax_clip: Optional[np.ndarray] = None  # (R,) permuted per-ray clip


def plan_ray_buckets(ray_start, ray_dir, box_min, box_size, *,
                     stepsize: float, seg: int, tile: int,
                     n_buckets: int = 4, grid_sizes=None,
                     quantize: int = 0, tmax_clip=None) -> RayBucketPlan:
    """Sort ray tiles by their lattice span and cut them into
    ``n_buckets`` contiguous groups, each marched by its own call of the
    engine (its own global stop and segment count). Host-side numpy, as
    in the JAX package; tile contents are not reordered. ``quantize`` > 0
    makes the plan's shape camera-stable: equal splits of all tiles
    (none sliced off as dead) and step counts rounded up to its
    multiples. ``grid_sizes`` (x, y, z) marks a lattice (boxfeat) plan,
    whose segment counts are certified per group."""
    rs = np.asarray(ray_start, np.float32)
    rd = np.asarray(ray_dir, np.float32)
    h = np.float32(stepsize)
    n_tiles = rs.shape[0] // tile
    tmin, tmax = _slab_exit(rs, rd, box_min, box_size)
    if tmax_clip is not None:
        tmax = np.minimum(tmax, np.asarray(tmax_clip, np.float32))
    k0 = np.ceil(tmin / h)
    k1 = np.floor(tmax / h)
    alive = (tmax > tmin) & (k1 >= k0)
    k0t = np.where(alive, k0, np.inf).reshape(n_tiles, tile).min(axis=1)
    k1t = np.where(alive, k1, -np.inf).reshape(n_tiles, tile).max(axis=1)
    span_t = np.maximum(np.where(np.isfinite(k0t), k1t - k0t + 1, 0.0), 0.0)
    order_t = np.argsort(span_t, kind="stable")
    perm = (order_t[:, None] * tile + np.arange(tile)).ravel()
    inv_p = np.argsort(perm)
    spans_sorted = span_t[order_t]
    n_dead = 0 if quantize else int(np.sum(spans_sorted <= 0))
    clip_p = (np.asarray(tmax_clip, np.float32)[perm]
              if tmax_clip is not None else None)
    sizes, steps, segments = [], [], []
    if n_tiles - n_dead > 0:
        edges = np.linspace(n_dead, n_tiles, n_buckets + 1).astype(int)
        rs_p, rd_p = rs[perm], rd[perm]
        for a, b in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            g_steps = max(int(spans_sorted[a:b].max()), 1)
            if quantize:
                g_steps = -(-g_steps // quantize) * quantize
            sizes.append((b - a) * tile)
            steps.append(g_steps)
            n_seg = certify_segments(
                rs_p[a * tile:b * tile], rd_p[a * tile:b * tile], box_min,
                box_size, stepsize=stepsize, seg=seg, tile=tile,
                tmax_clip=(clip_p[a * tile:b * tile]
                           if clip_p is not None else None))
            if quantize and grid_sizes is not None:
                n_seg = max(n_seg, -(-g_steps // seg))
            segments.append(n_seg)
    return RayBucketPlan(perm=perm, inv=inv_p, group_sizes=tuple(sizes),
                         group_steps=tuple(steps),
                         group_segments=tuple(segments), dead=n_dead * tile,
                         tmax_clip=clip_p)


# ---------------------------------------------------------------------------
# the static-grid view of a time- or ensemble-conditioned network


class StaticLatent(NamedTuple):
    """The latent space of a :class:`NetworkView`: one static grid."""
    static_grid: Optional[Tensor]


class NetworkView(NamedTuple):
    """What the fused marches read of an SRN (``input``, ``layers``,
    ``latent.static_grid``, ``output_mode``, ``use_direction``), with the
    latent conditioning of one (time, ensemble) folded in: see
    :func:`resolve_network`. Its tensors are plain tensors in autograd's
    graph, so gradients reach the network's parameters through them."""
    input: object
    layers: list
    latent: StaticLatent
    output_mode: str
    use_direction: bool


class _FoldedLayer(NamedTuple):
    """Layer 0 of a :class:`NetworkView` with latent vectors folded in."""
    weight: Tensor
    bias: Tensor
    activation: str
    activation_param: float


def _scalar_at(t, like: Tensor) -> Tensor:
    """A scalar conditioning value as a (1, 1) float32 tensor on ``like``'s
    device (a number is filled in place, with no host-to-device copy)."""
    if isinstance(t, Tensor):
        return t.reshape(1, 1).to(device=like.device, dtype=torch.float32)
    return torch.full((1, 1), float(np.float32(t)), dtype=torch.float32,
                      device=like.device)


def require_srn(net, where: str = "fused march") -> None:
    """Raise ``NotImplementedError`` naming the network's class unless
    ``net`` is a ``SceneRepresentationNetwork`` (or a view of one): the
    fused kernels take the SRN's layout only; the variant and meta
    networks (``models/variants.py``, ``models/meta.py``) render and
    train through the plain marches."""
    if not isinstance(net, (SceneRepresentationNetwork, NetworkView)):
        raise NotImplementedError(
            f"{where}: {type(net).__name__} renders and trains through the "
            "plain march only (trace_dvr, PLAIN32; --no_fused)")


def resolve_network(net, time=0.0, ensemble=0.0):
    """The network at scalar (time, ensemble) as the fused marches take
    it, the JAX package's ``extract_weights`` fold plus ``resolve_grid``:
    latent vectors (a space that is not time-dependent) interpolated at
    (time, ensemble) and folded into layer 0's bias, b1 + W_vec z, their
    columns cut from its weight; keyframed grids lerped into one static
    grid (time grid channels, then ensemble grid channels). Both are
    exact: the layer is affine and the trilerp linear in the grid's
    values. A network with neither (and a view) is returned as it is.
    Time Fourier features and direct time input raise ``AssertionError``,
    as in the JAX package. A network that is not an SRN raises
    ``NotImplementedError`` (:func:`require_srn`)."""
    if isinstance(net, NetworkView):
        return net
    require_srn(net)
    assert net.input.fourier_matrix_time is None, \
        "fused: no time fourier (use keyframed latent grids)"
    assert not net.input.use_time_direct, "fused: no direct time input"
    lat = net.latent
    vectors = [] if lat.time_dependent else [
        (v, at) for v, at in ((lat.ensemble_vector, ensemble),
                              (lat.time_vector, time)) if v is not None]
    if not lat.time_dependent and not vectors:
        return net
    layers = list(net.layers)
    if vectors:
        w1, b1 = net.layers[0].weight, net.layers[0].bias
        z = torch.cat([interp1d(v, _scalar_at(at, v))[0, :, 0]
                       for v, at in vectors])
        start = net.input.num_input_channels() + 2 * net.input.num_fourier
        stop = start + z.shape[0]
        layers[0] = _FoldedLayer(
            torch.cat([w1[:, :start], w1[:, stop:]], dim=1),
            b1 + w1[:, start:stop] @ z, net.layers[0].activation,
            net.layers[0].activation_param)
    return NetworkView(net.input, layers,
                       StaticLatent(resolve_grid(lat, time, ensemble)),
                       net.output_mode, net.use_direction)


# ---------------------------------------------------------------------------
# the per-segment engine


class SegmentSpec(NamedTuple):
    """What one call of the engine needs besides its tensors."""
    stepsize: float             # rounded to float32
    seg: int
    n_seg: int
    lattice: bool
    density_min: float
    density_max: float
    early_alpha: float          # 2.0 disables the early-out
    blend_alpha: bool           # "alpha" blending, else Beer-Lambert
    iso_value: Optional[float]
    box_min: tuple
    box_size: tuple
    activation: tuple           # (name, param) of every hidden layer
    output_mode: str
    direction: bool             # the ray direction is a network input
    tf_mode: str = "piecewise"
    tf_points: int = 0          # prepare_tf's tf_points, tf_pre_rows
    tf_pre_rows: int = 0
    normals: bool = False       # need_normals: the blended normal, depth
    brdf: tuple = ()            # brdf_tuple's shading parameters


class SegmentStats(NamedTuple):
    """Of one call: samples evaluated (valid samples; for iso, up to the
    hit) and the stop S, the number of segments the call ran. Tensors, so
    reading them does not stall the card until asked."""
    samples: Tensor
    stop: Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


def tf_mode_of(tf) -> str:
    """The fused march's name for the kind of ``tf``, as the JAX package
    routes it: "piecewise", "texture", "preint1d" and "preint2d" for the
    texture TF by its preintegration, else the TF's kind in lower case."""
    name = type(tf).__name__
    if name == "TransferFunctionTexture":
        return ("texture", "preint1d", "preint2d")[tf.preintegration_mode]
    if name == "TransferFunctionPiecewiseLinear":
        return "piecewise"
    return name.replace("TransferFunction", "").lower()


def fused_tf_args(tf):
    """(tensor, kwargs) of ``tf`` for the fused marches: its tensor, and
    the ``tf_mode`` and ``tf_pre`` that the JAX package's screen trainer
    derives from the TF (``_tf_mode_kwargs``): the texture TF by its
    preintegration, the Gaussians, else piecewise (no kwargs)."""
    mode = tf_mode_of(tf)
    if mode in ("preint1d", "preint2d"):
        return tf.tensor, dict(tf_mode=mode, tf_pre=tf.preintegrated)
    if mode in ("texture", "gaussian"):
        return tf.tensor, dict(tf_mode=mode)
    return tf.tensor, {}


def brdf_tuple(brdf, need_normals: bool) -> tuple:
    """The shading parameters the fused marches take from a
    ``brdf.BRDFLambert`` (the JAX package's ``_brdf_tuple``): () when
    there is none or it shades nothing, else (magnitude scaling on, Phong
    on, magnitude_scaling, ambient, specular, magnitude_center,
    magnitude_radius, directional light, light x, y, z, specular
    exponent). A shading BRDF without normals raises ``ValueError``."""
    if brdf is None or not (brdf.enable_phong
                            or brdf.enable_magnitude_scaling):
        return ()
    if not need_normals:
        raise ValueError("brdf shading requires need_normals=True")
    lp = [float(np.float32(v)) for v in brdf.light]
    return (bool(brdf.enable_magnitude_scaling), bool(brdf.enable_phong),
            _f32(brdf.magnitude_scaling), _f32(brdf.ambient),
            _f32(brdf.specular), _f32(brdf.magnitude_center),
            _f32(brdf.magnitude_radius), brdf.light_type == "direction",
            lp[0], lp[1], lp[2], int(brdf.specular_exponent))


def shade_args(brdf: tuple):
    """The kernels' shading arguments of :func:`brdf_tuple`'s ``brdf``
    (csrc/march_common.cuh ``make_shade``): int [magnitude scaling on,
    Phong on, directional light, specular exponent] and float [magnitude
    scaling, ambient, specular, smoothstep edge center - radius, width 2
    radius, lobe normalisation (e + 2) 0.159155, the light's unit direction
    -l/|l| or its position], folded in double precision as the JAX
    package folds them; ctypes arrays. No BRDF shades nothing."""
    si, sf = [0, 0, 1, 0], [0.0] * 9
    if brdf:
        (en_ms, en_phong, m_scale, ambient, specular, m_center, m_radius,
         directional, lx, ly, lz, e) = brdf
        light = (lx, ly, lz)
        if directional:
            ln = math.sqrt(lx * lx + ly * ly + lz * lz)
            light = (-lx / ln, -ly / ln, -lz / ln)
        si = [int(en_ms), int(en_phong), int(directional), int(e)]
        sf = [m_scale, ambient, specular, m_center - m_radius,
              2.0 * m_radius, (e + 2) * 0.159155, *light]
    return (ctypes.c_int * 4)(*si), (ctypes.c_float * 9)(*sf)


def _check_normals_request(net, *, differentiable, need_normals, iso_value):
    """The JAX package's refusals of normals, with its exception types."""
    rgbo = not net.output_mode.startswith("density")
    if iso_value is not None and (differentiable or need_normals or rgbo):
        raise ValueError("fused iso marching: forward-only density networks "
                         "(shading happens outside the kernel)")
    if differentiable and need_normals:
        raise NotImplementedError("differentiable fused path: no normals or "
                                  "shading")
    if need_normals and rgbo:
        raise ValueError("normals are only defined for density networks")


def _check_segment_request(net, *, differentiable, need_normals,
                           iso_value, table_dtype):
    _check_normals_request(net, differentiable=differentiable,
                           need_normals=need_normals, iso_value=iso_value)
    if table_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported latent table dtype {table_dtype}")
    if len(net.layers) < 2:
        raise ValueError("fused_trace_dvr: the network needs a hidden layer")


def _segment_rays(ray_start, ray_dir, box_min, box_size, h, tile, lattice,
                  tmax_clip):
    """(rays (R, 8) [start, dir, a, tmax], kbase (R,) or None): a = tmin
    (per-ray sampling) or k0_ray = ceil(tmin/h) (lattice), kbase the
    lattice base of the ray's tile (NaN-propagating minimum, as the JAX
    package takes it)."""
    rs = ray_start.reshape(-1, 3).to(torch.float32)
    rd = ray_dir.reshape(-1, 3).to(torch.float32)
    dev = rs.device
    tmin, tmax = intersect_aabb(rs, rd, as_f32(box_min, dev),
                                as_f32(box_size, dev))
    tmin = torch.clamp(tmin, min=0.0)
    if tmax_clip is not None:
        tmax = torch.minimum(tmax, tmax_clip.reshape(tmax.shape).to(
            device=dev, dtype=torch.float32))
    kbase = None
    a = tmin
    if lattice:
        a = torch.ceil(tmin / h)
        kbase = a.reshape(-1, tile).amin(dim=1).repeat_interleave(tile)
        kbase = kbase.contiguous()
    return torch.cat([rs, rd, a, tmax], dim=1).contiguous(), kbase


def _segment_setup(ray_start, ray_dir, net, box_min, box_size, *, stepsize,
                   max_steps, density_min, density_max, blend_mode,
                   alpha_early_out, enable_early_out, seg, tile,
                   differentiable, latent_mode, table_dtype, n_seg,
                   need_normals, iso_value, tf_mode, tmax_clip,
                   tf_points=0, tf_pre_rows=0, brdf=None):
    """(spec, rays, kbase): the checks and the ray packet of a call. The
    differentiable march has no early-out (the JAX package's rule,
    fvsrn_tpu/ops/fused_dvr.py:2466-2473: its fixed-count scan composites
    every sample, so its backward must not gate on alpha)."""
    _check_segment_request(net, differentiable=differentiable,
                           need_normals=need_normals, iso_value=iso_value,
                           table_dtype=table_dtype)
    if blend_mode not in ("beer_lambert", "alpha"):
        raise ValueError(f"unknown blend mode {blend_mode}")
    if ray_start.reshape(-1, 3).shape[0] % tile:
        raise ValueError(f"ray count {ray_start.reshape(-1, 3).shape[0]} "
                         f"must be a multiple of tile={tile} (pad the rays)")
    grid = net.latent.static_grid
    lattice = (latent_mode == "boxfeat" and grid is not None
               and grid.shape[0] <= 16)
    h = _f32(stepsize)
    rays, kbase = _segment_rays(ray_start.detach(), ray_dir.detach(),
                                box_min, box_size, h, tile, lattice,
                                tmax_clip)
    if n_seg is None:
        if lattice:
            n_seg = certify_segments(
                ray_start.reshape(-1, 3).detach().cpu().numpy(),
                ray_dir.reshape(-1, 3).detach().cpu().numpy(), box_min,
                box_size, stepsize=stepsize, seg=seg, tile=tile,
                tmax_clip=(tmax_clip.detach().cpu().numpy()
                           if tmax_clip is not None else None))
        else:
            n_seg = (int(max_steps) + seg - 1) // seg
    spec = SegmentSpec(
        stepsize=h, seg=int(seg), n_seg=int(n_seg), lattice=lattice,
        density_min=float(density_min), density_max=float(density_max),
        early_alpha=(float(alpha_early_out)
                     if enable_early_out and not differentiable else 2.0),
        blend_alpha=blend_mode == "alpha",
        iso_value=None if iso_value is None else _f32(iso_value),
        box_min=tuple(float(v) for v in box_min),
        box_size=tuple(float(v) for v in box_size),
        activation=(net.layers[0].activation,
                    net.layers[0].activation_param),
        output_mode=net.output_mode, direction=net.use_direction,
        tf_mode=tf_mode, tf_points=int(tf_points),
        tf_pre_rows=int(tf_pre_rows), normals=bool(need_normals),
        brdf=brdf_tuple(brdf, need_normals))
    return spec, rays, kbase


def segment_params(net, tf: Tensor, table_dtype=torch.float32) -> list:
    """The engine's inputs as the autograd Functions take them: the TF,
    the Fourier matrix ((0, 3) when there is none), the latent grid (or
    None), then every layer's weight and bias. A grid of <= 16 channels is
    read rounded to ``table_dtype`` (the JAX package's neighborhood
    table), a wider one in float32; the grid's gradient goes back through
    that cast, whose backward rounds it once per cell (the JAX op's
    ``table_dtype`` cotangent)."""
    params = _params(net, tf)
    grid = params[2]
    if (grid is not None and grid.shape[0] <= 16
            and table_dtype != torch.float32):
        params[2] = grid.to(table_dtype).to(torch.float32)
    return params


def _gated_relu(x: Tensor) -> Tensor:
    """max(x, 0) whose gradient passes only where x > 0."""
    return torch.where(x > 0.0, x, torch.zeros_like(x))


def _head(mode: str, y: Tensor) -> Tensor:
    """The output head on the last layer's pre-activation, its clips
    gated strictly (a gradient passes only strictly inside), as the TPU
    kernel's adjoint gates them."""
    if mode == "density":
        return torch.sigmoid(y)
    if mode == "density:direct":
        return _gated_clip01(y)
    rgb, o = y[..., :3], y[..., 3:]
    if mode == "rgbo":
        return torch.cat([torch.sigmoid(rgb), F.softplus(o)], dim=-1)
    if mode == "rgbo:direct":
        return torch.cat([_gated_clip01(rgb), _gated_relu(o)], dim=-1)
    if mode == "rgbo:exp":
        return torch.cat([torch.sigmoid(rgb), torch.exp(o)], dim=-1)
    raise ValueError(f"unknown output mode {mode}")


def _network_values(params: list, x01: Tensor, dirs: Tensor, *,
                    direction: bool, activation: tuple,
                    output_mode: str) -> Tensor:
    """The engine's network on samples (N, 3) (``params`` as
    :func:`segment_params` gives them): layer 0's ``activation`` (name,
    param) on every hidden layer and a linear output row, as the TPU
    kernels evaluate it, then the output head. (N, 1) or (N, 4)."""
    fourier, grid = params[1], params[2]
    layers = params[3:]
    feats = [x01]
    if direction:
        feats.append(dirs)
    if fourier.shape[0]:
        xin = x01 if fourier.shape[1] == 3 else torch.cat([x01, dirs], 1)
        f = xin @ fourier.T
        feats += [torch.cos(f), torch.sin(f)]
    if grid is not None:
        feats.append(grid_sample_3d(grid, x01))
    y = torch.cat(feats, dim=1)
    name, p = activation
    for i in range(len(layers) // 2 - 1):
        y = y @ layers[2 * i].T + layers[2 * i + 1]
        y = _gated_relu(y) if name == "ReLU" else apply_activation(name, y, p)
    y = y @ layers[-2].T + layers[-1]
    return _head(output_mode, y)


def network_position_grad(params: list, x01: Tensor, dirs: Tensor, **net):
    """(value (N,), d value / d x01 (N, 3)) of :func:`_network_values`'s
    density head at samples ``x01`` (N, 3): autograd through the plain
    network with its strict gates (a clipped density, a ReLU at its kink
    pass no gradient), the function the kernels' adjoint sweep computes
    (csrc/position_grad.cuh). ``net``: _network_values' keywords."""
    with torch.enable_grad():
        x = x01.detach().requires_grad_(True)
        value = _network_values([p.detach() if p is not None else None
                                 for p in params], x, dirs, **net)[:, 0]
        (grad,) = torch.autograd.grad(value.sum(), x)
    return value.detach(), grad


def shade_samples(brdf: tuple, rgb: Tensor, absn: Tensor, grad: Tensor,
                  pos: Tensor, ray_dir: Tensor):
    """(rgb, absorption, normal) of samples of TF colour ``rgb`` (..., 3)
    and absorption ``absn`` (...) whose world-space density gradient is
    ``grad`` (..., 3), at world positions ``pos`` along ``ray_dir`` (both
    broadcasting to grad's shape): the JAX package's fused epilogue
    (fvsrn_tpu/ops/fused_dvr.py:1997-2051), which the kernels repeat
    (csrc/march_common.cuh ``shade_sample``). The normal is g/|g|, zero
    where |g|^2 <= 1e-12; with a ``brdf`` (:func:`brdf_tuple`) the
    absorption is scaled by 1 - exp(-m |g|^2) and the colour shaded by a
    Lambert term |n.l| and a Blinn-Phong lobe (the integer exponent by
    squaring, normalised by (e + 2) 0.159155), mixed by the ambient
    strength's smoothstep of |g|."""
    gns = (grad * grad).sum(dim=-1)
    inv = torch.rsqrt(torch.clamp(gns, min=1e-20))
    nrm = torch.where((gns > 1e-12)[..., None], grad * inv[..., None],
                      torch.zeros_like(grad))
    if not brdf:
        return rgb, absn, nrm
    (en_ms, en_phong, m_scale, ambient, specular, m_center, m_radius,
     directional, lx, ly, lz, e) = brdf
    if en_ms:
        absn = absn * (1.0 - torch.exp(-m_scale * gns))
    if en_phong:
        if directional:
            ln = math.sqrt(lx * lx + ly * ly + lz * lz)
            ld = torch.tensor([-lx / ln, -ly / ln, -lz / ln],
                              dtype=grad.dtype, device=grad.device)
        else:
            lv = torch.tensor([lx, ly, lz], dtype=grad.dtype,
                              device=grad.device) - pos
            ld = lv * torch.rsqrt(torch.clamp((lv * lv).sum(-1), min=1e-20)
                                  )[..., None]
        gn = torch.sqrt(torch.clamp(gns, min=1e-20))
        t01 = torch.clamp((gn - (m_center - m_radius)) / (2.0 * m_radius),
                          0.0, 1.0)
        amb = 1.0 + (ambient - 1.0) * (t01 * t01 * (3.0 - 2.0 * t01))
        ndotl = (nrm * ld).sum(-1)
        refl = ld - 2.0 * ndotl[..., None] * nrm
        base = torch.clamp((ray_dir * refl).sum(-1), min=0.0)
        spec, k = torch.ones_like(base), e
        while k:                        # the integer power by squaring
            if k & 1:
                spec = spec * base
            base = base * base
            k >>= 1
        spec = ((e + 2) * 0.159155) * spec
        rgb = (amb[..., None] * rgb + (1.0 - amb)[..., None]
               * (torch.abs(ndotl)[..., None] * rgb
                  + specular * spec[..., None]))
    return rgb, absn, nrm


def _piecewise(tf: Tensor, d: Tensor) -> Tensor:
    """rgba of the piecewise-linear TF (R, 5) at d in [0, 1]: the interval
    is the number of interior knots <= d; the knot positions get a
    gradient only strictly inside the interval. A select over the
    intervals, as the TPU kernel writes it, so that the TF's gradient is
    a reduction over the samples (a gather's backward adds them one by
    one into a few rows, and that float32 sum drifts with the sample
    count)."""
    iv = torch.zeros_like(d, dtype=torch.int64)
    for q in range(1, tf.shape[0] - 1):
        iv += (tf[q, 4] <= d).to(torch.int64)
    rgba = d.new_zeros(d.shape + (4,))
    for k in range(tf.shape[0] - 1):
        p0, p1 = tf[k, 4], tf[k + 1, 4]
        interior = (d > p0) & (d < p1)
        width = torch.where(p1 > p0, p1 - p0, torch.ones_like(p1))
        frac = torch.where(interior, (d - p0) / width, (d >= p1).to(d.dtype))
        v = tf[k, :4] + frac[..., None] * (tf[k + 1, :4] - tf[k, :4])
        rgba = torch.where((iv == k)[..., None], v, rgba)
    return rgba


# ---------------------------------------------------------------------------
# the TF modes


def prepare_tf(tf_tensor: Tensor, tf_mode: str = "piecewise",
               tf_pre: Optional[Tensor] = None, device=None):
    """(table, tf_points, tf_pre_rows): the TF tensor the fused marches
    read in ``tf_mode``, the contract of the JAX package's ``_prepare_tf``
    (its TPU layout aside): piecewise (R, 5) control points; texture (R, 4)
    rgba texels; gaussian (G, 6); preint1d the plain table (R, 4) with
    the cumulative table ``tf_pre`` (Rp, 4) stacked below it; preint2d the
    (R2, R2, 4) table ``tf_pre`` of (front, back) density pairs as
    (R2 * R2, 4) rows (the plain table unused), tf_points = tf_pre_rows =
    R2. Differentiable in ``tf_tensor`` and ``tf_pre``."""
    def f32(t):
        return t.to(device=device if device is not None else t.device,
                    dtype=torch.float32)

    t = f32(tf_tensor)
    cols = {"piecewise": 5, "texture": 4, "preint1d": 4, "preint2d": 4,
            "gaussian": 6}
    if tf_mode not in cols:
        raise ValueError(f"unknown tf_mode {tf_mode!r} "
                         f"({'|'.join(TF_MODES)})")
    if tf_mode != "preint2d" and (t.ndim != 2 or t.shape[1] != cols[tf_mode]
                                  or t.shape[0] < (2 if tf_mode != "gaussian"
                                                   else 1)):
        raise ValueError(f"{tf_mode} TF tensor must be (R, "
                         f"{cols[tf_mode]}), got {tuple(t.shape)}")
    if tf_mode in ("piecewise", "texture", "gaussian"):
        return t, t.shape[0], 0
    if tf_pre is None:
        raise ValueError(f"tf_mode={tf_mode!r} needs tf_pre (the table of "
                         "with_preintegration"
                         f"{'_2d' if tf_mode == 'preint2d' else ''})")
    pre = f32(tf_pre)
    if tf_mode == "preint1d":
        if pre.ndim != 2 or pre.shape[1] != 4 or pre.shape[0] < 2:
            raise ValueError("preint1d: tf_pre must be (Rp >= 2, 4)")
        return torch.cat([t, pre], dim=0), t.shape[0], pre.shape[0]
    if pre.ndim != 3 or pre.shape[0] != pre.shape[1] or pre.shape[2] != 4:
        raise ValueError("preint2d: tf_pre must be (R2, R2, 4)")
    r2 = pre.shape[0]
    return pre.reshape(r2 * r2, 4), r2, r2


def _one_hot_chunk(n_cols: int) -> int:
    """Samples a chunk of a one-hot reduction takes (~256 MB of float32
    weights)."""
    return max(1, (1 << 26) // max(1, n_cols))


class _LerpRows(torch.autograd.Function):
    """table[lo] (1 - f) + table[hi] f for samples (N,): the forward reads
    the two rows, the table's gradient is the product of the samples'
    one-hot interpolation weights with their cotangents, in chunks (a
    reduction over the samples, as the TPU kernel contracts it: a
    gather's backward adds millions of samples one by one into a few
    rows, and that float32 sum drifts)."""

    @staticmethod
    def forward(ctx, table, lo, hi, f):
        ctx.save_for_backward(table, lo, hi, f)
        return table[lo] * (1.0 - f)[:, None] + table[hi] * f[:, None]

    @staticmethod
    def backward(ctx, dv):
        table, lo, hi, f = ctx.saved_tensors
        d_table = d_f = None
        if ctx.needs_input_grad[3]:
            d_f = ((table[hi] - table[lo]) * dv).sum(dim=1)
        if ctx.needs_input_grad[0]:
            r = table.shape[0]
            d_table = torch.zeros_like(table)
            step = _one_hot_chunk(r)
            for a in range(0, lo.shape[0], step):
                sl = slice(a, a + step)
                w = (F.one_hot(lo[sl], r).to(dv.dtype) * (1.0 - f[sl])[:, None]
                     + F.one_hot(hi[sl], r).to(dv.dtype) * f[sl][:, None])
                d_table += w.T @ dv[sl]
        return d_table, None, None, d_f


class _Cell(torch.autograd.Function):
    """Row i * r2 + j of ``table`` (r2 * r2, C) for samples (N,): the
    forward reads the cell, the table's gradient is the product of the
    samples' front one-hots with their back one-hots times the
    cotangents, in chunks."""

    @staticmethod
    def forward(ctx, table, i, j, r2):
        ctx.save_for_backward(i, j)
        ctx.r2 = r2
        return table[i * r2 + j]

    @staticmethod
    def backward(ctx, dv):
        i, j = ctx.saved_tensors
        r2, c = ctx.r2, dv.shape[1]
        d_table = dv.new_zeros(r2, r2 * c)
        step = _one_hot_chunk(r2 * (c + 2))
        for a in range(0, i.shape[0], step):
            sl = slice(a, a + step)
            back = F.one_hot(j[sl], r2).to(dv.dtype)[:, :, None] \
                * dv[sl][:, None, :]
            d_table += F.one_hot(i[sl], r2).to(dv.dtype).T @ back.reshape(
                -1, r2 * c)
        return d_table.reshape(r2 * r2, c), None, None, None


def _lut(table: Tensor, s: Tensor, r: int, convention: str) -> Tensor:
    """The lerped lookup of the JAX package's ``_lut4`` on rows (r, C) at
    s (...,): "texture" reads x = s r - 0.5 with clamped ends, "cumulative"
    x = clip(s, 0, 1) (r - 1) (the clip's gradient strictly inside).
    Returns (..., C); gradients to the table and to s (the lerp's
    slope)."""
    flat = s.reshape(-1)
    if convention == "texture":
        x = flat * float(r) - 0.5
        i0 = torch.floor(x)
        f = x - i0
        lo = torch.clamp(i0, 0, r - 1)
        hi = torch.clamp(i0 + 1.0, 0, r - 1)
    else:
        x = _gated_clip01(flat) * float(r - 1)
        lo = torch.clamp(torch.floor(x), 0, r - 2)
        f = x - lo
        hi = lo + 1.0
    out = _LerpRows.apply(table, lo.detach().long(), hi.detach().long(), f)
    return out.reshape(s.shape + (table.shape[1],))


def tf_shade(spec, table: Tensor, density2: Tensor,
             prev_in: Optional[Tensor] = None,
             first: Optional[Tensor] = None):
    """(rgb (..., seg, 3), absorption (..., seg)) of a segment's density
    samples in ``spec.tf_mode`` (texture, preint1d, preint2d, gaussian),
    from their normalized densities ``density2`` (..., seg) (unclipped),
    branch by branch as the JAX package's ``_march_epilogue`` and its
    adjoint: texture and Gaussian absorptions are scaled by the stepsize,
    the preintegrated ones are opacities already. The preintegrating modes
    read each sample's previous density: the one before it in the
    segment, ``prev_in`` (...,) for the first (-1: none), and -1 where
    ``first`` marks a ray's first lattice sample. preint1d takes it
    unclipped (a negative one is none), preint2d clipped."""
    mode = spec.tf_mode
    h = constant(spec.stepsize, torch.float32, density2.device)
    r, rp = spec.tf_points, spec.tf_pre_rows
    d = _gated_clip01(density2)
    if mode == "gaussian":
        mu, sg = table[:, 4], table[:, 5]
        wg = torch.exp(-((d[..., None] - mu) ** 2) / (sg * sg))
        rgba = wg @ table[:, :4]
        return rgba[..., :3], rgba[..., 3] * h
    if mode == "texture":
        plain = _lut(table[:r], d, r, "texture")
        return plain[..., :3], plain[..., 3] * h
    prev = torch.cat([prev_in[..., None], density2[..., :-1]], dim=-1)
    if first is not None:
        prev = torch.where(first, torch.full_like(prev, -1.0), prev)
    one = torch.ones_like(d)
    if mode == "preint2d":
        # nearest cell: no gradient reaches the densities (the JAX
        # package's adjoint, as autodiff of its oracle gives)
        dd = d.detach()
        pe = torch.where(prev < 0, dd, torch.clamp(prev.detach(), 0.0, 1.0))
        i = torch.clamp(torch.floor(pe * float(r)), max=float(r - 1)).long()
        j = torch.clamp(torch.floor(dd * float(r)), max=float(r - 1)).long()
        v = _Cell.apply(table, i.reshape(-1), j.reshape(-1), r).reshape(
            d.shape + (4,))
        w = v[..., 3]
        inv = torch.where(w > 1e-5, 1.0 / torch.clamp(w, min=1e-5), one)
        return v[..., :3] * inv[..., None], w
    if mode != "preint1d":
        raise ValueError(f"unknown tf_mode {mode!r}")
    plain = _lut(table[:r], d, r, "texture")
    prev_eff = torch.where(prev < 0, d, prev)
    vsf = _lut(table[r:r + rp], prev_eff, rp, "cumulative")
    vsb = _lut(table[r:r + rp], d, rp, "cumulative")
    denom = d - prev_eff
    near = torch.abs(denom) < 1e-3
    safe = torch.where(near, one, denom)
    rgb_p = h * (vsb[..., :3] - vsf[..., :3]) / safe[..., None]
    alpha_p = 1.0 - torch.exp(-h * (vsb[..., 3] - vsf[..., 3]) / safe)
    inv_a = torch.where(alpha_p > 1e-5,
                        1.0 / torch.clamp(alpha_p, min=1e-5), one)
    rgb = torch.where(near[..., None], plain[..., :3],
                      rgb_p * inv_a[..., None])
    return rgb, torch.where(near, plain[..., 3] * h, alpha_p)


def carry_width(spec) -> int:
    """Floats of a ray's carry: rgba, the last normalized density for the
    TF modes (-1 before the first sample), and with normals the blended
    normal and depth after it (the JAX kernels' carry rows 0-8)."""
    if spec.normals:
        return 9
    return 4 if spec.tf_mode == "piecewise" else 5


def march_output(spec, carry: Tensor):
    """What a march returns from its final carry (..., carry_width):
    rgba, or with normals ``RayEvaluationOutput`` with the blended normal
    and depth."""
    if not spec.normals:
        return carry[..., :4]
    return RayEvaluationOutput(color=carry[..., :4], depth=carry[..., 8:9],
                               normal=carry[..., 5:8])


def initial_carry(spec, shape, device) -> Tensor:
    carry = torch.zeros(tuple(shape) + (carry_width(spec),),
                        dtype=torch.float32, device=device)
    if carry.shape[-1] >= 5:
        carry[..., 4] = -1.0
    return carry


def _plain_segment(spec, params, rays, kbase, s, carry):
    """Segment ``s`` of the rays (n, 8) from their ``carry`` (n,
    :func:`carry_width`). Returns (carry, samples
    evaluated). Differentiable in ``params`` and ``carry`` with the TPU
    kernel's gradient: a sample that absorbs nothing passes none."""
    dev = rays.device
    h = constant(spec.stepsize, torch.float32, dev)
    k = (float(s * spec.seg)
         + torch.arange(spec.seg, dtype=torch.float32, device=dev))[None, :]
    a, tmx = rays[:, 6:7], rays[:, 7:8]
    if spec.lattice:
        kk = kbase[:, None] + k
        t = kk * h
        valid = (t <= tmx) & (kk >= a)
    else:
        t = a + k * h
        valid = t <= tmx
    rs, rd = rays[:, None, 0:3], rays[:, None, 3:6]
    bmin = constant(spec.box_min, torch.float32, dev)
    bsize = constant(spec.box_size, torch.float32, dev)
    x01 = ((rs + t[..., None] * rd - bmin) / bsize).reshape(-1, 3)
    dirs = rd.expand(-1, spec.seg, -1).reshape(-1, 3)
    net = dict(direction=spec.direction, activation=spec.activation,
               output_mode=spec.output_mode)
    if spec.normals:
        vals, g01 = network_position_grad(params, x01, dirs, **net)
        vals = vals.reshape(rays.shape[0], spec.seg, 1)
        grad = g01.reshape(rays.shape[0], spec.seg, 3) / bsize
    else:
        vals = _network_values(params, x01, dirs, **net).reshape(
            rays.shape[0], spec.seg, -1)
    if spec.iso_value is not None:
        carry = carry.clone()
        inside = valid & (vals[..., 0] > spec.iso_value)
        found = carry[:, 3] > 0.5
        before = (torch.cumsum(inside.to(torch.int32), dim=1)
                  - inside.to(torch.int32)) > 0
        n = (valid & ~found[:, None] & ~before).sum()
        t_hit = torch.where(inside, t, torch.full_like(t, _FAR)).amin(dim=1)
        hit = ~found & (t_hit < 1.0e38)
        carry[:, 0] = torch.where(hit, t_hit, carry[:, 0])
        carry[:, 3] = torch.where(hit, torch.ones_like(t_hit), carry[:, 3])
        return carry, n
    prev_out = None
    if spec.output_mode.startswith("density"):
        v = vals[..., 0]
        density2 = ((v - spec.density_min)
                    * (1.0 / (spec.density_max - spec.density_min)))
        if spec.tf_mode == "piecewise":
            rgba = _piecewise(params[0], _gated_clip01(density2))
            rgb, absn = rgba[..., :3], rgba[..., 3] * h
        else:
            rgb, absn = tf_shade(spec, params[0], density2, carry[:, 4],
                                 (kk == a) if spec.lattice else None)
            prev_out = density2[:, -1]
        require = valid & (v >= spec.density_min)
        if spec.normals:
            rgb, absn, nrm = shade_samples(spec.brdf, rgb, absn, grad,
                                           rs + t[..., None] * rd, rd)
    else:
        rgb, absn = vals[..., :3], vals[..., 3] * h
        require = valid
    absn = torch.where(require, absn, torch.zeros_like(absn))
    ca = (torch.where(absn < 1.0, absn, torch.ones_like(absn))
          if spec.blend_alpha else 1.0 - torch.exp(-absn))
    contrib = require & (absn > 0)
    rgb = torch.where(contrib[..., None], rgb, rgb.detach())
    ca = torch.where(contrib, ca, ca.detach())
    nd = torch.cat([nrm, t[..., None]], dim=-1) if spec.normals else None
    return composite(spec, carry, rgb, ca, prev_out, nd), valid.sum()


def composite(spec, carry: Tensor, rgb: Tensor, ca: Tensor,
              last: Optional[Tensor] = None,
              nd: Optional[Tensor] = None) -> Tensor:
    """A segment's samples (..., seg) front to back "over" into ``carry``
    (..., :func:`carry_width`): colours ``rgb`` (..., seg, 3), alphas
    ``ca``; ``last`` the TF modes' last density (None: the carried one
    stays); with normals ``nd`` (..., seg, 4), the samples' normal and
    depth, blended with the colour's weights. Returns the new carry."""
    c, alpha = carry[..., :3], carry[..., 3]
    acc = carry[..., 5:9] if spec.normals else None
    for j in range(spec.seg):
        w = (1.0 - alpha) * ca[..., j]
        c = c + w[..., None] * rgb[..., j, :]
        if acc is not None:
            acc = acc + w[..., None] * nd[..., j, :]
        alpha = alpha + (1.0 - alpha) * ca[..., j]
    out = [c, alpha[..., None]]
    if carry.shape[-1] > 4:
        out.append(last[..., None] if last is not None else carry[..., 4:5])
    if acc is not None:
        out.append(acc)
    return torch.cat(out, dim=-1)


def _plain_march(spec: SegmentSpec, params: list, rays: Tensor,
                 kbase: Optional[Tensor], store: bool = False):
    """The plain engine: (rgba (R, 4), SegmentStats, carries). Segment s
    runs while some ray of the call is alive at s; every ray whose segment
    start is still <= tmax composites it. With ``store`` ``carries`` is the
    list of the (R, 4) carries ((R, 5) in the TF modes) entering each
    segment run, else None."""
    dev = rays.device
    carry = initial_carry(spec, (rays.shape[0],), dev)
    samples = torch.zeros((), dtype=torch.int64, device=dev)
    stop = 0
    chunk = max(1, _PLAIN_CHUNK_SAMPLES // spec.seg)
    carries = [] if store else None
    for s in range(spec.n_seg):
        done = _segment_done(spec, rays, kbase, s)
        if not bool((~(done | (carry[:, 3] >= spec.early_alpha))).any()):
            break
        stop = s + 1
        if store:
            carries.append(carry.clone())
        for idx in torch.nonzero(~done).flatten().split(chunk):
            carry[idx], n = _plain_segment(
                spec, params, rays[idx],
                kbase[idx] if kbase is not None else None, s, carry[idx])
            samples += n
    stats = SegmentStats(samples, torch.tensor(stop, dtype=torch.int64))
    return march_output(spec, carry), stats, carries


def _segment_done(spec: SegmentSpec, rays: Tensor, kbase, s: int) -> Tensor:
    """(R,) bool: the ray's segment ``s`` starts past its tmax (it has no
    valid sample left)."""
    s0 = _f32(np.float32(s * spec.seg) * np.float32(spec.stepsize))
    t0 = ((kbase + float(s * spec.seg)) * spec.stepsize if spec.lattice
          else rays[:, 6] + s0)
    return t0 > rays[:, 7]


def fused_trace_dvr_plain(ray_start: Tensor, ray_dir: Tensor,
                          net: SceneRepresentationNetwork, box_min, box_size,
                          tf_tensor: Tensor, *, stepsize: float,
                          max_steps: int, density_min: float = 0.0,
                          density_max: float = 1.0,
                          blend_mode: str = "beer_lambert",
                          alpha_early_out: float = 0.999,
                          enable_early_out: bool = True, seg: int = 32,
                          tile: int = 256, differentiable: bool = False,
                          latent_mode: str = "table",
                          table_dtype: torch.dtype = torch.float32,
                          n_seg: Optional[int] = None,
                          need_normals: bool = False, brdf=None,
                          iso_value=None, tf_mode: str = "piecewise",
                          tf_pre: Optional[Tensor] = None,
                          tmax_clip: Optional[Tensor] = None,
                          time=0.0, ensemble=0.0,
                          return_stats: bool = False, **tpu_schedule):
    """Plain PyTorch version of :func:`fused_trace_dvr`: the same
    schedule and stop, vectorized over the rays of each segment in chunks,
    a Python loop over segments; with ``differentiable`` the autograd
    Function ``ops.fused_dvr_bwd._PlainSegmentMarch`` with the kernels'
    gradient; with ``need_normals`` each sample's position gradient by
    :func:`network_position_grad`."""
    strict_f32()
    _tpu_schedule(tpu_schedule)
    net = resolve_network(net, time, ensemble)
    table, tf_points, tf_pre_rows = prepare_tf(tf_tensor, tf_mode, tf_pre,
                                               ray_start.device)
    spec, rays, kbase = _segment_setup(
        ray_start, ray_dir, net, box_min, box_size, stepsize=stepsize,
        max_steps=max_steps, density_min=density_min,
        density_max=density_max, blend_mode=blend_mode,
        alpha_early_out=alpha_early_out, enable_early_out=enable_early_out,
        seg=seg, tile=tile, differentiable=differentiable,
        latent_mode=latent_mode, table_dtype=table_dtype, n_seg=n_seg,
        need_normals=need_normals, iso_value=iso_value, tf_mode=tf_mode,
        tmax_clip=tmax_clip, tf_points=tf_points, tf_pre_rows=tf_pre_rows,
        brdf=brdf)
    params = segment_params(net, table, table_dtype)
    if differentiable:
        from .fused_dvr_bwd import _PlainSegmentMarch
        out, samples, stop = _PlainSegmentMarch.apply(rays, kbase, spec,
                                                      *params)
        stats = SegmentStats(samples, stop)
    else:
        with torch.no_grad():
            out, stats, _ = _plain_march(spec, params, rays, kbase)
    return (out, stats) if return_stats else out


def _tpu_schedule(kwargs: dict):
    """``segment_remat`` and ``stash_backward`` choose how the TPU keeps
    the backward's residuals (recompute each segment's forward, or stash
    its activations); the result is the same, and this port's design
    (stored carries, recomputed activations) has no such choice: accepted
    and ignored. Anything else raises ``TypeError``."""
    unknown = set(kwargs) - {"segment_remat", "stash_backward"}
    if unknown:
        raise TypeError(f"fused_trace_dvr: unexpected options {unknown}")


# ---------------------------------------------------------------------------
# the CUDA kernel


def _check_kernel_inputs(net, tf: Tensor, seg: int = 32,
                         differentiable: bool = False,
                         tf_mode: str = "piecewise",
                         need_normals: bool = False):
    """What csrc/segment_fwd.cu (and, for gradients, segment_bwd.cu)
    takes for the TF table ``tf`` (``prepare_tf``'s) in ``tf_mode``: every
    mode on SnakeAlt networks, and on every other activation the texture,
    1D- and 2D-preintegrated TFs (segment_fwd_anytf.cu) and in training
    the Gaussians (segment_fwd_anyg.cu; the render refuses them); its
    normals instances (segment_fwd_nrm.cu, segment_fwd_nrm128.cu) take
    the piecewise TF. Hidden layers up to 128 wide, each zero-padded to
    the instance of the widest (32, 48, 64, or 128 in the ``*128``
    libraries), several widths in the render only. Any number of TF knots
    or Gaussians: the plans count the TF up to ``TF_STAGED_POINTS``
    points and none above (the kernels then read it from device memory).
    The rest raises ``NotImplementedError``."""
    from .sample_mlp import staged_tf_floats, tf_floats_of
    if need_normals and tf_mode != "piecewise":
        raise NotImplementedError(f"segment kernel: normals with TF mode "
                                  f"{tf_mode!r} are not ported yet "
                                  "(piecewise only)")
    check_kernel_width(net, "segment kernel", differentiable)
    if len(net.layers) - 2 > MAX_HIDDEN_LAYERS:
        raise NotImplementedError(f"segment kernel: at most "
                                  f"{MAX_HIDDEN_LAYERS + 1} hidden layers")
    if net.input.num_fourier > MAX_FOURIER:
        raise NotImplementedError(f"segment kernel: at most {MAX_FOURIER} "
                                  "Fourier features")
    grid = net.latent.static_grid
    if grid is not None and grid.shape[0] > MAX_LATENT_CHANNELS:
        raise NotImplementedError("segment kernel: at most "
                                  f"{MAX_LATENT_CHANNELS} latent channels")
    if (tf_mode == "gaussian" and net.layers[0].activation != "SnakeAlt"
            and not differentiable):
        raise NotImplementedError(
            f"segment kernel: TF mode 'gaussian' on a "
            f"{net.layers[0].activation} network in training only")
    tf_floats = staged_tf_floats(tf_mode, 5 * tf.shape[0]
                                 if tf_mode == "piecewise"
                                 else tf_floats_of(tf_mode, tf))
    if net.layers[0].activation not in _ACTIVATIONS:
        raise NotImplementedError(f"segment kernel: activation "
                                  f"{net.layers[0].activation}")
    from .sample_mlp import check_fwd_plan
    check_fwd_plan("segment kernel", kernel_width(net),
                   net.input.num_fourier, _latent_chunks(net),
                   len(net.layers) - 2, tf.shape[0],
                   direction=bool(net.use_direction), tf_floats=tf_floats)
    if differentiable and seg > MAX_BWD_SEG:
        raise NotImplementedError(f"segment backward kernel: seg <= "
                                  f"{MAX_BWD_SEG} only")
    if differentiable:
        from .sample_mlp import check_plan
        nf = net.input.num_fourier
        check_plan("segment backward kernel", kernel_width(net),
                   6 + 2 * nf + 16 * _latent_chunks(net),
                   len(net.layers) - 2, nf, tf.shape[0], tf_floats,
                   tf_mode != "piecewise")


def _latent_chunks(net) -> int:
    grid = net.latent.static_grid
    return 0 if grid is None else -(-grid.shape[0] // 16)


def pack_segment_weights(net, tf: Tensor,
                         tf_mode: str = "piecewise") -> Tensor:
    """The kernel's packed float32 weights (layout in
    csrc/segment_common.cuh, ``Wts``: matrices input-major), hidden width
    zero-padded to :func:`kernel_width`; the TF table last (the preint2d
    table apart: the kernels read it as its own array)."""
    f32 = dict(dtype=torch.float32, device=tf.device)
    hp = kernel_width(net)
    fm = net.input.fourier_matrix
    nf = net.input.num_fourier
    b = torch.zeros(nf, 3, **f32)
    bd = torch.zeros(nf, 3, **f32)
    if nf:
        b = fm[:, :3].detach().to(**f32)
        if fm.shape[1] == 6:
            bd = fm[:, 3:6].detach().to(**f32)
    n_in = net.input.num_input_channels()
    w1 = net.layers[0].weight.detach().to(**f32)
    n_lat = w1.shape[1] - n_in - 2 * nf
    w1p = torch.zeros(6 + 2 * nf + 16 * _latent_chunks(net), hp, **f32)
    width = w1.shape[0]
    w1p[:n_in, :width] = w1[:, :n_in].T
    w1p[6:6 + 2 * nf, :width] = w1[:, n_in:n_in + 2 * nf].T
    w1p[6 + 2 * nf:6 + 2 * nf + n_lat, :width] = w1[:, n_in + 2 * nf:].T

    def pad(t, rows, cols=None):
        t = t.detach().to(**f32)
        out = torch.zeros((rows,) if cols is None else (rows, cols), **f32)
        if cols is None:
            out[:t.shape[0]] = t
        else:
            out[:t.shape[0], :t.shape[1]] = t
        return out

    hidden = net.layers[1:-1]
    parts = [w1p, pad(net.layers[0].bias, hp)]
    parts += [pad(l.weight.T, hp, hp) for l in hidden]
    parts += [pad(l.bias, hp) for l in hidden]
    parts += [pad(net.layers[-1].weight, 4, hp),
              pad(net.layers[-1].bias, 4), b, bd]
    if tf_mode != "preint2d":
        parts.append(tf.detach())
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def segment_table(net, table_dtype: torch.dtype, device) -> Tensor:
    """The latent grid (C, D, H, W) as the kernel's channel-last
    (D, H, W, 16 * chunks) table, channels zero-padded: ``table_dtype``
    for <= 16 channels, float32 above. Without a grid, one zero voxel
    (not read)."""
    grid = net.latent.static_grid
    if grid is None:
        return torch.zeros(1, 1, 1, 16, dtype=torch.float32, device=device)
    c = grid.shape[0]
    dtype = table_dtype if c <= 16 else torch.float32
    t = grid.detach().to(device=device, dtype=torch.float32).permute(
        1, 2, 3, 0)
    width = 16 * _latent_chunks(net)
    if c < width:
        t = torch.cat([t, t.new_zeros(t.shape[:3] + (width - c,))], dim=3)
    return t.to(dtype).contiguous()


def _bind(lib: ctypes.CDLL):
    fn = lib.segment_fwd_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p, p, p, i, p, i, p, p, p, p] + [i] * 10 + [f] + [i] * 5
                   + [f] + [i, i] + [f] * 4 + [f] * 6 + [i] * 4
                   + [p, p, p, p])
    fn.restype = ctypes.c_int
    return fn


def device_fwd_plan(hidden: int, n_fourier: int, chunks: int,
                    n_hidden: int, tf_points: int, direction: bool = False,
                    tf_floats: Optional[int] = None):
    """(bytes, warps a block, matrices pre-split) of the shared-memory
    plan csrc/segment_fwd.cu takes for these widths (``tf_floats`` staged
    TF floats, 5 a piecewise knot by default), or None when none fits (the
    device's own ``choose_fwd_plan``; ``ops.sample_mlp.fwd_plan`` mirrors
    it)."""
    fn = _build.load(width_library("segment_fwd", hidden)).segment_fwd_smem
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_long * 3)()
    if fn(hidden, n_fourier, chunks, n_hidden,
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


def width_library(name: str, hidden: int) -> str:
    """The per-segment engine's and the sample evaluator's library
    ``name`` for the padded width ``hidden``: the widths 32, 48 and 64 are
    instances of one library, 128 (the wide plan) of ``<name>128``."""
    return f"{name}{hidden}" if hidden > SMEM_MAX_WIDTH else name


def segment_library(spec: SegmentSpec, hidden: int = 32) -> str:
    """The forward's library for this march at the padded width
    ``hidden``: "segment_fwd" (the piecewise TF), "segment_fwd_tf" (the
    other TF modes of SnakeAlt networks), "segment_fwd_anytf" (the texture
    and preintegrated TFs of every other activation) or "segment_fwd_anyg"
    (their Gaussians); at width 128 the same with "128" appended."""
    if spec.tf_mode == "piecewise":
        name = "segment_fwd"
    elif spec.activation[0] == "SnakeAlt":
        name = "segment_fwd_tf"
    else:
        name = ("segment_fwd_anyg" if spec.tf_mode == "gaussian"
                else "segment_fwd_anytf")
    return width_library(name, hidden)


def launch_segment(spec: SegmentSpec, net, rays: Tensor,
                   kbase: Optional[Tensor], weights: Tensor, table: Tensor,
                   tf_points: int, store_carries: bool = False,
                   tf: Optional[Tensor] = None):
    """Launch csrc/segment_fwd.cu: the march, then the continuation up to
    the call's stop; with ``store_carries`` (a march with no early-out)
    the march alone, storing the carries. ``tf``: the TF modes' table
    (``prepare_tf``'s). Returns (rgba (R, 4), SegmentStats, carries
    (n_seg, R, 4), with the last densities (n_seg, R) a
    ``fused_mega.TfCarries`` in the TF modes, or None; death (R,) int32:
    the segments each ray ran)."""
    global SEGMENT_LAUNCHES
    dev = rays.device
    n_rays = rays.shape[0]
    out = torch.empty(n_rays, 4, dtype=torch.float32, device=dev)
    death = torch.empty(n_rays, dtype=torch.int32, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    carries = dens_carries = dens = None
    tfm = spec.tf_mode != "piecewise"
    if tfm:
        dens = torch.empty(n_rays, dtype=torch.float32, device=dev)
        _check_tensors(dev, tf=tf)
    if store_carries:
        if spec.early_alpha < 1.5:
            raise ValueError("carries are stored by a march with no "
                             "early-out")
        carries = torch.empty(spec.n_seg, n_rays, 4, dtype=torch.float32,
                              device=dev)
        if tfm:
            dens_carries = torch.empty(spec.n_seg, n_rays,
                                       dtype=torch.float32, device=dev)
    _check_tensors(dev, rays=rays, weights=weights, table=table)
    if spec.lattice:
        _check_tensors(dev, kbase=kbase)
    if weights.dtype != torch.float32 or table.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError("float32 weights and a bf16 or float32 table")
    gz, gy, gx = table.shape[:3]
    nf = net.input.num_fourier
    rows, *tf_args = _tf_args(spec, tf, tf_points)
    lib = segment_library(spec, kernel_width(net))
    fn = _bind(_build.load(lib))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for phase in ((0,) if store_carries else (0, 1)):
            err = fn(
                rays.data_ptr(), kbase.data_ptr() if spec.lattice else None,
                table.data_ptr(), int(table.dtype == torch.float32),
                weights.data_ptr(), weights.numel(), out.data_ptr(),
                death.data_ptr(), stats.data_ptr(),
                carries.data_ptr() if carries is not None else None, n_rays,
                gx, gy, gz, _latent_chunks(net), nf, len(net.layers) - 2,
                kernel_width(net), rows,
                _ACTIVATIONS[spec.activation[0]], spec.activation[1],
                _HEADS[spec.output_mode], int(net.use_direction),
                int(spec.lattice), int(spec.blend_alpha),
                int(spec.iso_value is not None),
                0.0 if spec.iso_value is None else spec.iso_value, spec.seg,
                spec.n_seg, spec.stepsize, spec.density_min,
                1.0 / (spec.density_max - spec.density_min),
                spec.early_alpha, *spec.box_min, *spec.box_size, phase,
                *tf_args, dens.data_ptr() if dens is not None else None,
                (dens_carries.data_ptr() if dens_carries is not None
                 else None), stream)
            if err != 0:
                raise RuntimeError(f"segment_fwd launch (phase {phase}) "
                                   f"failed with CUDA error {err}")
            LIBRARY_LAUNCHES[lib] += 1
            if not store_carries:
                SEGMENT_LAUNCHES += 1
    if dens_carries is not None:
        carries = TfCarries(carries, dens_carries)
    return out, SegmentStats(stats[1], stats[0]), carries, death


def _bind_nrm(lib: ctypes.CDLL):
    fn = lib.segment_fwd_nrm_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p, p, p, i, p, i, p, p, p, p] + [i] * 10 + [f] + [i] * 4
                   + [i, i] + [f] * 4 + [f] * 6 + [i, p, p, p])
    fn.restype = ctypes.c_int
    return fn


def launch_segment_nrm(spec: SegmentSpec, net, rays: Tensor,
                       kbase: Optional[Tensor], weights: Tensor,
                       table: Tensor, tf_points: int):
    """Launch csrc/segment_fwd_nrm.cu (segment_fwd_nrm128.cu at width
    128): the march and its continuation (as
    :func:`launch_segment`) with each counting sample's position gradient,
    shading (``spec.brdf``) and the blended normal and depth. Returns
    (RayEvaluationOutput, SegmentStats)."""
    global SEGMENT_NRM_LAUNCHES
    dev = rays.device
    n_rays = rays.shape[0]
    out = torch.empty(n_rays, 4, dtype=torch.float32, device=dev)
    nd = torch.empty(n_rays, 4, dtype=torch.float32, device=dev)
    death = torch.empty(n_rays, dtype=torch.int32, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    _check_tensors(dev, rays=rays, weights=weights, table=table)
    if spec.lattice:
        _check_tensors(dev, kbase=kbase)
    gz, gy, gx = table.shape[:3]
    si, sf = shade_args(spec.brdf)
    lib = width_library("segment_fwd_nrm", kernel_width(net))
    fn = _bind_nrm(_build.load(lib))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for phase in (0, 1):
            err = fn(
                rays.data_ptr(), kbase.data_ptr() if spec.lattice else None,
                table.data_ptr(), int(table.dtype == torch.float32),
                weights.data_ptr(), weights.numel(), out.data_ptr(),
                nd.data_ptr(), death.data_ptr(), stats.data_ptr(), n_rays,
                gx, gy, gz, _latent_chunks(net), net.input.num_fourier,
                len(net.layers) - 2, kernel_width(net), tf_points,
                _ACTIVATIONS[spec.activation[0]], spec.activation[1],
                _HEADS[spec.output_mode], int(net.use_direction),
                int(spec.lattice), int(spec.blend_alpha), spec.seg,
                spec.n_seg, spec.stepsize, spec.density_min,
                1.0 / (spec.density_max - spec.density_min),
                spec.early_alpha, *spec.box_min, *spec.box_size, phase, si,
                sf, stream)
            if err != 0:
                raise RuntimeError(f"segment_fwd_nrm launch (phase {phase})"
                                   f" failed with CUDA error {err}")
            SEGMENT_NRM_LAUNCHES += 1
            LIBRARY_LAUNCHES[lib] += 1
    return (RayEvaluationOutput(color=out, depth=nd[:, 3:4],
                                normal=nd[:, :3]),
            SegmentStats(stats[1], stats[0]))


def fused_trace_dvr(ray_start: Tensor, ray_dir: Tensor,
                    net: SceneRepresentationNetwork, box_min, box_size,
                    tf_tensor: Tensor, *, stepsize: float, max_steps: int,
                    density_min: float = 0.0, density_max: float = 1.0,
                    blend_mode: str = "beer_lambert",
                    alpha_early_out: float = 0.999,
                    enable_early_out: bool = True, seg: int = 32,
                    tile: int = 256, differentiable: bool = False,
                    latent_mode: str = "table",
                    table_dtype: torch.dtype = torch.float32,
                    n_seg: Optional[int] = None, need_normals: bool = False,
                    brdf=None, iso_value=None, tf_mode: str = "piecewise",
                    tf_pre: Optional[Tensor] = None,
                    tmax_clip: Optional[Tensor] = None,
                    time=0.0, ensemble=0.0,
                    return_stats: bool = False, **tpu_schedule):
    """The per-segment fused march (see the module doc) of rays (R, 3), R a
    multiple of ``tile``. CUDA tensors launch the kernel, CPU tensors run
    :func:`fused_trace_dvr_plain`. ``n_seg`` overrides the segment count
    (ceil(max_steps/seg), or certified in lattice mode). With
    ``differentiable`` the result carries gradients to the network's parameters
    and to ``tf_tensor`` (no early-out: every segment runs; the latent table
    float32 or bf16 as ``table_dtype`` says, its gradient summed in float32 and
    rounded to it once per cell); the rays get none, as from the JAX package's
    custom VJP. ``tf_mode`` (:data:`TF_MODES`) and ``tf_pre`` choose the TF as
    in the JAX package (:func:`prepare_tf`); the gradient reaches ``tf_pre``
    too. ``segment_remat``/``stash_backward`` are accepted and ignored
    (:func:`_tpu_schedule`). With ``need_normals`` (and a ``brdf``) the normals
    instances (``csrc/segment_fwd_nrm.cu``, the piecewise TF) shade the samples
    and blend the normal and depth. ``time``/``ensemble`` condition a network
    with keyframed grids or latent vectors (:func:`resolve_network`; the
    gradient reaches the keyframes and vectors). Returns rgba (R, 4), or
    ``RayEvaluationOutput`` with normals, and :class:`SegmentStats` with
    ``return_stats``."""
    net = resolve_network(net, time, ensemble)
    kw = dict(stepsize=stepsize, max_steps=max_steps,
              density_min=density_min, density_max=density_max,
              blend_mode=blend_mode, alpha_early_out=alpha_early_out,
              enable_early_out=enable_early_out, seg=seg, tile=tile,
              differentiable=differentiable, latent_mode=latent_mode,
              table_dtype=table_dtype, n_seg=n_seg,
              need_normals=need_normals, iso_value=iso_value,
              tf_mode=tf_mode, tmax_clip=tmax_clip)
    if ray_start.device.type == "cpu":
        kw["brdf"] = brdf
        return fused_trace_dvr_plain(ray_start, ray_dir, net, box_min,
                                     box_size, tf_tensor, tf_pre=tf_pre,
                                     return_stats=return_stats, **kw,
                                     **tpu_schedule)
    if ray_start.device.type != "cuda":
        raise ValueError(f"unsupported device {ray_start.device}")
    _tpu_schedule(tpu_schedule)
    tf, tf_points, tf_pre_rows = prepare_tf(tf_tensor, tf_mode, tf_pre,
                                            ray_start.device)
    if not net.output_mode.startswith("density") and tf_mode != "piecewise":
        # the rgbo heads read no TF: the piecewise instance, a dummy TF
        tf_mode, tf_points, tf_pre_rows = "piecewise", 2, 0
        tf = torch.tensor([[0.0] * 5, [0.0, 0.0, 0.0, 0.0, 1.0]],
                          device=ray_start.device)
        kw["tf_mode"] = "piecewise"
    spec, rays, kbase = _segment_setup(ray_start, ray_dir, net, box_min,
                                       box_size, **kw, tf_points=tf_points,
                                       tf_pre_rows=tf_pre_rows, brdf=brdf)
    _check_kernel_inputs(net, tf, seg, differentiable, tf_mode, need_normals)
    tfk = tf.detach().contiguous() if tf_mode != "piecewise" else None
    if need_normals:
        with torch.no_grad():
            out, stats = launch_segment_nrm(
                spec, net, rays, kbase, pack_segment_weights(net, tf),
                segment_table(net, table_dtype, rays.device), tf.shape[0])
    elif differentiable:
        from .fused_dvr_bwd import _SegmentKernelMarch
        out, samples, stop = _SegmentKernelMarch.apply(
            rays, kbase, spec, net, table_dtype,
            *segment_params(net, tf, table_dtype))
        stats = SegmentStats(samples, stop)
    else:
        with torch.no_grad():
            out, stats, _, _ = launch_segment(
                spec, net, rays, kbase,
                pack_segment_weights(net, tf, tf_mode),
                segment_table(net, table_dtype, rays.device), tf.shape[0],
                tf=tfk)
    return (out, stats) if return_stats else out


# ---------------------------------------------------------------------------
# routes on the engine


def fused_trace_dvr_bucketed(ray_start: Tensor, ray_dir: Tensor, net,
                             box_min, box_size, tf_tensor: Tensor, *,
                             plan: RayBucketPlan, engine: str = "scan",
                             march=None, segment_active_groups=None,
                             **kwargs):
    """Run the engine once per bucket of ``plan`` and reassemble the
    output in the input ray order. ``engine="scan"`` is the per-segment
    engine in lattice mode (``march``: :func:`fused_trace_dvr` or its
    plain version), ``"mega"`` the megakernel
    (``ops.fused_mega.mega_trace_dvr``). ``kwargs`` go to each call, with
    ``tmax_clip`` and the segment count from the plan; ``time`` and
    ``ensemble`` resolve the network once for all buckets. With
    ``return_stats`` the second result sums the buckets' samples and holds
    their stops as a tensor. With ``need_normals`` every field of the
    ``RayEvaluationOutput`` is reassembled (rays of dead tiles: zeros).
    ``segment_active_groups`` (mega only, as in the JAX package): one
    (tiles, segments) occupancy mask a bucket
    (``ops.occupancy.plan_segment_occupancy``), each going to its
    bucket's ``segment_active``. Gradients (``differentiable``, and the
    rays' with ``ray_grads``) pass back through the permutation."""
    if engine == "scan" and segment_active_groups is not None:
        raise NotImplementedError("segment_active requires engine='mega'")
    return_stats = kwargs.pop("return_stats", False)
    kwargs.pop("max_steps", None)
    net = resolve_network(net, kwargs.pop("time", 0.0),
                          kwargs.pop("ensemble", 0.0))
    dev = ray_start.device
    perm = torch.as_tensor(plan.perm, device=dev)
    rs = ray_start.reshape(-1, 3)[perm]
    rd = ray_dir.reshape(-1, 3)[perm]
    outs, samples, stops = [], [], []
    ofs = plan.dead
    masks = (segment_active_groups if segment_active_groups is not None
             else (None,) * len(plan.group_sizes))
    for size, g_steps, g_seg, mask in zip(plan.group_sizes, plan.group_steps,
                                          plan.group_segments, masks):
        clip = (torch.as_tensor(plan.tmax_clip[ofs:ofs + size], device=dev)
                if plan.tmax_clip is not None else None)
        sl = slice(ofs, ofs + size)
        if engine == "mega":
            from .fused_mega import mega_trace_dvr
            fn = march or mega_trace_dvr
            mk = {k: v for k, v in kwargs.items()
                  if k not in ("latent_mode", "n_seg")}
            if mask is not None:
                mk["segment_active"] = mask
            out = fn(rs[sl].contiguous(), rd[sl].contiguous(), net, box_min,
                     box_size, tf_tensor, tmax_clip=clip,
                     return_samples=return_stats, **mk)
            if return_stats:
                out, smp = out
                samples.append(smp.sum())
        elif engine == "scan":
            fn = march or fused_trace_dvr
            out = fn(rs[sl], rd[sl], net, box_min, box_size, tf_tensor,
                     max_steps=g_steps, n_seg=g_seg, tmax_clip=clip,
                     return_stats=return_stats, **kwargs)
            if return_stats:
                out, st = out
                samples.append(st.samples)
                stops.append(st.stop)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        outs.append(out)
        ofs += size
    inv = torch.as_tensor(plan.inv, device=dev)

    def joined(parts):
        if plan.dead:
            parts.insert(0, parts[0].new_zeros((plan.dead,)
                                               + parts[0].shape[1:]))
        return torch.cat(parts, dim=0)[inv]

    if isinstance(outs[0], RayEvaluationOutput):
        out = RayEvaluationOutput(*(joined([o[i] for o in outs])
                                    for i in range(3)))
    else:
        out = joined(outs)
    if not return_stats:
        return out
    return out, SegmentStats(
        torch.stack(samples).sum() if samples else torch.zeros(()),
        torch.stack([s.to(dev) for s in stops]) if stops else None)


def fused_trace_iso(ray_start: Tensor, ray_dir: Tensor, net, box_min,
                    box_size, config, *, max_steps: int, seg: int = 32,
                    tile: int = 256, table_dtype: torch.dtype = torch.float32,
                    time=0.0, ensemble=0.0, march=None,
                    return_stats: bool = False):
    """Isosurface render on the per-segment engine: the kernel's first-hit
    march (a hit ray is dead), then bisection and shading per ray in
    plain PyTorch against the float32 network. ``config``: a
    ``raytracer.iso.RayEvaluationSteppingIso``; ``march``:
    :func:`fused_trace_dvr` (default) or its plain version; ``time`` and
    ``ensemble`` condition the march and the refinement alike. Returns
    ``RayEvaluationOutput`` (and the march's stats)."""
    from ..models.network_volume import VolumeInterpolationNetwork
    from ..raytracer.iso import refine_and_shade

    dummy_tf = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0],
                             [1.0, 1.0, 1.0, 1.0, 1.0]],
                            device=ray_start.device)
    raw, stats = (march or fused_trace_dvr)(
        ray_start, ray_dir, resolve_network(net, time, ensemble), box_min,
        box_size, dummy_tf,
        stepsize=float(config.stepsize), max_steps=max_steps, seg=seg,
        tile=tile, enable_early_out=True, alpha_early_out=0.999,
        table_dtype=table_dtype, iso_value=float(config.isovalue),
        return_stats=True)
    vol = VolumeInterpolationNetwork(net, box_min, box_size, time=time,
                                     ensemble=ensemble)
    rs = ray_start.reshape(-1, 3)
    rd = ray_dir.reshape(-1, 3)
    out = refine_and_shade(rs, rd, vol, config, raw[:, 0:1],
                           raw[:, 3:4] > 0.5)
    return (out, stats) if return_stats else out
