"""The per-segment engine's differentiable march: its CUDA kernel pair and
their plain PyTorch version.

Counterpart of ``fvsrn_tpu/ops/fused_dvr_bwd.py``: ``make_segment_op``
wraps the TPU kernel ``_segment_kernel`` (forward, the segment's carry
kept as residual) and ``_segment_bwd_kernel`` (backward, math in
``bwd_segment_core``) in a custom VJP, and ``fused_trace_dvr(...,
differentiable=True)`` scans it over every segment with no early-out. The
port runs the whole march as one launch of each kernel, behind
``torch.autograd.Function``s that ``ops.fused_dvr.fused_trace_dvr`` applies:

- ``_SegmentKernelMarch`` (CUDA tensors): the forward launches
  ``csrc/segment_fwd.cu`` storing the carry entering every segment each
  ray runs, the backward ``csrc/segment_bwd.cu``; its packed gradient is
  unpacked by :func:`unpack_segment_grads`;
- ``_PlainSegmentMarch`` (CPU tensors): the forward stores the same
  carries, the backward re-runs the segments in reverse under autograd
  from the stored carries.

The gradient is that of the TPU kernel's adjoint, which fixes the
subgradients at the clips: a sample that absorbs nothing passes no
gradient, the TF knot positions get one only strictly inside an
interval, the density's and the heads' clips pass one only strictly
inside, ReLU none at 0, alpha blending none where the absorption reaches 1.
Gradients reach every layer's weight and bias, the Fourier matrix (its
direction block too), the latent grid (read from a float32 or bf16
table; its gradient summed in float32, then rounded through the storage
cast's backward once per cell) and the TF tensor (colors, opacity,
knot positions; zero for the rgbo heads, which do not read it). The rays
get none: a zero gradient, as the JAX package's custom VJP returns
(``fvsrn_tpu/ops/fused_dvr_bwd.py:1440``).

Bound of the backward on the H100: operations (per contributing sample
the forward's network again, its transposed layers and the weight
gradient's outer products) against the stored carries and the latent
gradient. The backward runs its network work on the batched sample MLP
(``csrc/sample_mlp.cuh``, host side ``ops/sample_mlp.py``): tiles of
(ray, sample) rows whose layers, transposed layers and weight gradients
are TF32 three-pass tensor-core products (float32-accurate).
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch
from torch import Tensor

from . import _build
from .fused_dvr import (_ACTIVATIONS, _HEADS, _PLAIN_CHUNK_SAMPLES,
                        SegmentSpec, _check_tensors, _latent_chunks,
                        _plain_march, _plain_segment, _segment_done,
                        carry_width, kernel_width, launch_segment,
                        pack_segment_weights, segment_table, width_library)
from .fused_mega import TfCarries, _tf_args

# kernel launches since the last reset (the plain version never counts),
# by the latent table's type: "<kind>:<bf16|f32>"; kind is
# segment_fwd_diff (csrc/segment_fwd.cu storing carries) or segment_bwd
# (csrc/segment_bwd.cu)
LAUNCHES: collections.Counter = collections.Counter()
# the backward's launches by library (segment_bwd, or segment_bwd128 for
# the wide networks)
LIBRARY_LAUNCHES: collections.Counter = collections.Counter()


def launches(kind: str) -> int:
    """Launches of ``kind`` since the last reset, over both table types."""
    return sum(n for key, n in LAUNCHES.items()
               if key.split(":")[0] == kind)


def _table_key(kind: str, table: Tensor) -> str:
    return kind + (":bf16" if table.dtype == torch.bfloat16 else ":f32")


# ---------------------------------------------------------------------------
# the plain pair


def _plain_backward(spec: SegmentSpec, rays: Tensor, kbase: Optional[Tensor],
                    params: list, carries: Tensor, d_out: Tensor) -> list:
    """Gradients of ``params`` from the rgba cotangent: segments in
    reverse, each re-run under autograd from its stored carry for the
    rays that have a valid sample left in it."""
    leaves = [None if p is None else p.detach().requires_grad_()
              for p in params]
    grads = [None if p is None else torch.zeros_like(p) for p in params]
    used = [i for i, p in enumerate(leaves) if p is not None]
    dcarry = torch.zeros(d_out.shape[0], carries.shape[-1],
                         dtype=torch.float32, device=d_out.device)
    dcarry[:, :4] = d_out
    chunk = max(1, _PLAIN_CHUNK_SAMPLES // spec.seg)
    for s in reversed(range(carries.shape[0])):
        live = ~_segment_done(spec, rays, kbase, s)
        for idx in torch.nonzero(live).flatten().split(chunk):
            with torch.enable_grad():
                cin = carries[s, idx].detach().requires_grad_()
                cout, _ = _plain_segment(
                    spec, leaves, rays[idx],
                    kbase[idx] if kbase is not None else None, s, cin)
                g = torch.autograd.grad(
                    cout, [cin] + [leaves[i] for i in used], dcarry[idx],
                    allow_unused=True)
            dcarry[idx] = g[0]
            for i, gi in zip(used, g[1:]):
                if gi is not None:
                    grads[i] += gi
    return grads


class _PlainSegmentMarch(torch.autograd.Function):
    """The plain differentiable march: the forward stores the carries
    entering every segment, the backward re-runs the segments in reverse
    (:func:`_plain_backward`). Returns (rgba, samples, stop)."""

    @staticmethod
    def forward(ctx, rays, kbase, spec, *params):
        out, stats, carries = _plain_march(spec, list(params), rays, kbase,
                                           store=True)
        stack = (torch.stack(carries) if carries
                 else out.new_zeros(0, rays.shape[0], carry_width(spec)))
        ctx.spec = spec
        ctx.save_for_backward(rays, kbase, stack, *params)
        ctx.mark_non_differentiable(stats.samples, stats.stop)
        return out, stats.samples, stats.stop

    @staticmethod
    def backward(ctx, d_out, _d_samples, _d_stop):
        rays, kbase, carries, *params = ctx.saved_tensors
        grads = _plain_backward(ctx.spec, rays, kbase, params, carries, d_out)
        return (None, None, None, *grads)


# ---------------------------------------------------------------------------
# the CUDA kernels


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.segment_bwd_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p, p, p, i, p, i, p, p, p, p, p, p] + [i] * 11 + [f]
                   + [i] * 6 + [f] * 3 + [f] * 6 + [i] * 3 + [p] * 4)
    fn.restype = ctypes.c_int
    lib.segment_bwd_block.restype = ctypes.c_int
    return fn


def device_smem_plan(hidden: int, n_fourier: int, chunks: int,
                     n_hidden: int, tf_points: int,
                     tf_floats: Optional[int] = None,
                     tf_state: bool = False):
    """(bytes, tile rows, weight-row padding) of the shared-memory plan
    csrc/segment_bwd.cu takes for these widths (``tf_floats`` staged TF
    floats, 5 a piecewise knot by default; ``tf_state`` the TF modes'
    per-sample state), or None when none fits (the device's own
    ``choose_plan``; ``ops.sample_mlp.smem_plan`` mirrors it)."""
    lib = _build.load(width_library("segment_bwd", hidden))
    fn = lib.segment_bwd_smem
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_long * 3)()
    if fn(hidden, n_fourier, chunks, n_hidden,
          5 * tf_points if tf_floats is None else tf_floats, int(tf_state),
          out) != 0:
        return None
    return tuple(int(v) for v in out)


def launch_segment_bwd(spec: SegmentSpec, net, rays: Tensor,
                       kbase: Optional[Tensor], weights: Tensor,
                       table: Tensor, carries: Tensor, death: Tensor,
                       d_out: Tensor, tf_points: int,
                       partial_rows: bool = False,
                       n_lat: Optional[int] = None,
                       tf: Optional[Tensor] = None,
                       d_tf2d: Optional[Tensor] = None):
    """Launch csrc/segment_bwd.cu on the forward's ``carries`` (a
    ``fused_mega.TfCarries`` in the TF modes, whose table ``tf`` is), ``death``
    and the latent ``table`` (float32 or bf16). Returns (packed weight gradient
    summed over the blocks' partial rows, or with ``partial_rows`` the rows
    themselves, float32 table gradient (D, H, W, 16 * chunks), [samples
    replayed, samples contributing] int64). preint2d adds its table's gradient
    into ``d_tf2d`` (zeros like ``tf``). ``n_lat`` overrides the latent
    channels whose gradient is scattered (0: none, to time the kernel without
    its scatter)."""
    dev = rays.device
    n_rays = rays.shape[0]
    d_out = d_out.to(torch.float32).contiguous()
    dens = None
    if isinstance(carries, TfCarries):
        carries, dens = carries
    if (spec.tf_mode == "preint2d") != (d_tf2d is not None):
        raise ValueError("d_tf2d takes the gradient of a preint2d table")
    rows, *tf_args = _tf_args(spec, tf, tf_points)
    _check_tensors(dev, rays=rays, weights=weights, table=table,
                   carries=carries, death=death, d_out=d_out)
    if spec.lattice:
        _check_tensors(dev, kbase=kbase)
    if (table.dtype not in (torch.float32, torch.bfloat16)
            or d_out.shape != (n_rays, 4)):
        raise ValueError("backward: a float32 or bf16 table and an (R, 4) "
                         "cotangent")
    name = width_library("segment_bwd", kernel_width(net))
    lib = _build.load(name)
    fn = _bind_bwd(lib)
    n_blocks = -(-n_rays // lib.segment_bwd_block())
    d_rows = torch.zeros(n_blocks, weights.numel(), dtype=torch.float32,
                         device=dev)
    d_table = torch.zeros_like(table, dtype=torch.float32)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    grid = net.latent.static_grid
    gz, gy, gx = table.shape[:3]
    with torch.cuda.device(dev):
        err = fn(
            rays.data_ptr(), kbase.data_ptr() if spec.lattice else None,
            table.data_ptr(), int(table.dtype == torch.float32),
            weights.data_ptr(), weights.numel(),
            carries.data_ptr(), death.data_ptr(), d_out.data_ptr(),
            d_rows.data_ptr(), d_table.data_ptr(), work.data_ptr(), n_rays,
            gx, gy, gz, _latent_chunks(net),
            (0 if grid is None else grid.shape[0]) if n_lat is None
            else n_lat, net.input.num_fourier,
            len(net.layers) - 2, kernel_width(net), rows,
            _ACTIVATIONS[spec.activation[0]], spec.activation[1],
            _HEADS[spec.output_mode], int(net.use_direction),
            int(spec.lattice), int(spec.blend_alpha), spec.seg, spec.n_seg,
            spec.stepsize, spec.density_min,
            1.0 / (spec.density_max - spec.density_min), *spec.box_min,
            *spec.box_size, *tf_args,
            d_tf2d.data_ptr() if d_tf2d is not None else None,
            dens.data_ptr() if dens is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_bwd launch failed with CUDA error {err}")
    LIBRARY_LAUNCHES[name] += 1
    return (d_rows if partial_rows else d_rows.sum(dim=0)), d_table, work


def unpack_segment_grads(dw: Tensor, net, params: list,
                         d_tf2d: Optional[Tensor] = None) -> list:
    """Per-parameter gradients, in ``params``' order (TF, Fourier matrix,
    latent grid (None: the table gradient comes apart), each layer's
    weight and bias), from the packed gradient ``dw`` (the layout of
    :func:`ops.fused_dvr.pack_segment_weights`; the preint2d table's is
    ``d_tf2d``). What lies in the zero
    padding up to the kernel width (and in the direction rows of a
    network without direction input) is dropped."""
    hp = kernel_width(net)
    nf = net.input.num_fourier
    n_hidden = len(net.layers) - 2
    k1 = 6 + 2 * nf + 16 * _latent_chunks(net)
    tf = params[0]
    sizes = [k1 * hp, hp, n_hidden * hp * hp, n_hidden * hp, 4 * hp, 4,
             3 * nf, 3 * nf, 0 if d_tf2d is not None else tf.numel()]
    w1, b1, wh, bh, wo, bo, fb, fbd, dtf = dw.split(sizes)
    w1 = w1.reshape(k1, hp)
    wh = wh.reshape(n_hidden, hp, hp)
    bh = bh.reshape(n_hidden, hp)
    width = net.layers[0].weight.shape[0]
    n_in = net.input.num_input_channels()
    n_lat = net.layers[0].weight.shape[1] - n_in - 2 * nf
    d_layers = [torch.cat([w1[:n_in, :width], w1[6:6 + 2 * nf, :width],
                           w1[6 + 2 * nf:6 + 2 * nf + n_lat, :width]]).T,
                b1[:width]]
    for i in range(n_hidden):
        d_layers += [wh[i, :width, :width].T, bh[i, :width]]
    n_out = net.layers[-1].weight.shape[0]
    d_layers += [wo.reshape(4, hp)[:n_out, :width], bo[:n_out]]
    fm = params[1]
    d_fm = fb.reshape(nf, 3)
    if fm.shape[1] == 6:
        d_fm = torch.cat([d_fm, fbd.reshape(nf, 3)], dim=1)
    d_tf = (d_tf2d if d_tf2d is not None else dtf).reshape(tf.shape)
    return [d_tf, d_fm, None] + d_layers


class _SegmentKernelMarch(torch.autograd.Function):
    """The differentiable march on the card: the forward launches
    csrc/segment_fwd.cu storing the carries, the backward
    csrc/segment_bwd.cu, both on the latent table of ``table_dtype``.
    Returns (rgba, samples, stop)."""

    @staticmethod
    def forward(ctx, rays, kbase, spec, net, table_dtype, *params):
        tf = params[0]
        tfk = (tf.detach().contiguous() if spec.tf_mode != "piecewise"
               else None)
        weights = pack_segment_weights(net, tf, spec.tf_mode)
        table = segment_table(net, table_dtype, rays.device)
        out, stats, carries, death = launch_segment(
            spec, net, rays, kbase, weights, table, tf.shape[0],
            store_carries=True, tf=tfk)
        LAUNCHES[_table_key("segment_fwd_diff", table)] += 1
        ctx.spec = spec
        ctx.net = net
        dens = None
        if isinstance(carries, TfCarries):
            carries, dens = carries
        ctx.save_for_backward(rays, kbase, weights, table, carries, dens,
                              tfk, death, *params)
        ctx.mark_non_differentiable(stats.samples, stats.stop)
        return out, stats.samples, stats.stop

    @staticmethod
    def backward(ctx, d_out, _d_samples, _d_stop):
        rays, kbase, weights, table, carries, dens, tfk, death, *params = \
            ctx.saved_tensors
        net = ctx.net
        if dens is not None:
            carries = TfCarries(carries, dens)
        d_tf2d = (torch.zeros_like(tfk) if ctx.spec.tf_mode == "preint2d"
                  else None)
        dw, d_table, _ = launch_segment_bwd(
            ctx.spec, net, rays, kbase, weights, table, carries, death,
            d_out, params[0].shape[0], tf=tfk, d_tf2d=d_tf2d)
        LAUNCHES[_table_key("segment_bwd", table)] += 1
        grads = unpack_segment_grads(dw, net, params, d_tf2d)
        if params[2] is not None:
            c = params[2].shape[0]
            grads[2] = d_table[..., :c].permute(3, 0, 1, 2).contiguous()
        return (None, None, None, None, None, *grads)
