"""The fused SRN sample evaluator: density (and its position gradient) at
arbitrary positions.

Counterpart of ``fvsrn_tpu/ops/fused_eval.py`` (the TPU kernel
``_eval_kernel``): the evaluator of scattered positions that are not the
points of a ray march, such as Monte-Carlo delta tracking's tentative
collisions (``raytracer.montecarlo.make_mc_sampler``). On CUDA tensors
:func:`make_fused_eval`'s callable launches ``csrc/sample_eval.cu``, one
launch per call; on CPU tensors it runs :func:`fused_eval_plain`. On a
CUDA tensor it never falls back to the plain version.

The kernel's value instance evaluates a warp's 32 consecutive positions
as one tile of the forward marches' warp-owned layer
(``csrc/warp_mlp.cuh``: TF32 three-pass tensor-core layers) on a
persistent grid; its shared-memory plan is :func:`eval_plan` and its grid
``ops.sample_mlp.persistent_blocks``. The gradient instance keeps one
thread a position on the CUDA cores.

What it computes: ``VolumeInterpolationNetwork.eval_density`` of a density
network in screen mode (the output clamp), every hidden layer with layer
0's activation as the JAX kernel evaluates it (the network of the
per-segment engine), a latent grid of <= 16 channels read rounded to
``table_dtype``; with ``want_grad`` also the gradient of the density with
respect to the world position (the clip's gradient gated strictly: a
clipped density has none). The inside mask is computed in PyTorch from
the normalized position, as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from ..utils.device import strict_f32
from . import _build
from .fused_dvr import (_ACTIVATIONS, _HEADS, _check_kernel_inputs,
                        _check_tensors, _latent_chunks, _network_values,
                        kernel_width, network_position_grad,
                        pack_segment_weights, resolve_network, segment_params,
                        segment_table)

# kernel launches and positions evaluated by them since the last reset, and
# the launches of the gradient instance among them; the plain version
# never counts
SAMPLE_EVAL_LAUNCHES = 0
SAMPLE_EVAL_POSITIONS = 0
SAMPLE_GRAD_LAUNCHES = 0

# the kernel's packed weights carry a TF block; the evaluator reads none
_NO_TF = ((0.0, 0.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0, 1.0))


def _resolved(net, table_dtype, time=0.0, ensemble=0.0):
    """The network at (time, ensemble) as the evaluator reads it
    (``ops.fused_dvr.resolve_network``), after what the JAX package's
    evaluator refuses, with its exception types: outputs that are not a
    density, time inputs (``extract_weights``'s assertions) and more than
    16 latent channels (the neighborhood table's assertion)."""
    if not net.output_mode.startswith("density"):
        raise NotImplementedError("fused sample evaluator: density "
                                  "networks (MC tracks scalar density)")
    net = resolve_network(net, time, ensemble)
    grid = net.latent.static_grid
    if grid is not None and grid.shape[0] > 16:
        raise AssertionError("neighborhood table supports <= 16 latent "
                             "channels")
    if table_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table_dtype {table_dtype}: float32 or bfloat16")
    if len(net.layers) < 2:
        raise ValueError("fused sample evaluator: the network needs a "
                         "hidden layer")
    return net


def fused_eval_plain(net, pos01: Tensor, dirs: Optional[Tensor] = None, *,
                     want_grad: bool = False,
                     table_dtype: torch.dtype = torch.float32,
                     time=0.0, ensemble=0.0):
    """Plain PyTorch version of the kernel: (value (N,), d value / d pos01
    (N, 3) or None) at ``pos01`` (N, 3); ``dirs`` (N, 3) or None (a zero
    direction). The network is the per-segment engine's plain one (its
    clips and ReLU gated strictly) at (``time``, ``ensemble``); the
    gradient is autograd's with respect to the position."""
    strict_f32()
    net = resolve_network(net, time, ensemble)
    params = segment_params(net, torch.tensor(_NO_TF, device=pos01.device),
                            table_dtype)
    if dirs is None:
        dirs = torch.zeros_like(pos01)
    kw = dict(direction=net.use_direction,
              activation=(net.layers[0].activation,
                          net.layers[0].activation_param),
              output_mode=net.output_mode)
    if want_grad:
        return network_position_grad(params, pos01, dirs, **kw)
    with torch.no_grad():
        return _network_values(params, pos01, dirs, **kw)[:, 0], None


def eval_plan(hidden: int, n_fourier: int, chunks: int, n_hidden: int,
              direction: bool = False):
    """The value instance's shared-memory plan (``ops.sample_mlp``'s
    forward plan with no TF points); raises ``NotImplementedError`` when
    none fits."""
    from .sample_mlp import check_fwd_plan
    return check_fwd_plan("sample evaluator", hidden, n_fourier, chunks,
                          n_hidden, 0, direction=direction)


def device_eval_grid(n: int, hidden: int, n_fourier: int, chunks: int,
                     n_hidden: int, direction: bool = False):
    """(plan bytes, warps a block, matrices pre-split, blocks, SMs) of the
    value instance's launch over ``n`` positions on the current device
    (csrc/sample_eval.cu's own plan and persistent grid), or None when no
    plan fits."""
    fn = _build.load("sample_eval").sample_eval_grid
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_long * 5)()
    if fn(n, hidden, n_fourier, chunks, n_hidden, int(direction), out) != 0:
        return None
    return (int(out[0]), int(out[1]), bool(out[2]), int(out[3]),
            int(out[4]))


_LAUNCH = []   # the bound entry point, typed once


def _bound():
    if not _LAUNCH:
        fn = _build.load("sample_eval").sample_eval_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i, p, i, p] + [i] * 9 + [f, i, i, i, p]
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def launch_sample_eval(net, pos01: Tensor, dirs: Optional[Tensor],
                       weights: Tensor, table: Tensor,
                       want_grad: bool) -> Tensor:
    """Launch csrc/sample_eval.cu on ``pos01`` (N, 3): (N,) values, or
    with ``want_grad`` (N, 4) [value, d value / d pos01]."""
    global SAMPLE_EVAL_LAUNCHES, SAMPLE_EVAL_POSITIONS, SAMPLE_GRAD_LAUNCHES
    dev = pos01.device
    n = pos01.shape[0]
    out = torch.empty((n, 4) if want_grad else (n,), dtype=torch.float32,
                      device=dev)
    _check_tensors(dev, pos01=pos01, weights=weights, table=table, out=out)
    if dirs is not None:
        _check_tensors(dev, dirs=dirs)
    gz, gy, gx = table.shape[:3]
    fn = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pos01.data_ptr(), dirs.data_ptr() if dirs is not None
                 else None, table.data_ptr(),
                 int(table.dtype == torch.float32), weights.data_ptr(),
                 weights.numel(), out.data_ptr(), n, gx, gy, gz,
                 _latent_chunks(net), net.input.num_fourier,
                 len(net.layers) - 2, kernel_width(net),
                 _ACTIVATIONS[net.layers[0].activation],
                 net.layers[0].activation_param, _HEADS[net.output_mode],
                 int(net.use_direction), int(want_grad), stream)
    if err != 0:
        raise RuntimeError(f"sample_eval launch failed with CUDA error {err}")
    SAMPLE_EVAL_LAUNCHES += 1
    SAMPLE_EVAL_POSITIONS += n
    SAMPLE_GRAD_LAUNCHES += int(want_grad)
    return out


def make_fused_eval(net, box_min, box_size, *, time=0.0, ensemble=0.0,
                    tile: int = 2048, compute_dtype=torch.float32,
                    table_dtype: torch.dtype = torch.float32,
                    want_grad: bool = False, interpret: bool = False):
    """Build ``evaluate(position (..., 3), direction (..., 3) | None) ->
    (value (...,), inside (...,)[, grad (..., 3) wrt the world
    position])``, the network's density in screen mode (see the module
    doc). A network on a CUDA device is packed for the kernel now (its
    weights and table are a snapshot); positions on that device launch it,
    positions on the CPU run the plain version with the network as it is.

    ``time``/``ensemble`` select the latent conditioning (keyframed
    grids lerped, latent vectors folded into layer 0's bias:
    ``ops.fused_dvr.resolve_network``); a static grid does not depend on
    them. ``tile`` and ``compute_dtype`` are the TPU kernel's schedule
    (its block of positions and its matmul precision): accepted and
    ignored, as is ``interpret`` (Pallas interpret mode). The kernel
    evaluates every position, with no padding to a tile."""
    del tile, compute_dtype, interpret
    net_dev = next(net.parameters()).device
    with torch.no_grad():
        view = _resolved(net, table_dtype, time, ensemble)
    bm = np.asarray(box_min, np.float32)
    bs = np.asarray(box_size, np.float32)
    packed = None
    if net_dev.type == "cuda":
        # the segment kernel's checks; its plan (two TF points) fitting,
        # the evaluator's (eval_plan, none) fits
        _check_kernel_inputs(view, torch.tensor(_NO_TF))
        packed = (pack_segment_weights(view, torch.tensor(_NO_TF,
                                                          device=net_dev)),
                  segment_table(view, table_dtype, net_dev),
                  torch.as_tensor(bm, device=net_dev),
                  torch.as_tensor(bs, device=net_dev))
    cpu_box = (torch.as_tensor(bm), torch.as_tensor(bs))

    def evaluate(position: Tensor, direction: Optional[Tensor] = None):
        dev = position.device
        lead = position.shape[:-1]
        if dev.type == "cuda":
            if packed is None or dev != net_dev:
                raise ValueError(f"positions on {dev}, network on {net_dev}")
            bm_t, bs_t = packed[2], packed[3]
        elif dev.type == "cpu":
            bm_t, bs_t = cpu_box
        else:
            raise ValueError(f"unsupported device {dev}")
        pos = position.reshape(-1, 3).to(torch.float32)
        pos01 = ((pos - bm_t) / bs_t).contiguous()
        inside = (pos01 >= 0).all(dim=-1) & (pos01 <= 1).all(dim=-1)
        dirs = None
        if view.use_direction and direction is not None:
            dirs = direction.expand(position.shape).reshape(-1, 3).to(
                torch.float32).contiguous()
        if dev.type == "cuda":
            out = launch_sample_eval(view, pos01, dirs, packed[0],
                                     packed[1], want_grad)
            value, grad01 = ((out[:, 0], out[:, 1:4]) if want_grad
                             else (out, None))
        else:
            value, grad01 = fused_eval_plain(net, pos01, dirs,
                                             want_grad=want_grad,
                                             table_dtype=table_dtype,
                                             time=time, ensemble=ensemble)
        value = value.reshape(lead)
        inside = inside.reshape(lead)
        if want_grad:
            return value, inside, (grad01 / bs_t).reshape(lead + (3,))
        return value, inside

    return evaluate
