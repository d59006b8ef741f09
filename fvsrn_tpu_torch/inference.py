"""Load a trained SRN, render it, time the renders.

Counterpart of ``fvsrn_tpu/inference.py``. Modes:

- ``FUSED`` and ``FUSED_BF16`` (the same render for DVR): bf16 latent
  table, float32 math, routed as the JAX package routes them:
  1. a latent grid that fits the JAX megakernel's slab
     (``ops.fused_dvr.mega_supported``) at W and H multiples of 16: rays
     in 16x16 pixel blocks, the camera-static saturation probe clamps
     each ray's march (density networks), the megakernel
     (``ops.fused_mega.mega_trace_dvr``); where the TF has a zero-opacity
     band, (tile, segment) programs in transparent space are culled by an
     occupancy mask built from the kernel's own tile geometry
     (``ops.occupancy.kernel_segment_occupancy``);
  1b. any other grid of <= 16 channels at those sizes: the same blocks
     and clip, march-length buckets of ray tiles
     (``ops.fused_dvr.plan_ray_buckets``), each marched by the
     per-segment engine on the lattice (``fused_trace_dvr_bucketed``);
  2. no grid, more than 16 channels, or W or H not a multiple of 16:
     the per-segment engine with per-ray sampling on 128-ray tiles, the
     rays padded with start (0, 0, 0) and direction (1, 1, 1), no clip.
  The kernels run on the card, their plain versions on the CPU.
- ``PLAIN32``: the plain float32 march (``raytracer.dvr.trace_dvr``);
  ``PLAIN16`` the same with every weight rounded through bf16.

``render_reference`` renders the ground-truth volume the model was
trained on (a voxel grid or an implicit field) by the plain
``raytracer.dvr.trace_dvr``.

``compare_modes`` tabulates each mode's mean squared difference from
the first mode's frame.

``render_network_iso`` renders an isosurface: FUSED (float32 table) and
FUSED_BF16 (bf16 table) on the per-segment engine
(``ops.fused_dvr.fused_trace_iso``), any other mode by the plain
``raytracer.iso.trace_iso``.

Everything runs on ``device``, "cuda" unless the caller asks for the
CPU; a CUDA request without a card raises.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .camera import CameraOnASphere, camera_matrix, generate_rays
from .models.latent import resolve_grid
from .models.network_volume import VolumeInterpolationNetwork
from .models.srn import SceneRepresentationNetwork
from .ops.fused_dvr import (block_ray_permutation, fused_tf_args,
                            fused_trace_dvr, fused_trace_dvr_bucketed,
                            fused_trace_iso, mega_supported,
                            plan_ray_buckets, probe_saturation_tmax,
                            tf_mode_of)
from .ops.fused_mega import mega_trace_dvr
from .ops.occupancy import build_occupancy, kernel_segment_occupancy
from .raytracer.dvr import RayEvaluationSteppingDvr, max_steps_bound, trace_dvr
from .raytracer.iso import RayEvaluationSteppingIso, trace_iso
from .train.checkpoints import load_weights
from .transfer import TransferFunctionPiecewiseLinear
from .utils.device import resolve_device

EVAL_MODES = ("FUSED", "FUSED_BF16", "PLAIN32", "PLAIN16")

# the fused routes' fixed choices (fvsrn_tpu/inference.py)
BLOCK = 16
SEG = 32
TILE = BLOCK * BLOCK
SEGMENT_TILE = 128
N_BUCKETS = 6
QUANTIZE = 128
# occupancy culling (fvsrn_tpu/inference.py:_occupancy_grid): a grid is
# built only when more than ZERO_BAND_SHARE of the TF's samples fall below
# ALPHA_SKIP; 128^3 macrocells, 2 density samples per cell axis
ALPHA_SKIP = 1e-5
ZERO_BAND_SHARE = 0.02
OCCUPANCY_RESOLUTION = 128
OCCUPANCY_FINE = 2


def fused_render_tf(tf) -> dict:
    """The march's TF kwargs of a FUSED render of ``tf``, routed as the JAX
    package routes its product render (fvsrn_tpu/inference.py:251-261):
    the piecewise TF, and the texture TF by its preintegration (texture,
    preint1d, preint2d) on every route. Any other TF raises
    ``NotImplementedError``: the JAX render passes a Gaussian's (G, 6)
    tensor to its kernels as piecewise knots, an image that is not the
    TF's (ROADMAP, differs on purpose)."""
    mode = tf_mode_of(tf)
    if mode not in ("piecewise", "texture", "preint1d", "preint2d"):
        raise NotImplementedError(f"FUSED render: TF mode {mode!r} does "
                                  "not render fused (PLAIN32 renders it)")
    return fused_tf_args(tf)[1]


class FusedRender:
    """A prepared FUSED render of one camera on route 1 (the megakernel):
    block-ordered rays, their saturation clip, the occupancy mask (or
    None) and the device copies of network and TF. Calling it renders one
    (H, W, 4) frame."""
    route = "mega"

    def __init__(self, ray_start: Tensor, ray_dir: Tensor, inv: Tensor,
                 tmax_clip: Tensor, network, tf, box_min,
                 box_size, width: int, height: int, march_kwargs: dict,
                 segment_active: Optional[Tensor] = None):
        self.ray_start = ray_start
        self.ray_dir = ray_dir
        self.inv = inv
        self.tmax_clip = tmax_clip
        self.network = network
        self.tf = tf
        self.box_min = box_min
        self.box_size = box_size
        self.width = width
        self.height = height
        self.march_kwargs = march_kwargs
        self.segment_active = segment_active

    def march(self, fn=mega_trace_dvr, **overrides):
        """``fn`` (the kernel's wrapper or its plain version) on this
        frame's block-ordered rays, with its clip and occupancy mask;
        returns its raw output."""
        kw = dict(self.march_kwargs, tmax_clip=self.tmax_clip,
                  segment_active=self.segment_active, **overrides)
        return fn(self.ray_start, self.ray_dir, self.network, self.box_min,
                  self.box_size, self.tf.tensor, **kw)

    def __call__(self) -> Tensor:
        """One frame, back in row-major order: (H, W, 4)."""
        return self.march()[self.inv].reshape(self.height, self.width, 4)


class BucketedRender(FusedRender):
    """Route 1b: the megakernel's block-ordered rays and clip, marched by
    the per-segment engine on the lattice once per bucket of ``plan``
    (which carries the clip in its own order). ``march(fn)`` takes
    :func:`fused_trace_dvr` or its plain version."""
    route = "bucketed"

    def __init__(self, *args, plan=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.plan = plan

    def march(self, fn=fused_trace_dvr, **overrides):
        kw = dict(self.march_kwargs, **overrides)
        return fused_trace_dvr_bucketed(
            self.ray_start, self.ray_dir, self.network, self.box_min,
            self.box_size, self.tf.tensor, plan=self.plan, engine="scan",
            march=fn, **kw)


class SegmentRender:
    """Route 2: row-major rays padded to whole 128-ray tiles, marched by
    the per-segment engine with per-ray sampling and no clip. Calling it
    renders one (H, W, 4) frame."""
    route = "segment"

    def __init__(self, ray_start: Tensor, ray_dir: Tensor, pad: int,
                 network, tf, box_min, box_size, width: int, height: int,
                 march_kwargs: dict):
        self.ray_start = ray_start
        self.ray_dir = ray_dir
        self.pad = pad
        self.network = network
        self.tf = tf
        self.box_min = box_min
        self.box_size = box_size
        self.width = width
        self.height = height
        self.march_kwargs = march_kwargs

    def march(self, fn=fused_trace_dvr, **overrides):
        """``fn`` on this frame's padded rays; returns its raw output."""
        kw = dict(self.march_kwargs, **overrides)
        return fn(self.ray_start, self.ray_dir, self.network, self.box_min,
                  self.box_size, self.tf.tensor, **kw)

    def __call__(self) -> Tensor:
        out = self.march()
        n = out.shape[0] - self.pad
        return out[:n].reshape(self.height, self.width, 4)


def pad_rays(rs: Tensor, rd: Tensor, tile: int):
    """Rays padded to a multiple of ``tile`` as the JAX package pads them:
    start (0, 0, 0), direction (1, 1, 1). Padding rays march like any
    other ray (and may set the call's stop). Returns (rs, rd, pad)."""
    pad = (-rs.shape[0]) % tile
    if pad:
        rs = torch.cat([rs, rs.new_zeros(pad, 3)], dim=0)
        rd = torch.cat([rd, rd.new_ones(pad, 3)], dim=0)
    return rs.contiguous(), rd.contiguous(), pad


def round_bf16(net):
    """A copy of ``net`` with every weight rounded through bf16 (the
    PLAIN16 mode)."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(torch.bfloat16).to(p.dtype))
    return out


class LoadedModel:
    """A trained SRN with its TF, stepping configuration and box, and
    optionally the ground-truth volume it was trained on
    (``reference_volume``, rendered by :meth:`render_reference`)."""

    def __init__(self, network: SceneRepresentationNetwork, tf,
                 config: Optional[RayEvaluationSteppingDvr] = None,
                 reference_volume=None,
                 box_min=(-0.5, -0.5, -0.5), box_size=(1.0, 1.0, 1.0)):
        self.network = network
        self.tf = tf
        self.config = config or RayEvaluationSteppingDvr.make(
            stepsize=1 / 256)
        self.reference_volume = reference_volume
        self.box_min = tuple(float(v) for v in box_min)
        self.box_size = tuple(float(v) for v in box_size)

    @classmethod
    def from_checkpoint(cls, path: str, tf=None,
                        config: Optional[RayEvaluationSteppingDvr] = None,
                        reference_volume=None) -> "LoadedModel":
        """From the ``.npz`` weights export of a run file."""
        if tf is None:
            tf = TransferFunctionPiecewiseLinear.make(
                rgb=[[1.0, 1.0, 1.0]] * 2, opacity=[0.0, 50.0],
                positions=[0.0, 1.0])
        return cls(load_weights(path), tf, config=config,
                   reference_volume=reference_volume)

    @classmethod
    def from_volnet(cls, path: str, tf=None,
                    config: Optional[RayEvaluationSteppingDvr] = None
                    ) -> "LoadedModel":
        """From a ``.volnet`` file (``models.export.load_volnet``), with
        the box it stores."""
        from .models.export import load_volnet
        net, box_min, box_size = load_volnet(path)
        if tf is None:
            tf = TransferFunctionPiecewiseLinear.make(
                rgb=[[1.0, 1.0, 1.0]] * 2, opacity=[0.0, 50.0],
                positions=[0.0, 1.0])
        return cls(net, tf, config=config, box_min=box_min,
                   box_size=box_size)

    def save_volnet(self, path: str, grid_encoding: int = 0):
        """Write the network and box as a ``.volnet`` file
        (``models.export.save_volnet``; ``grid_encoding`` 0 float, 1 byte
        linear, 2 byte Gaussian)."""
        from .models.export import save_volnet
        save_volnet(self.network, path, box_min=self.box_min,
                    box_size=self.box_size, grid_encoding=grid_encoding)

    @staticmethod
    def rotation_cameras(num: int, distance: float = 1.6,
                         pitch: float = 0.3) -> list[CameraOnASphere]:
        return [CameraOnASphere.make(pitch=pitch, yaw=2 * np.pi * i / num,
                                     distance=distance)
                for i in range(num)]

    def render_reference(self, camera: CameraOnASphere, width: int,
                         height: int, *, device="cuda") -> Tensor:
        """The ground-truth volume rendered by the plain ``trace_dvr``
        with this model's TF and configuration: (H, W, 4)."""
        if self.reference_volume is None:
            raise ValueError("no reference volume attached")
        return self._render_volume(self.reference_volume, camera, width,
                                   height, device=device)

    @torch.no_grad()
    def _render_volume(self, volume, camera: CameraOnASphere, width: int,
                       height: int, *, device="cuda") -> Tensor:
        """``volume`` by the plain ``trace_dvr`` at ``config.stepsize``,
        stepping over its box's diagonal: (H, W, 4)."""
        dev = resolve_device(device)
        volume = volume.to(dev)
        steps = max_steps_bound(volume.box_size.tolist(),
                                float(self.config.stepsize))
        rs, rd = generate_rays(camera_matrix(camera), width, height,
                               camera.fov_y_radians, device=dev)
        out = trace_dvr(rs.reshape(-1, 3), rd.reshape(-1, 3), volume,
                        self.tf.to(dev), self.config, steps)
        return out.color.reshape(height, width, 4)

    def _occupancy_grid(self, stepsize: float, alpha_skip: float = ALPHA_SKIP,
                        *, device="cuda"):
        """The TF-occupancy macrocell grid of ``ops.occupancy`` for
        culling, cached per stepsize, ``alpha_skip`` and TF. None when the
        TF has no real zero band (at most ZERO_BAND_SHARE of 1025 TF
        samples below ``alpha_skip``): a ramp-from-zero TF leaves nothing
        to cull, and the probe spares the bounding pass."""
        key = (round(stepsize, 9), alpha_skip,
               hash(self.tf.tensor.detach().cpu().numpy().tobytes()))
        cache = self.__dict__.setdefault("_occ_cache", {})
        if key in cache:
            return cache[key]
        dev = resolve_device(device)
        tf = self.tf.to(dev)
        n = 1025
        op = tf.eval_normalized(torch.linspace(0.0, 1.0, n, device=dev),
                                torch.zeros(n, 3, device=dev),
                                torch.full((n,), -1.0, device=dev), 1.0)[:, 3]
        occ = None
        if float((op * stepsize < alpha_skip).float().mean()) > \
                ZERO_BAND_SHARE:
            net = copy.deepcopy(self.network).to(dev).eval()
            occ = build_occupancy(
                VolumeInterpolationNetwork(net, self.box_min, self.box_size),
                tf, resolution=OCCUPANCY_RESOLUTION, fine=OCCUPANCY_FINE,
                stepsize=stepsize, alpha_skip=alpha_skip,
                density_min=float(self.config.density_min),
                density_max=float(self.config.density_max))
        cache[key] = occ
        return occ

    def prepare_network_render(self, camera: CameraOnASphere, width: int,
                               height: int, mode: str = "FUSED", *,
                               saturation_clip: bool = True,
                               occupancy_culling: bool = True,
                               table_dtype: Optional[torch.dtype] = None,
                               device="cuda"):
        """A zero-argument callable rendering (H, W, 4), with the
        per-camera planning (rays, block order, saturation probe, bucket
        plan, occupancy mask) done here; a FUSED render tells its route by
        ``.route``. ``saturation_clip``: clamp each ray's march at the
        probe's saturation depth (density networks, routes 1 and 1b).
        ``occupancy_culling``: on route 1 with a density network, cull the
        (tile, segment) programs in transparent space when the TF has a
        zero band (image within ~max_steps * ALPHA_SKIP). ``table_dtype``:
        the latent table's type, bf16 by default. A network with
        keyframed grids or latent vectors renders at time 0, ensemble 0,
        as in the JAX package; its route is chosen by the resolved grid.
        Snapshot semantics: the network and TF are copied to ``device``
        now; later changes to the model do not reach it."""
        if mode not in EVAL_MODES:
            raise ValueError(f"mode must be one of {EVAL_MODES}")
        dev = resolve_device(device)
        net = copy.deepcopy(self.network).to(dev).eval()
        tf = self.tf.to(dev)
        stepsize = float(self.config.stepsize)
        steps = max_steps_bound(self.box_size, stepsize)
        rs, rd = generate_rays(camera_matrix(camera), width, height,
                               camera.fov_y_radians, device=dev)
        rs = rs.reshape(-1, 3).contiguous()
        rd = rd.reshape(-1, 3).contiguous()
        if not mode.startswith("FUSED"):
            if mode == "PLAIN16":
                net = round_bf16(net)
            vol = VolumeInterpolationNetwork(net, self.box_min,
                                             self.box_size)

            @torch.no_grad()
            def render_plain():
                color = trace_dvr(rs, rd, vol, tf, self.config, steps).color
                return color.reshape(height, width, 4)
            return render_plain

        tf_kw = fused_render_tf(tf)
        table_dtype = table_dtype if table_dtype is not None \
            else torch.bfloat16
        kw = dict(tf_kw, stepsize=stepsize, seg=SEG, table_dtype=table_dtype,
                  density_min=float(self.config.density_min),
                  density_max=float(self.config.density_max))
        with torch.no_grad():   # the route's grid, at time 0, ensemble 0
            grid = resolve_grid(net.latent)
        if (grid is None or grid.shape[0] > 16 or width % BLOCK
                or height % BLOCK):
            # route 2
            rs, rd, pad = pad_rays(rs, rd, SEGMENT_TILE)
            return SegmentRender(rs, rd, pad, net, tf, self.box_min,
                                 self.box_size, width, height,
                                 dict(kw, max_steps=steps, tile=SEGMENT_TILE))
        perm, inv = block_ray_permutation(width, height, BLOCK, BLOCK,
                                          device=dev)
        rs, rd = rs[perm].contiguous(), rd[perm].contiguous()
        density = (net.output_mode.startswith("density")
                   and hasattr(tf, "eval_normalized"))
        clip = None
        if saturation_clip and density:
            vol = VolumeInterpolationNetwork(net, self.box_min,
                                             self.box_size)
            clip = probe_saturation_tmax(rs, rd, vol, tf, stepsize=stepsize,
                                         max_steps=steps, coarse=8,
                                         margin_steps=16)
        if mega_supported(tuple(grid.shape), table_dtype):
            # route 1
            mask = None
            occ = (self._occupancy_grid(stepsize, device=dev)
                   if occupancy_culling and density else None)
            if occ is not None:
                mask = kernel_segment_occupancy(
                    rs, rd, occ, self.box_min, self.box_size,
                    stepsize=stepsize, seg=SEG, tile=TILE, tmax_clip=clip)
            return FusedRender(rs, rd, inv, clip, net, tf, self.box_min,
                               self.box_size, width, height,
                               dict(kw, tile=TILE), segment_active=mask)
        # route 1b
        c, gd, gh, gw = grid.shape
        plan = plan_ray_buckets(
            rs.cpu().numpy(), rd.cpu().numpy(), self.box_min, self.box_size,
            stepsize=stepsize, seg=SEG, tile=TILE, n_buckets=N_BUCKETS,
            grid_sizes=(gw, gh, gd), quantize=QUANTIZE,
            tmax_clip=clip.cpu().numpy() if clip is not None else None)
        return BucketedRender(rs, rd, inv, clip, net, tf, self.box_min,
                              self.box_size, width, height,
                              dict(kw, tile=TILE, latent_mode="boxfeat"),
                              plan=plan)

    def render_network(self, camera: CameraOnASphere, width: int,
                       height: int, mode: str = "FUSED", *, device="cuda",
                       **plan_kwargs) -> Tensor:
        """One frame; ``plan_kwargs`` go to :meth:`prepare_network_render`
        (``saturation_clip``, ``occupancy_culling``, ``table_dtype``)."""
        return self.prepare_network_render(camera, width, height, mode,
                                           device=device, **plan_kwargs)()

    def render_network_iso(self, camera: CameraOnASphere, width: int,
                           height: int, iso_config: RayEvaluationSteppingIso,
                           mode: str = "FUSED", *, device="cuda",
                           return_stats: bool = False):
        """Isosurface render, (H, W, 4): FUSED (float32 latent table) and
        FUSED_BF16 (bf16 table) march on the per-segment engine over
        128-ray tiles of padded rays, then bisect and shade per ray;
        other modes by the plain ``trace_iso``. With ``return_stats``
        (FUSED modes) also the march's ``SegmentStats``."""
        if mode not in EVAL_MODES:
            raise ValueError(f"mode must be one of {EVAL_MODES}")
        dev = resolve_device(device)
        net = copy.deepcopy(self.network).to(dev).eval()
        steps = max_steps_bound(self.box_size, float(iso_config.stepsize))
        rs, rd = generate_rays(camera_matrix(camera), width, height,
                               camera.fov_y_radians, device=dev)
        rs = rs.reshape(-1, 3)
        rd = rd.reshape(-1, 3)
        if not mode.startswith("FUSED"):
            vol = VolumeInterpolationNetwork(net, self.box_min,
                                             self.box_size)
            color = trace_iso(rs, rd, vol, iso_config, steps).color
            return color.reshape(height, width, 4)
        rs, rd, pad = pad_rays(rs, rd, SEGMENT_TILE)
        out, stats = fused_trace_iso(
            rs, rd, net, self.box_min, self.box_size, iso_config,
            max_steps=steps, tile=SEGMENT_TILE,
            table_dtype=(torch.bfloat16 if mode == "FUSED_BF16"
                         else torch.float32), return_stats=True)
        color = out.color[:out.color.shape[0] - pad].reshape(height, width,
                                                            4)
        return (color, stats) if return_stats else color

    def time_rendering(self, cameras, width: int = 512, height: int = 512,
                       mode: str = "FUSED", repeats: int = 4, *,
                       device="cuda"):
        """Frame times on the card, timed with CUDA events: per camera,
        ``repeats`` frames back to back and one scalar reduction of the
        last; the first camera is warm-up and discarded. Planning happens
        before the loop. Returns (mean_ms, std_ms, per_frame_ms)."""
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError("time_rendering times the card; it needs a "
                               "CUDA device")
        fns = [self.prepare_network_render(c, width, height, mode,
                                           device=dev) for c in cameras]
        for fn in fns:
            fn().mean().item()
        times = []
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                out = fn()
            total = out.mean()
            end.record()
            total.item()
            if i > 0:
                times.append(start.elapsed_time(end) / max(1, repeats))
        arr = np.asarray(times if times else [0.0])
        return float(arr.mean()), float(arr.std()), arr


def compare_modes(model: LoadedModel, camera: CameraOnASphere,
                  width: int = 64, height: int = 64,
                  modes=("FUSED", "PLAIN32"), *, device="cuda") -> dict:
    """The mean squared difference of each mode's frame
    (:meth:`LoadedModel.render_network`) from the first mode's:
    {mode: MSE}, the first mode's 0."""
    images = {m: model.render_network(camera, width, height, m,
                                      device=device).double()
              for m in modes}
    base = images[modes[0]]
    return {m: float(torch.mean((images[m] - base) ** 2)) for m in modes}
