"""Load a trained SRN, render it, time the renders.

Counterpart of ``fvsrn_tpu/inference.py``. Modes:

- ``FUSED``: the product render. Rays in 16x16 pixel blocks, the
  camera-static saturation probe clamps each ray's march, and the fused
  march (``ops.fused_mega.mega_trace_dvr``) runs with a bf16 latent table
  and float32 math: the CUDA kernel on the card, its plain version on the
  CPU.
- ``PLAIN32``: the plain float32 march (``raytracer.dvr.trace_dvr``).

``FUSED_BF16`` and ``PLAIN16`` are not ported yet, nor is the fused
engine for image sizes that are not multiples of 16.

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
from .models.network_volume import VolumeInterpolationNetwork
from .models.srn import SceneRepresentationNetwork
from .ops.fused_dvr import block_ray_permutation, probe_saturation_tmax
from .ops.fused_mega import mega_trace_dvr
from .raytracer.dvr import RayEvaluationSteppingDvr, max_steps_bound, trace_dvr
from .train.checkpoints import load_weights
from .transfer import TransferFunctionPiecewiseLinear
from .utils.device import resolve_device

EVAL_MODES = ("FUSED", "PLAIN32")
_NOT_PORTED = ("FUSED_BF16", "PLAIN16")

# the product path's fixed choices (fvsrn_tpu/inference.py)
BLOCK = 16
SEG = 32
TILE = BLOCK * BLOCK


class FusedRender:
    """A prepared FUSED render of one camera: block-ordered rays, their
    saturation clip and the device copies of network and TF. Calling it
    renders one (H, W, 4) frame."""

    def __init__(self, ray_start: Tensor, ray_dir: Tensor, inv: Tensor,
                 tmax_clip: Tensor, network, tf, box_min,
                 box_size, width: int, height: int, march_kwargs: dict):
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

    def march(self, fn=mega_trace_dvr, **overrides):
        """``fn`` (the kernel's wrapper or its plain version) on this
        frame's block-ordered rays; returns its raw output."""
        kw = dict(self.march_kwargs, tmax_clip=self.tmax_clip, **overrides)
        return fn(self.ray_start, self.ray_dir, self.network, self.box_min,
                  self.box_size, self.tf.tensor, **kw)

    def __call__(self) -> Tensor:
        """One frame, back in row-major order: (H, W, 4)."""
        return self.march()[self.inv].reshape(self.height, self.width, 4)


class LoadedModel:
    """A trained SRN with its TF, stepping configuration and box."""

    def __init__(self, network: SceneRepresentationNetwork, tf,
                 config: Optional[RayEvaluationSteppingDvr] = None,
                 box_min=(-0.5, -0.5, -0.5), box_size=(1.0, 1.0, 1.0)):
        self.network = network
        self.tf = tf
        self.config = config or RayEvaluationSteppingDvr.make(
            stepsize=1 / 256)
        self.box_min = tuple(float(v) for v in box_min)
        self.box_size = tuple(float(v) for v in box_size)

    @classmethod
    def from_checkpoint(cls, path: str, tf=None,
                        config: Optional[RayEvaluationSteppingDvr] = None
                        ) -> "LoadedModel":
        """From the ``.npz`` weights export of a run file."""
        if tf is None:
            tf = TransferFunctionPiecewiseLinear.make(
                rgb=[[1.0, 1.0, 1.0]] * 2, opacity=[0.0, 50.0],
                positions=[0.0, 1.0])
        return cls(load_weights(path), tf, config=config)

    @staticmethod
    def rotation_cameras(num: int, distance: float = 1.6,
                         pitch: float = 0.3) -> list[CameraOnASphere]:
        return [CameraOnASphere.make(pitch=pitch, yaw=2 * np.pi * i / num,
                                     distance=distance)
                for i in range(num)]

    def prepare_network_render(self, camera: CameraOnASphere, width: int,
                               height: int, mode: str = "FUSED", *,
                               device="cuda"):
        """A zero-argument callable rendering (H, W, 4), with the
        per-camera planning (rays, block order, saturation probe) done
        here. Snapshot semantics: the network and TF are copied to
        ``device`` now; later changes to the model do not reach it."""
        if mode in _NOT_PORTED:
            raise NotImplementedError(f"mode {mode} is not ported yet")
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
        vol = VolumeInterpolationNetwork(net, self.box_min, self.box_size)
        if mode == "PLAIN32":
            @torch.no_grad()
            def render_plain():
                color = trace_dvr(rs, rd, vol, tf, self.config, steps).color
                return color.reshape(height, width, 4)
            return render_plain

        if width % BLOCK or height % BLOCK:
            raise NotImplementedError(
                f"FUSED needs width and height divisible by {BLOCK}; the "
                "per-segment engine for other sizes is not ported yet")
        if (net.latent.static_grid is None
                or not net.output_mode.startswith("density")):
            raise NotImplementedError("FUSED for networks without a latent "
                                      "grid or with color output is not "
                                      "ported yet")
        perm, inv = block_ray_permutation(width, height, BLOCK, BLOCK,
                                          device=dev)
        rs, rd = rs[perm].contiguous(), rd[perm].contiguous()
        clip = probe_saturation_tmax(rs, rd, vol, tf, stepsize=stepsize,
                                     max_steps=steps, coarse=8,
                                     margin_steps=16)
        kw = dict(stepsize=stepsize, seg=SEG, tile=TILE,
                  density_min=float(self.config.density_min),
                  density_max=float(self.config.density_max))
        return FusedRender(rs, rd, inv, clip, net, tf, self.box_min,
                           self.box_size, width, height, kw)

    def render_network(self, camera: CameraOnASphere, width: int,
                       height: int, mode: str = "FUSED", *,
                       device="cuda") -> Tensor:
        return self.prepare_network_render(camera, width, height, mode,
                                           device=device)()

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
