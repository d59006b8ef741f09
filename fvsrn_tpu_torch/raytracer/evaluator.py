"""Image evaluator: the full-frame rendering entry point.

Counterpart of ``fvsrn_tpu/raytracer/evaluator.py``: ``ImageEvaluatorSimple``
wires camera, volume, TF and ray evaluator (``ray_mode`` "dvr", "iso" or
"mc") and renders a (B, 8, H, W) image with channels [r, g, b, alpha,
normal xyz, depth]; ``ProgressiveRenderer`` folds passes with fresh keys
into a running mean; ``extract_color`` takes rgba with an optional
exposure tonemap. The "mc" mode runs ``trace_mc`` on the volume's own
``eval_density``, as the JAX package does.

Supersampling (``samples > 1``) jitters every pixel by JAX's
``random.uniform`` bits (``utils.prng``) and averages the samples as the
JAX package does. A BRDF (``brdf.BRDFLambert``) shades every sample of
"dvr" in the plain march. Entry points render on ``device="cuda"``
unless the caller asks for the CPU; the volume must lie on that
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import Tensor

from ..camera import generate_rays
from ..utils import prng
from ..utils.device import resolve_device
from .dvr import RayEvaluationOutput, max_steps_bound, trace_dvr
from .iso import trace_iso
from .montecarlo import trace_mc


@dataclass(frozen=True, eq=False)
class ImageEvaluatorSimple:
    """Camera, volume, TF, BRDF and ray evaluator of a render. ``phase``
    is the phase function of ``ray_mode="mc"``."""
    camera: Any
    volume: Any
    tf: Any
    ray_config: Any
    brdf: Any = None
    phase: Any = None
    samples: int = 1
    ray_mode: str = "dvr"

    def render(self, width: int, height: int, *,
               max_steps: Optional[int] = None,
               background: Optional[Tensor] = None, key=None,
               device="cuda") -> Tensor:
        return render_image(self, width, height, max_steps=max_steps,
                            background=background, key=key, device=device)


def _batch_of(module) -> int:
    return getattr(module, "batch", 1)


def render_image(ev: ImageEvaluatorSimple, width: int, height: int, *,
                 max_steps: Optional[int] = None,
                 background: Optional[Tensor] = None, key=None,
                 device="cuda") -> Tensor:
    """Render a (B, 8, H, W) image, one camera of the batch per entry.
    The scene's batch is the largest of the camera's, the volume's and
    the TF's; camera entry b traces volume and TF entry min(b, batch -
    1).
    ``background``: an optional (1, 5, H, W) rgba + depth image; rays stop
    at its depth where its alpha > 0 ("dvr"), and it is blended under the
    result. ``key``: the host key of "mc" (default ``prng_key(42)``),
    folded with the batch entry, and of the supersampling jitter: with
    ``samples`` S > 1 every pixel is traced at S offsets drawn as
    ``uniform(key, (S, H, W, 2))`` (an unbatched camera), colors averaged,
    normals weighted by alpha over S, depth by alpha over the summed
    alpha."""
    dev = resolve_device(device)
    if max_steps is None and ev.ray_mode != "mc":
        max_steps = max_steps_bound(ev.volume.box_size.tolist(),
                                    ev.ray_config.stepsize)
    tf = ev.tf.to(dev)
    jitter = None
    if ev.samples > 1:
        if key is None:
            key = prng.prng_key(42)
        jitter = prng.uniform(key, (ev.samples, height, width, 2),
                              device=dev)
    ray_start, ray_dir = generate_rays(ev.camera, width, height,
                                       jitter=jitter, device=dev)
    tmax_in = None
    if background is not None:
        background = background.to(dev)
        tmax_map = torch.where(background[:, 3:4] > 0, background[:, 4:5],
                               torch.full_like(background[:, 4:5],
                                               float("inf")))
        tmax_in = torch.movedim(tmax_map, 1, -1)[0]     # (H, W, 1)

    def trace_one(b: int, rs: Tensor, rd: Tensor) -> RayEvaluationOutput:
        if ev.ray_mode == "dvr":
            return trace_dvr(rs, rd, ev.volume, tf, ev.ray_config, max_steps,
                             tmax_in=tmax_in, brdf=ev.brdf, b=b)
        if ev.ray_mode == "iso":
            return trace_iso(rs, rd, ev.volume, ev.ray_config, max_steps,
                             b=b)
        if ev.ray_mode == "mc":
            k = prng.fold_in(key if key is not None else prng.prng_key(42),
                             b)
            return trace_mc(k, rs, rd, ev.volume, tf, ev.phase,
                            ev.ray_config, b=b)
        raise ValueError(f"unknown ray mode {ev.ray_mode}")

    batch = max(_batch_of(ev.camera), _batch_of(ev.volume), _batch_of(tf))
    outs = [trace_one(min(b, batch - 1) if ev.samples == 1 else 0,
                      ray_start[b], ray_dir[b])
            for b in range(ray_start.shape[0])]
    color = torch.stack([o.color for o in outs])        # (B, H, W, 4)
    normal = torch.stack([o.normal if o.normal is not None
                          else torch.zeros_like(o.color[..., :3])
                          for o in outs])
    depth = torch.stack([o.depth for o in outs])
    if ev.samples > 1:
        w = color[..., 3:4]
        color_sum = torch.sum(color, dim=0, keepdim=True)
        depth = torch.sum(depth * w, dim=0, keepdim=True) / torch.clamp(
            color_sum[..., 3:4], min=1e-20)
        normal = torch.sum(normal * w, dim=0, keepdim=True) / ev.samples
        color = color_sum / ev.samples
    if background is not None:
        bg = torch.movedim(background[:, :4], 1, -1)
        acc_a = color[..., 3:4]
        color = torch.cat([
            color[..., :3] + (1 - acc_a) * bg[..., :3] * bg[..., 3:4],
            acc_a + (1 - acc_a) * bg[..., 3:4]], dim=-1)
    out = torch.cat([color, normal, depth], dim=-1)     # (B, H, W, 8)
    return torch.movedim(out, -1, 1)


class ProgressiveRenderer:
    """Accumulation of stochastic renders over frames: each
    :meth:`refine` pass renders with the key ``fold_in(key, frame)`` and
    adds into running sums; :attr:`image` is the running mean (color by
    frame count, normals and depth weighted by each pass's alpha)."""

    def __init__(self, evaluator: ImageEvaluatorSimple, width: int,
                 height: int, *, key=None, max_steps: Optional[int] = None,
                 device="cuda"):
        self.evaluator = evaluator
        self.width = width
        self.height = height
        self.key = key if key is not None else prng.prng_key(42)
        self.max_steps = max_steps
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self._sums = torch.zeros(self.evaluator.camera.batch, 8,
                                 self.height, self.width,
                                 device=self.device)
        self.frames = 0

    def refine(self, frames: int = 1) -> Tensor:
        """Render ``frames`` more passes into the sums; returns the running
        mean (B, 8, H, W)."""
        for _ in range(frames):
            img = render_image(self.evaluator, self.width, self.height,
                               max_steps=self.max_steps,
                               key=prng.fold_in(self.key, self.frames),
                               device=self.device)
            w = img[:, 3:4]
            self._sums = self._sums + torch.cat(
                [img[:, :4], img[:, 4:7] * w, img[:, 7:8] * w], dim=1)
            self.frames += 1
        return self.image

    @property
    def image(self) -> Tensor:
        """The running mean (B, 8, H, W) over the accumulated passes."""
        n = max(self.frames, 1)
        s = self._sums
        alpha = torch.clamp(s[:, 3:4], min=1e-20)
        return torch.cat([s[:, :4] / n, s[:, 4:7] / alpha, s[:, 7:8] / alpha],
                         dim=1)


def extract_color(image: Tensor, tonemapping: bool = False,
                  max_exposure: float = 1.0) -> Tensor:
    """(B, 8, H, W) -> (B, 4, H, W) rgba, with an optional exposure
    tonemap."""
    rgba = image[:, :4]
    if tonemapping:
        rgb = rgba[:, :3] / max_exposure
        rgba = torch.cat([torch.clamp(rgb, 0.0, 1.0), rgba[:, 3:4]], dim=1)
    return rgba
