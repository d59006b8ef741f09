"""LPIPS perceptual metric (Zhang et al. 2018) on PyTorch.

Counterpart of ``fvsrn_tpu/train/lpips.py`` (reference:
applications/losses/lpips/networks_basic.py ``PNetLin`` +
pretrained_networks.py): a frozen AlexNet/VGG16 feature stack, channel-wise
unit normalization at five taps, squared differences weighted by learned
1x1 linear heads, spatial mean, sum over taps.

The stack is ``F.conv2d`` and ``F.max_pool2d`` (the JAX package's are XLA
convolutions and windows, not Pallas kernels) in true float32
(``strict_f32``). Every weight is a buffer: the model has no parameters,
so an optimizer over a network beside it never moves it.

Weights: the backbone is torchvision's ImageNet-pretrained ``alexnet`` /
``vgg16`` ``features`` state dict; the linear heads are
richzhang/PerceptualSimilarity v0.1 (``lpips/weights/v0.1/{alex,vgg}.pth``).
Neither ships with the repository; point :func:`load_lpips` at local
copies (or set ``FVSRN_LPIPS_BACKBONE`` / ``FVSRN_LPIPS_LINEAR``).
:func:`lpips_random` draws the JAX package's random weights bit for bit,
so the machinery stays testable without them.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..utils.device import strict_f32

# per-channel input normalization (reference: networks_basic.py
# ScalingLayer constants; inputs are rgb in [-1, 1])
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)

# conv plans: (out_ch, kernel, stride, pad, tap_after, pool_before)
_ALEX_PLAN = [
    (64, 11, 4, 2, True, False),
    (192, 5, 1, 2, True, True),
    (384, 3, 1, 1, True, True),
    (256, 3, 1, 1, True, False),
    (256, 3, 1, 1, True, False),
]
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_VGG_TAPS = {1, 3, 6, 9, 12}  # conv index (0-based) after which to tap


def _vgg_plan():
    plan = []
    pool = False
    for v in _VGG_CFG:
        if v == "M":
            pool = True
            continue
        idx = len(plan)
        plan.append((v, 3, 1, 1, idx in _VGG_TAPS, pool))
        pool = False
    return plan


def _plan(arch: str):
    if arch == "alex":
        return _ALEX_PLAN
    if arch == "vgg":
        return _vgg_plan()
    raise ValueError(f"unknown LPIPS backbone '{arch}' (alex|vgg)")


def _f32(a) -> Tensor:
    return torch.from_numpy(np.array(a, np.float32))


class LPIPS(nn.Module):
    """Frozen LPIPS model: conv stack + per-tap linear head weights, as
    buffers ``conv_w{i}``, ``conv_b{i}``, ``lin_w{t}``."""

    def __init__(self, conv_w, conv_b, lin_w, arch: str = "alex"):
        super().__init__()
        plan = _plan(arch)
        if not len(conv_w) == len(conv_b) == len(plan):
            raise ValueError(f"{arch} needs {len(plan)} convs, got "
                             f"{len(conv_w)} weights, {len(conv_b)} biases")
        if len(lin_w) != sum(tap for *_, tap, _ in plan):
            raise ValueError(f"{arch} needs one linear head a tap, got "
                             f"{len(lin_w)}")
        self.arch = arch
        for i, (w, b) in enumerate(zip(conv_w, conv_b)):
            self.register_buffer(f"conv_w{i}", _f32(w))
            self.register_buffer(f"conv_b{i}", _f32(b))
        for t, w in enumerate(lin_w):
            self.register_buffer(f"lin_w{t}", _f32(w))
        self.register_buffer("shift", _f32(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", _f32(_SCALE).view(1, 3, 1, 1))

    @property
    def conv_w(self) -> tuple:
        return tuple(getattr(self, f"conv_w{i}")
                     for i in range(len(_plan(self.arch))))

    @property
    def conv_b(self) -> tuple:
        return tuple(getattr(self, f"conv_b{i}")
                     for i in range(len(_plan(self.arch))))

    @property
    def lin_w(self) -> tuple:
        n = sum(tap for *_, tap, _ in _plan(self.arch))
        return tuple(getattr(self, f"lin_w{t}") for t in range(n))

    def features(self, rgb: Tensor) -> list:
        """Tap activations for (B, 3, H, W) rgb in [-1, 1]."""
        strict_f32()
        x = (rgb - self.shift) / self.scale
        pk, ps = (3, 2) if self.arch == "alex" else (2, 2)
        taps = []
        for (o, k, s, p, tap, pool), w, b in zip(
                _plan(self.arch), self.conv_w, self.conv_b):
            if pool:
                x = F.max_pool2d(x, pk, ps)
            x = F.conv2d(x, w, stride=s, padding=p)
            x = torch.relu(x + b[None, :, None, None])
            if tap:
                taps.append(x)
        return taps

    def forward(self, pred_rgb: Tensor, ref_rgb: Tensor) -> Tensor:
        """LPIPS distance for (B, 3, H, W) rgb pairs in [0, 1]: (B,)
        distances (reference: networks_basic.py forward,
        spatial=False)."""
        p = self.features(pred_rgb * 2.0 - 1.0)
        r = self.features(ref_rgb * 2.0 - 1.0)
        total = 0.0
        for fp, fr, lw in zip(p, r, self.lin_w):
            # channel-wise unit normalization (normalize_tensor)
            np_ = fp / torch.sqrt(torch.sum(fp ** 2, dim=1, keepdim=True)
                                  + 1e-10)
            nr = fr / torch.sqrt(torch.sum(fr ** 2, dim=1, keepdim=True)
                                 + 1e-10)
            d = (np_ - nr) ** 2
            w = torch.clamp(lw, min=0.0)  # heads are learned non-negative
            total = total + torch.mean(
                torch.sum(d * w[None, :, None, None], dim=1), dim=(1, 2))
        return total


def lpips_random(arch: str = "alex", seed: int = 0) -> LPIPS:
    """Random-weight LPIPS (machinery testing only -- NOT perceptual),
    drawn from ``np.random.default_rng(seed)`` in the JAX package's order:
    equal to its ``lpips_random(arch, seed)`` bit for bit."""
    rng = np.random.default_rng(seed)
    cw, cb, lw = [], [], []
    cin = 3
    for (o, k, s, p, tap, pool) in _plan(arch):
        std = 1.0 / np.sqrt(cin * k * k)
        cw.append(rng.normal(0, std, (o, cin, k, k)).astype(np.float32))
        cb.append(np.zeros((o,), np.float32))
        if tap:
            lw.append(rng.random(o).astype(np.float32) / o)
        cin = o
    return LPIPS(cw, cb, lw, arch=arch)


def load_lpips(backbone_path: Optional[str] = None,
               linear_path: Optional[str] = None,
               arch: str = "alex") -> LPIPS:
    """Build LPIPS from torch checkpoints, on the CPU (``.to(device)``
    moves it).

    ``backbone_path``: torchvision ``alexnet``/``vgg16`` state dict (keys
    ``features.N.{weight,bias}``). ``linear_path``: LPIPS v0.1 linear-head
    state dict (keys ``linN.model.1.weight``, shape (1, C, 1, 1)). Falls
    back to ``FVSRN_LPIPS_BACKBONE`` / ``FVSRN_LPIPS_LINEAR`` env vars.
    """
    backbone_path = backbone_path or os.environ.get("FVSRN_LPIPS_BACKBONE")
    linear_path = linear_path or os.environ.get("FVSRN_LPIPS_LINEAR")
    if not backbone_path or not linear_path:
        raise FileNotFoundError(
            "LPIPS weights not configured: pass backbone_path/linear_path "
            "or set FVSRN_LPIPS_BACKBONE / FVSRN_LPIPS_LINEAR. Backbone = "
            "torchvision alexnet/vgg16 checkpoint; linear heads = "
            "richzhang/PerceptualSimilarity v0.1 (the reference bundles "
            "them at applications/losses/lpips/weights/v0.1/).")
    bsd = torch.load(backbone_path, map_location="cpu", weights_only=True)
    lsd = torch.load(linear_path, map_location="cpu", weights_only=True)
    conv_keys = sorted(
        (k for k in bsd if k.startswith("features.")
         and k.endswith(".weight")),
        key=lambda k: int(k.split(".")[1]))
    plan = _plan(arch)
    if len(conv_keys) != len(plan):
        raise ValueError(
            f"backbone has {len(conv_keys)} convs, {arch} needs "
            f"{len(plan)}")
    cw = [bsd[k].numpy() for k in conv_keys]
    cb = [bsd[k[:-6] + "bias"].numpy() for k in conv_keys]
    lw = [lsd[f"lin{i}.model.1.weight"].numpy()[0, :, 0, 0]
          for i in range(5)]
    for (o, *_), w in zip(plan, cw):
        if w.shape[0] != o:
            raise ValueError(f"conv shape mismatch: {tuple(w.shape)} vs "
                             f"out={o}")
    return LPIPS(cw, cb, lw, arch=arch)
