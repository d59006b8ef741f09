"""Training losses: L1/L2, SSIM/DSSIM, and the screen- and world-space
loss stacks.

Counterpart of ``fvsrn_tpu/train/losses.py``. SSIM uses an 11x11
gaussian window (sigma 1.5) over (B, C, H, W) images with "valid"
padding, in true float32 (``strict_f32``: cuDNN would round the
convolution through TF32). LPIPS is ``train.lpips.LPIPS``, attached as
``LossNetScreen.lpips_model``; requesting it without a model raises, as
it does in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from ..utils.device import strict_f32


def l1_loss(pred: Tensor, ref: Tensor) -> Tensor:
    return torch.mean(torch.abs(pred - ref))


def l2_loss(pred: Tensor, ref: Tensor) -> Tensor:
    return torch.mean((pred - ref) ** 2)


def _gaussian_window(size: int, sigma: float, dtype, device) -> Tensor:
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def ssim(pred: Tensor, ref: Tensor, *, window_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0) -> Tensor:
    """SSIM over (B, C, H, W) images, gaussian-windowed (Wang et al.
    2004)."""
    strict_f32()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    w1d = _gaussian_window(window_size, sigma, pred.dtype, pred.device)
    window = torch.outer(w1d, w1d)[None, None]

    def filt(x):
        b, c, h, w = x.shape
        y = F.conv2d(x.reshape(b * c, 1, h, w), window)
        return y.reshape(b, c, y.shape[2], y.shape[3])

    mu1 = filt(pred)
    mu2 = filt(ref)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(pred * pred) - mu1_sq
    sigma2_sq = filt(ref * ref) - mu2_sq
    sigma12 = filt(pred * ref) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def dssim(pred: Tensor, ref: Tensor, **kw) -> Tensor:
    """Structural dissimilarity (1 - SSIM) / 2."""
    return (1.0 - ssim(pred, ref, **kw)) / 2.0


def lpips_unavailable_error():
    return RuntimeError(
        "LPIPS requested (lpips > 0) but no model attached: build one with "
        "fvsrn_tpu_torch.train.lpips.load_lpips(backbone_path, linear_path) "
        "(torchvision alexnet/vgg16 checkpoint + richzhang/"
        "PerceptualSimilarity v0.1 linear heads -- the files the reference "
        "bundles at applications/losses/lpips/weights/), move it to the "
        "images' device and pass it as "
        "LossNetScreen(lpips=..., lpips_model=model).")


@dataclass(frozen=True)
class LossNetScreen:
    """Screen-space (image) loss: weighted L1 + L2 + DSSIM on (B, 4, H, W)
    rgba images, + LPIPS of ``lpips_model`` (``train.lpips.LPIPS``) on the
    rgb; ``multiply_alpha`` premultiplies prediction and reference rgb by
    the *reference* alpha."""
    l1: float = 0.0
    l2: float = 0.0
    dssim: float = 0.0
    lpips: float = 0.0
    multiply_alpha: bool = False
    lpips_model: Optional[object] = None

    def __call__(self, prediction: Tensor, reference: Tensor,
                 return_individual: bool = False):
        if reference.ndim != 4 or reference.shape[1] != 4:
            raise ValueError("expected (B, 4, H, W) rgba images")
        if self.lpips > 0 and self.lpips_model is None:
            raise lpips_unavailable_error()
        color_channels = 3 if self.multiply_alpha else 4
        if self.multiply_alpha:
            alpha = reference[:, 3:]
            prediction = torch.cat([prediction[:, :3] * alpha,
                                    prediction[:, 3:]], dim=1)
            reference = torch.cat([reference[:, :3] * alpha, alpha], dim=1)
        zero = prediction.new_zeros(())
        vals = {"l1": l1_loss(prediction, reference),
                "l2": l2_loss(prediction, reference),
                "dssim": (dssim(prediction[:, :color_channels],
                                reference[:, :color_channels])
                          if self.dssim > 0 else zero),
                "lpips": (torch.mean(self.lpips_model(
                    prediction[:, :3], reference[:, :3]))
                    if self.lpips > 0 else zero)}
        total = (self.l1 * vals["l1"] + self.l2 * vals["l2"]
                 + self.dssim * vals["dssim"] + self.lpips * vals["lpips"])
        vals["total"] = total
        return (total, vals) if return_individual else total


@dataclass(frozen=True)
class LossNetWorld:
    """World-space (sample) loss: mode 'density' -> L1/L2 on (N, 1); mode
    'rgbo' -> L1/L2 on rgb with the absorption weighted by
    ``absorption_weighting``."""
    mode: str = "density"
    l1: float = 1.0
    l2: float = 0.0
    absorption_weighting: float = 0.1

    def __call__(self, prediction: Tensor, reference: Tensor,
                 return_individual: bool = False):
        if self.mode == "density":
            vals = {"l1": l1_loss(prediction, reference),
                    "l2": l2_loss(prediction, reference)}
            total = self.l1 * vals["l1"] + self.l2 * vals["l2"]
        else:
            x_rgb, x_a = prediction[..., :3], prediction[..., 3:]
            y_rgb, y_a = reference[..., :3], reference[..., 3:]
            vals = {"l1rgb": l1_loss(x_rgb, y_rgb),
                    "l1alpha": l1_loss(x_a, y_a),
                    "l2rgb": l2_loss(x_rgb, y_rgb),
                    "l2alpha": l2_loss(x_a, y_a)}
            w = self.absorption_weighting
            total = (self.l1 * vals["l1rgb"] + self.l1 * w * vals["l1alpha"]
                     + self.l2 * vals["l2rgb"] + self.l2 * w * vals["l2alpha"])
        vals["total"] = total
        return (total, vals) if return_individual else total
