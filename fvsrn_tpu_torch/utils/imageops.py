"""Image-space utilities: flow warping and pyramid inpainting.

Counterpart of ``fvsrn_tpu/utils/imageops.py``: backward warping of an
image by an optical flow with bilinear sampling, and masked pyramid
inpainting. Plain tensor functions on the tensors' device, with the JAX
package's semantics: indices clamped to the border after ``floor``,
masked 2x2 pooling with odd sizes zero-padded, a pyramid that stops at
1x1 or after 32 levels, and a coarse-to-fine fill by nearest repeat.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor


def warp_image(image: Tensor, flow: Tensor) -> Tensor:
    """Backward-warp ``image`` (C, H, W) by ``flow`` (2, H, W) pixels:
    out[c, y, x] = image[c, y + flow[1], x + flow[0]] with bilinear
    sampling and border clamping."""
    c, h, w = image.shape
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    sx = xx + flow[0]
    sy = yy + flow[1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = torch.clamp(x0.to(torch.int32), 0, w - 1).long()
    y0 = torch.clamp(y0.to(torch.int32), 0, h - 1).long()
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    i00 = image[:, y0, x0]
    i01 = image[:, y0, x1]
    i10 = image[:, y1, x0]
    i11 = image[:, y1, x1]
    top = i00 + (i01 - i00) * fx
    bot = i10 + (i11 - i10) * fx
    return top + (bot - top) * fy


def inpaint(image: Tensor, mask: Tensor,
            levels: Optional[int] = None) -> Tensor:
    """Fill unknown pixels (mask == 0) by pyramid down/up diffusion:
    average-downsample the masked image to a coarse level, then upsample
    filling only the holes. image (C, H, W), mask (H, W) with 1 = known.
    Returns the filled image. ``levels`` is computed when not given and
    not read, as in the JAX package: the pyramid always runs to 1x1."""
    c, h, w = image.shape
    if levels is None:
        levels = max(h, w).bit_length()

    def down(img, m):
        # masked 2x2 average pooling, odd sizes padded with zeros
        ih, iw = img.shape[1], img.shape[2]
        ph, pw = (ih + 1) // 2 * 2, (iw + 1) // 2 * 2
        img = F.pad(img, (0, pw - iw, 0, ph - ih))
        m2 = F.pad(m, (0, pw - iw, 0, ph - ih))
        s = (img * m2).reshape(c, ph // 2, 2, pw // 2, 2).sum((2, 4))
        n = m2.reshape(ph // 2, 2, pw // 2, 2).sum((1, 3))
        return s / torch.clamp(n, min=1e-8), (n > 0).to(m.dtype)

    imgs = [image * mask[None]]
    masks = [mask]
    while imgs[-1].shape[1] > 1 or imgs[-1].shape[2] > 1:
        i2, m2 = down(imgs[-1], masks[-1])
        imgs.append(i2)
        masks.append(m2)
        if len(imgs) > 32:
            break

    filled = imgs[-1]
    for lvl in range(len(imgs) - 2, -1, -1):
        target = imgs[lvl]
        m = masks[lvl]
        hh, ww = target.shape[1], target.shape[2]
        up = filled.repeat_interleave(2, dim=1).repeat_interleave(
            2, dim=2)[:, :hh, :ww]
        filled = torch.where(m[None] > 0, target, up)
    return filled
