"""Device selection and float32 policy for the PyTorch port.

Entry points take ``device="cuda"`` by default and never fall back to
the CPU: a CUDA request on a machine without a card raises. The CPU is
used only when a caller asks for it (the parity tests do).
"""
from __future__ import annotations

import torch


def strict_f32() -> None:
    """Keep float32 matrix products and convolutions in true float32.

    The plain PyTorch paths are the oracles of the CUDA kernels, so they
    must not silently round through TF32 on the card (cuDNN allows TF32
    by default). Called by every plain path before it computes.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but
    no card is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    strict_f32()
    return dev
