"""Device selection and float32 policy for the PyTorch port.

Entry points take ``device="cuda"`` by default and never fall back to
the CPU: a CUDA request on a machine without a card raises. The CPU is
used only when a caller asks for it (the parity tests do).
"""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=256)
def _constant(values, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for Python
    numbers (a number, or a tuple or list of them), made once a device and
    kept. Made anew on the card, such a tensor is a copy from pageable host
    memory, which waits for all work queued on the stream: a plain march
    that made its stepsize or box each segment kept the card idle while the
    host launched the next segment's work. The tensor is shared: do not
    write to it."""
    if isinstance(values, list):
        values = tuple(values)
    return _constant(values, dtype, str(torch.device(device)))


def as_f32(values, device) -> torch.Tensor:
    """``values`` as float32 on ``device``: a tensor moved there, Python
    or NumPy numbers through :func:`constant` (no copy after the first)."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32)
    return constant(tuple(float(v) for v in values), torch.float32, device)
