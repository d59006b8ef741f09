"""Timing utilities (counterpart of ``fvsrn_tpu/utils/timer.py``).

``GPUTimer`` is the reference's CUDA-event timer exposed to Python
(reference: bindings/bindings.cpp:101-131 ``GPUTimer``; ``pyrenderer.sync``
at :274): on the card, events recorded on the current stream bracket the
work and ``stop`` waits for the second one; with an explicit CPU device it
reads the host clock, the work being synchronous there.
"""
from __future__ import annotations

import time

import torch

from .device import resolve_device


def sync(device="cuda") -> None:
    """Wait for every queued operation on ``device`` (a no-op on the
    CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class GPUTimer:
    """``start()`` ... ``stop()`` -> elapsed milliseconds."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._start = None

    def start(self) -> None:
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self) -> float:
        """Milliseconds since :meth:`start`."""
        if self._start is None:
            raise RuntimeError("timer not started")
        start, self._start = self._start, None
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return (time.perf_counter() - start) * 1e3
