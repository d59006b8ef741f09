"""Timing shared by the port's probe tools."""
from __future__ import annotations

import time

import torch


def us_per_call(fn, iters: int, device: torch.device,
                graph: bool = False) -> float:
    """Microseconds per call of ``fn`` over ``iters`` calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU.
    With ``graph`` (card only) the calls are captured once into a CUDA
    graph and the replay is timed: the device's time alone, without the
    host's per-call launch cost."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(device)
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3
