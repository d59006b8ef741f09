"""Rows 1-3 on the dense flagship, timed (card): the product render's
kernel (``FusedRender.march``, bf16 table) at 512², world stepsize
1/512, and one training step (the differentiable march, L1 against the
MARSCHNER_LOBB render, backward, Adam), as chip_smoke.py phases 6 and 10
time them (CUDA events, a warm-up first). Prints one JSON line with the
card's name and power limit.

    python3 tools/time_mega_flagship.py [repeats]

It uses the port's public entry points only, so a copy runs in an older
checkout too: run both in turns (parent, change, change, parent) in one
call to compare them on one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZE = 512
STEPSIZE = 1.0 / 512
CAMERA = dict(pitch=0.3, yaw=0.5, distance=1.6)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds a call of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_mega_flagship: no CUDA device", file=sys.stderr)
        return 2
    from fvsrn_tpu_torch.camera import CameraOnASphere
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.ops import _build
    from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.scenes import dense_scene
    from fvsrn_tpu_torch.train.optimizer import make_optimizer
    from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

    repeats = int(argv[0]) if argv else 3
    _build.build(["mega_fwd", "mega_bwd"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _, tf, npz = dense_scene()
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    model = LoadedModel.from_checkpoint(npz, tf=tf, config=cfg)
    render = model.prepare_network_render(CameraOnASphere.make(**CAMERA),
                                          SIZE, SIZE, "FUSED")
    row1 = [cuda_ms(lambda: render.march(), 10) for _ in range(repeats)]
    box = (model.box_min, model.box_size)
    net = render.network
    tf_d = render.tf.tensor
    rs, rd = render.ray_start, render.ray_dir
    with torch.no_grad():
        target = trace_dvr(rs, rd, VolumeInterpolationImplicit.make(
            "MARSCHNER_LOBB", device=rs.device), render.tf, cfg,
            max_steps_bound(box[1], STEPSIZE)).color
    opt, sched = make_optimizer(net.parameters(), "Adam", lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        img = mega_trace_dvr(rs, rd, net, *box, tf_d, stepsize=STEPSIZE,
                             differentiable=True)
        (img - target).abs().mean().backward()
        opt.step()
        sched.step()

    steps = [cuda_ms(step, 3) for _ in range(repeats)]
    print(json.dumps({"card": smi, "root": ROOT, "row1_ms": row1,
                      "step_ms": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
