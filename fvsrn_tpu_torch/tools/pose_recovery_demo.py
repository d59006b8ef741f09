"""Camera pose recovery on the trained flagship, through TPU kernel row 1.

Counterpart of ``tools/pose_recovery_demo.py`` of the JAX package, in its
configuration: the trained flagship (``assets/flagship_mlobb_torch.npz``)
under the dense scene's TF, 64x64 with 4 fixed jittered samples a pixel,
world stepsize 1/128, the true pose (pitch, yaw, distance) = (0.3, 0.5,
1.6) and the start pose off by (-0.04, 0.05, -0.03); Levenberg-Marquardt
(``train.pose.recover_pose``, 15 iterations) on central differences of
forward renders. Every render goes through the megakernel's render
(``ops.fused_mega.mega_trace_dvr``: non-differentiable, no early-out, a
bf16 latent table; ``csrc/mega_fwd.cuh`` on the card, its plain version
on the CPU), on 256-ray tiles of 32-point segments, the product render's.
Where the JAX demo certifies a latent sub-box for the TPU kernel's
resident slab, the CUDA kernel reads the whole table and takes no such
spec.

    python -m fvsrn_tpu_torch.tools.pose_recovery_demo [--device cuda|cpu]

Prints and returns (``main``) the JAX demo's record: the poses, the pose
errors before and after (largest component), the costs, the iterations
and the wall seconds. Writes no file.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.fused_mega import KERNEL_SEG, KERNEL_TILE, mega_trace_dvr
from ..scenes import dense_scene
from ..train.checkpoints import load_weights
from ..train.pose import make_pose_render, recover_pose
from ..utils.device import resolve_device

W = 64
SUPERSAMPLE = 4
STEPSIZE = 1.0 / 128
FOV = math.radians(45.0)
PYD_TRUE = np.asarray([0.3, 0.5, 1.6], np.float32)
PERTURBATION = np.asarray([-0.04, 0.05, -0.03], np.float32)
ITERATIONS = 15
BOX_MIN, BOX_SIZE = (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0)


def make_render_rays(device="cuda", march: Callable = mega_trace_dvr):
    """``render_rays(ray_start, ray_dir) -> (R, 4)`` of the trained
    flagship under the dense TF by ``march`` (row 1, or its plain version
    ``ops.fused_mega.mega_trace_dvr_plain``) with the demo's settings."""
    dev = resolve_device(device)
    _, tf, npz = dense_scene()
    net = load_weights(npz).to(dev).eval()
    tf_tensor = tf.to(dev).tensor

    def render_rays(rs, rd):
        return march(rs, rd, net, BOX_MIN, BOX_SIZE, tf_tensor,
                     stepsize=STEPSIZE, seg=KERNEL_SEG, tile=KERNEL_TILE,
                     enable_early_out=False, differentiable=False,
                     table_dtype=torch.bfloat16)

    return render_rays


def make_render(render_rays: Callable, device="cuda") -> Callable:
    """``render(pyd) -> (W*W, 4)``: the demo's supersampled pose render."""
    return make_pose_render(render_rays, W, W, fov_y_radians=FOV,
                            supersample=SUPERSAMPLE, device=device)


def run(device="cuda", iterations: int = ITERATIONS) -> dict:
    """Recover the perturbed pose; the JAX demo's record, plus the number
    of renders."""
    dev = resolve_device(device)
    render_rays = make_render_rays(dev)
    renders = [0]

    def counted(rs, rd):
        renders[0] += 1
        return render_rays(rs, rd)

    render = make_render(counted, dev)
    target = render(PYD_TRUE)
    pyd0 = PYD_TRUE + PERTURBATION
    t0 = time.perf_counter()
    res = recover_pose(render, target, pyd0, iterations=iterations)
    wall = time.perf_counter() - t0
    e0 = float(np.abs(PERTURBATION).max())
    e1 = float(np.abs(res.pyd - PYD_TRUE).max())
    engine = ("megakernel render (row 1, csrc/mega_fwd.cuh), bf16 table, "
              + ("CUDA" if dev.type == "cuda" else "plain version on the CPU"))
    return {
        "scene": "flagship_mlobb (trained)", "engine": engine,
        "resolution": W, "supersample": SUPERSAMPLE, "stepsize": STEPSIZE,
        "pyd_true": [float(v) for v in PYD_TRUE],
        "perturbation": [float(v) for v in PERTURBATION],
        "recovered": [float(v) for v in res.pyd],
        "err0": e0, "err1": e1, "err_ratio": e1 / e0,
        "cost0": res.cost0, "cost1": res.cost, "costs": res.costs,
        "iterations": res.iterations, "wall_s": wall,
        "renders": renders[0],
    }


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
