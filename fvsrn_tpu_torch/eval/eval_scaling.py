"""Scaling measurement: rays/s of the data-parallel render from 1 to N
ranks.

Counterpart of ``fvsrn_tpu/eval/eval_scaling.py`` on ``torch.distributed``
(``parallel/mesh.py``): the rays of one frame are sharded over the ranks
(``parallel/train_step.make_dp_render``), the network and its latent
grid replicated from rank 0, and every rank's colors gathered back. Each
rank is a process (``parallel.mesh.spawn``): ``nccl`` when every rank has
a card of its own, ``gloo`` when ranks share a card or run on the CPU,
where each rank takes one thread (``torch.set_num_threads(1)``) so that a
rank maps onto a core. Frames are timed by CUDA events on the card and
the host clock on the CPU (``utils.timer.GPUTimer``).

Ranks that share a card (more ranks than cards) contend for it: their
rays/s is marked ``"shared_device": true`` and is no scaling figure; a
scaling efficiency needs a card per rank.

Usage: python -m fvsrn_tpu_torch.eval.eval_scaling [--devices 1 2 4 8]
       [--device cuda|cpu] [--spawn]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def scene(device):
    """The measured scene on ``device``: JAX's network at its widths
    (32:32, SnakeAlt:2, 8 Fourier features, an 8 x 16^3 latent grid, seed
    1, ``density:direct``) as a volume, and the two-knot TF. Returns
    (volume, tf)."""
    from ..models.latent import LatentSpace
    from ..models.network_volume import VolumeInterpolationNetwork
    from ..models.srn import SceneRepresentationNetwork
    from ..transfer import TransferFunctionPiecewiseLinear
    rng = np.random.default_rng(0)
    latent = LatentSpace(static_grid=torch.from_numpy(
        (rng.standard_normal((8, 16, 16, 16)) * 0.05).astype(np.float32)))
    net = SceneRepresentationNetwork.make(
        layers="32:32", activation="SnakeAlt:2", num_fourier=8,
        output_mode="density:direct", latent=latent, seed=1)
    vol = VolumeInterpolationNetwork(net.to(device))
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.9, 0.3, 0.1], [1.0, 1.0, 0.7]], opacity=[0.0, 20.0],
        positions=[0.0, 1.0]).to(device)
    return vol, tf


def _rank_measure(mesh, width: int, height: int, stepsize: float,
                  repeats: int, trials: int):
    """One rank's part: ``trials`` timed runs of ``repeats`` frames each
    after a warm-up frame. Returns [rays/s of each trial] and the last
    frame's colors (H * W, 4) on the CPU."""
    from ..camera import CameraOnASphere, generate_rays
    from ..parallel.mesh import replicate
    from ..parallel.train_step import make_dp_render
    from ..raytracer.dvr import (RayEvaluationSteppingDvr, max_steps_bound,
                                 trace_dvr)
    from ..utils.timer import GPUTimer
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)    # a rank a core
    vol, tf = scene(mesh.device)
    vol = replicate(mesh, vol)
    cfg = RayEvaluationSteppingDvr.make(stepsize=stepsize,
                                        enable_early_out=False)
    steps = max_steps_bound((1.0, 1.0, 1.0), stepsize)
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6)
    rs, rd = generate_rays(cam, width, height, device=mesh.device)
    rs, rd = rs.reshape(-1, 3), rd.reshape(-1, 3)

    @torch.no_grad()
    def render_rays(rs, rd):
        return trace_dvr(rs, rd, vol, tf, cfg, steps).color

    sharded = make_dp_render(mesh, render_rays)
    out = sharded(rs, rd)
    timer = GPUTimer(mesh.device)
    rates = []
    for _ in range(trials):
        torch.distributed.barrier()
        timer.start()
        for _ in range(repeats):
            out = sharded(rs, rd)
        ms = timer.stop()
        rates.append(width * height * repeats / (ms / 1e3))
    return rates, out.cpu()


def run_trials(n_devices: int, width: int, height: int, stepsize: float,
               repeats: int = 3, *, trials: int = 1, device="cuda"):
    """``trials`` timed runs of the render sharded over ``n_devices``
    ranks on ``device`` ("cuda": ranks on the cards, sharing them when
    there are more ranks than cards). Returns ([rays/s], the frame's
    colors (H * W, 4))."""
    from ..parallel.mesh import spawn
    return spawn(_rank_measure, n_devices, width, height, stepsize, repeats,
                 trials, device=device)


def measure(n_devices: int, width: int, height: int, stepsize: float,
            repeats: int = 3, *, device="cuda") -> float:
    """One timed run: rays/s of the render sharded over ``n_devices``
    ranks."""
    return run_trials(n_devices, width, height, stepsize, repeats,
                      device=device)[0][0]


def shared_device(n: int, device) -> bool:
    """Whether ``n`` ranks on ``device`` share a card."""
    return (torch.device(device).type == "cuda"
            and n > torch.cuda.device_count())


def _spawn_one(n: int, args) -> dict:
    """Run ONE rank count in a fresh process pinned to n cores
    (``taskset -c 0-(n-1)``), so that each CPU rank (one thread) maps onto
    a core: 1 rank on 1 core is the unit of linear scaling, and the
    shortfall at n ranks on n cores is sharding overhead and contention for
    the shared memory bandwidth, not threads time-slicing fewer cores."""
    import shutil
    import subprocess
    cmd = [sys.executable, "-m", "fvsrn_tpu_torch.eval.eval_scaling",
           "--devices", str(n), "--width", str(args.width),
           "--height", str(args.height), "--stepsize", str(args.stepsize),
           "--trials", str(args.trials), "--device", args.device]
    if shutil.which("taskset"):
        cmd = ["taskset", "-c", f"0-{n - 1}"] + cmd
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])[str(n)]


def _report(n, r):
    print(f"n={n}: {r['rays_per_s'] / 1e6:.3f} Mrays/s "
          f"+- {r.get('rays_per_s_std', 0) / 1e6:.3f} "
          f"(efficiency {r['efficiency_vs_linear'] * 100:.1f}%"
          + (", ranks share a card: not a scaling figure"
             if r.get("shared_device") else "") + ")", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="rank counts to measure")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--stepsize", type=float, default=1 / 64)
    p.add_argument("--trials", type=int, default=1,
                   help="independent timed trials; reports mean and std")
    p.add_argument("--device", default="cuda",
                   help="cuda (the ranks on the cards) or cpu (gloo ranks "
                        "of one thread each)")
    p.add_argument("--spawn", action="store_true",
                   help="one pinned subprocess per rank count (the "
                        "contention-controlled harness; see _spawn_one)")
    args = p.parse_args(argv)
    from ..utils.device import resolve_device
    resolve_device(args.device)
    cores = len(os.sched_getaffinity(0))
    results, base = {}, None
    for n in args.devices:
        if torch.device(args.device).type == "cpu" and n > cores:
            print(f"skip n={n} (only {cores} cores; ranks beyond cores "
                  "measure time-slicing, not scaling)", file=sys.stderr)
            continue
        if args.spawn:
            r = _spawn_one(n, args)
            rays_s = r["rays_per_s"]
        else:
            vals, _ = run_trials(n, args.width, args.height, args.stepsize,
                                 trials=args.trials, device=args.device)
            rays_s = float(np.mean(vals))
            r = {"rays_per_s": round(rays_s, 1)}
            if args.trials > 1:
                r["rays_per_s_std"] = round(float(np.std(vals)), 1)
            if shared_device(n, args.device):
                r["shared_device"] = True
        if base is None:
            base = rays_s / (n if args.spawn else 1)
        r["efficiency_vs_linear"] = round(
            rays_s / (base * n / (1 if args.spawn else args.devices[0])), 4)
        results[str(n)] = r
        _report(n, r)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
