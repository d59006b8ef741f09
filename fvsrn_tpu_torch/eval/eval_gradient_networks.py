"""Gradient-quality evaluation of a trained SRN, and its shaded render
(the port of ``fvsrn_tpu/eval/eval_gradient_networks.py``; the paper's
eval_GradientNetworks scripts).

Trains one SRN on the scene (``train.main.run``, world mode), scores the
normals it gives by the adjoint and by forward differences against the
scene volume's own normals (mean cosine and L2 over seeded interior
positions), then renders it shaded at 128x128, stepsize 1/128 through the
megakernel's normals instance (``ops.fused_mega.mega_trace_dvr`` with
``need_normals``: csrc/mega_fwd.cuh on the card) and holds the image to
the plain lattice march (``raytracer.dvr.trace_dvr``) by SSIM.

Usage: python -m fvsrn_tpu_torch.eval.eval_gradient_networks
       [--scene S] [--epochs N] [--samples K] [--eval-samples M]
       [--fd-step H] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
STEPSIZE = 1.0 / 128
RENDER_SIZE = 128


def normal_rows(net, volume, *, eval_samples: int, fd_step: float,
                seed: int = 123, device="cuda") -> list:
    """[{mode, mean_cosine, l2}] of the network's normals by ``adjoint``
    and ``fd`` against ``volume``'s at ``eval_samples`` uniform positions
    in [0.05, 0.95]^3 of the box (the JAX package's draw of
    ``PRNGKey(seed)``, bit for bit)."""
    from ..models.network_volume import VolumeInterpolationNetwork
    from ..utils import prng
    from ..utils.vecmath import safe_normalize
    pos01 = prng.uniform(prng.prng_key(seed), (eval_samples, 3),
                         minval=0.05, maxval=0.95)
    world = volume.box_min + pos01 * volume.box_size
    ref_n = safe_normalize(volume.eval_normal(world)).to(device)
    world = world.to(device)
    rows = []
    for mode in ("adjoint", "fd"):
        nv = VolumeInterpolationNetwork(net, *BOX, gradient_mode=mode,
                                        fd_step=fd_step)
        got = safe_normalize(nv.eval_normal(world))
        cosine = torch.sum(got * ref_n, dim=-1)
        rows.append({"mode": mode, "mean_cosine": float(cosine.mean()),
                     "l2": float(torch.sum((got - ref_n) ** 2, -1).mean())})
    return rows


def shaded_render(net, *, size: int = RENDER_SIZE, device="cuda") -> dict:
    """The JAX script's shaded DVR of ``net`` at ``size``^2: the
    megakernel with normals (float32 table, the JAX package's default;
    no early-out, so the port's own tile and segment length give the same
    image as the TPU's), timed warm, and the plain lattice march.
    Returns {fused, plain (size^2, 4), ms, ssim}."""
    from ..brdf import BRDFLambert
    from ..camera import CameraOnASphere, generate_rays
    from ..models.network_volume import VolumeInterpolationNetwork
    from ..ops.fused_mega import mega_trace_dvr
    from ..raytracer.dvr import (RayEvaluationSteppingDvr, max_steps_bound,
                                 trace_dvr)
    from ..train.losses import ssim
    from ..transfer import TransferFunctionPiecewiseLinear

    dev = torch.device(device)
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.9, 0.6, 0.3], [0.4, 0.6, 1.0]], opacity=[2.0, 20.0],
        positions=[0.0, 1.0])
    brdf = BRDFLambert.make(light=(0.3, -0.8, 0.5), ambient=0.3)
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                        enable_early_out=False,
                                        need_normals=True)
    steps = max_steps_bound(BOX[1], STEPSIZE)
    cam = CameraOnASphere.make(pitch=0.35, yaw=0.8, distance=1.6)
    rs, rd = generate_rays(cam, size, size, device=dev)
    rs, rd = rs.reshape(-1, 3), rd.reshape(-1, 3)
    tft = tf.tensor.to(dev)

    def render():
        return mega_trace_dvr(rs, rd, net, *BOX, tft, stepsize=STEPSIZE,
                              seg=16, enable_early_out=False,
                              need_normals=True, brdf=brdf,
                              table_dtype=torch.float32).color

    with torch.no_grad():
        fused = render()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = render()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        nv = VolumeInterpolationNetwork(net, *BOX)
        plain = trace_dvr(rs, rd, nv, tf.to(dev), cfg, steps, brdf=brdf,
                          lattice=True).color

    def chw(img):
        return img.reshape(1, size, size, 4).permute(0, 3, 1, 2)

    return {"fused": fused, "plain": plain, "ms": ms,
            "ssim": float(ssim(chw(fused), chw(plain)))}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="IMPLICIT:MARSCHNER_LOBB")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--samples", type=int, default=64 * 64 * 4)
    p.add_argument("--eval-samples", type=int, default=8192)
    p.add_argument("--fd-step", type=float, default=1e-3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p.parse_args(argv)


def evaluate(args: argparse.Namespace) -> dict:
    """Train, score the normals and render shaded (see the module doc),
    printing as the JAX script prints. Returns {rows, ms, ssim, train_s}."""
    from ..train.main import _resolve_scene, run
    from ..utils.device import resolve_device
    from .sweep import default_options

    dev = resolve_device(args.device)
    volume, _, _ = _resolve_scene(args.scene)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        opt = default_options(args.scene, f"{tmp}/run.npz")
        opt.update(epochs=args.epochs, samples=args.samples,
                   volumetric_features_channels=8,
                   volumetric_features_resolution=16, device=str(dev))
        net = run(opt)["network"]
    train_s = time.perf_counter() - t0

    rows = normal_rows(net, volume, eval_samples=args.eval_samples,
                       fd_step=args.fd_step, device=dev)
    for r in rows:
        print(f"[gradients] {r['mode']}: cos {r['mean_cosine']:.4f} "
              f"l2 {r['l2']:.4f}", flush=True)
    print("mode     mean_cosine  l2")
    for r in rows:
        print(f"{r['mode']:<8} {r['mean_cosine']:<12.4f} {r['l2']:.4f}")

    out = shaded_render(net, device=dev)
    print(f"[shaded DVR] megakernel in-kernel-adjoint render: "
          f"{out['ms']:.1f} ms at {RENDER_SIZE}^2, SSIM vs plain "
          f"{out['ssim']:.4f}", flush=True)
    return {"rows": rows, "ms": out["ms"], "ssim": out["ssim"],
            "train_s": train_s}


def main(argv=None):
    evaluate(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
