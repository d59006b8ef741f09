"""Device times of the frames and training steps that the TF's read path
and the narrow normals instances run, to compare checkouts on one card.

    python3 tools/time_tf_paths.py --root <checkout> --parts P B K --build
    python3 tools/time_tf_paths.py --root <checkout> --parts P B K \
        [--knots N ...]

Imports ``fvsrn_tpu_torch`` from ``<checkout>`` (its kernels build into
that checkout's ``build/``). ``--build`` starts every source the parts
load (one nvcc each, all at once) and waits for them. Otherwise it times
the parts with CUDA events, the mean of ITERS calls after a warm-up:

- ``P``: the dense flagship's Phong-shaded 512^2 frame (stepsize 1/512)
  on rows 1 and 4, the 32-wide normals instances (``mega_fwd_nrm``,
  ``segment_fwd_nrm``);
- ``B``: a training step (forward and backward of mean(img^2)) and the
  differentiable forward alone on random SnakeAlt networks (14 Fourier
  features, a sigmoid density head, an 8x16^3 latent grid) at 256^2:
  the megakernel at width 64 and the per-segment engine at widths 32 and
  48, each under the ramp (piecewise, 3 knots) and four Gaussians;
- ``K``: the flagship's 512^2 frame on both engines and a training step
  on each, with the ramp as its own 3 knots and resampled to each count
  of ``--knots``.

Prints one JSON object: {case: milliseconds}. Run it from each checkout
in turns (A, B, B, A) in one call and compare within that call."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ITERS = 5
SIZE = 512
STEP_SIZE = 256
STEPSIZE = 1.0 / 512
BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
CAMERA = dict(pitch=0.3, yaw=0.5, distance=1.6)
BRDF = dict(enable_phong=True, ambient=0.2, specular=0.3,
            magnitude_center=0.02, magnitude_radius=0.02,
            light=(0.3, -0.5, -1.0))
GAUSSIANS = [[0.1, 0.1, 0.8, 6.0, 0.25, 0.12], [0.9, 0.4, 0.1, 12.0, 0.5, 0.1],
             [1.0, 0.7, 0.3, 20.0, 0.72, 0.1], [1.0, 1.0, 0.6, 30.0, 0.95, 0.08]]
# (engine, hidden width): the backward instances the TF's read path touches
STEPS = (("mega", 64), ("segment", 32), ("segment", 48))
SOURCES = {"P": ("mega_fwd_nrm", "segment_fwd_nrm"),
           "B": ("mega_fwd64", "mega_fwd_tf64", "mega_bwd64", "segment_fwd",
                 "segment_fwd_tf", "segment_bwd"),
           "K": ("mega_fwd", "mega_bwd", "segment_fwd", "segment_bwd")}


def ramp_knots(ramp, n):
    """The ramp TF resampled to ``n`` evenly spaced knots."""
    import torch
    pos = torch.linspace(0.0, 1.0, n)
    rgba = ramp.eval_normalized(pos, None, None, 1.0)
    return torch.cat([rgba, pos[:, None]], dim=1)


def timed(fn):
    """Mean device milliseconds of ``fn`` over ITERS calls (host
    milliseconds of one call on the CPU)."""
    import torch
    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--parts", nargs="+", choices=sorted(SOURCES),
                    default=sorted(SOURCES))
    ap.add_argument("--knots", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cpu: the plain versions, to check the script")
    ap.add_argument("--size", type=int, nargs=2, default=(SIZE, STEP_SIZE),
                    help="frame and training sizes")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from fvsrn_tpu_torch.ops import _build
    if args.build:
        t0 = time.perf_counter()
        _build.build(sorted({s for p in args.parts for s in SOURCES[p]}))
        print(json.dumps({"root": args.root,
                          "build_s": time.perf_counter() - t0}))
        return 0
    from fvsrn_tpu_torch.brdf import BRDFLambert
    from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
    from fvsrn_tpu_torch.models.latent import LatentSpace
    from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
    from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
    from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
    from fvsrn_tpu_torch.raytracer.dvr import max_steps_bound
    from fvsrn_tpu_torch.scenes import dense_scene
    from fvsrn_tpu_torch.train.checkpoints import load_weights

    dev = torch.device(args.device)
    steps = max_steps_bound(BOX[1], STEPSIZE)
    cam = CameraOnASphere.make(**CAMERA)
    _, ramp_tf, npz = dense_scene()
    flagship = load_weights(npz).to(dev)
    phong = BRDFLambert.make(**BRDF)
    ramp = ramp_tf.tensor.to(dev)
    gauss = torch.tensor(GAUSSIANS, device=dev)

    def rays(size):
        rs, rd = generate_rays(cam, size, size, device=dev)
        perm, _ = block_ray_permutation(size, size, 16, 16, device=dev)
        rs, rd = rs.reshape(-1, 3), rd.reshape(-1, 3)
        return ({"mega": (rs[perm].contiguous(), rd[perm].contiguous()),
                 "segment": (rs.contiguous(), rd.contiguous())})

    def march(engine, r, net, tf, **kw):
        if engine == "mega":
            return fused_mega.mega_trace_dvr(*r, net, *BOX, tf,
                                             stepsize=STEPSIZE, **kw)
        return fused_dvr.fused_trace_dvr(*r, net, *BOX, tf, stepsize=STEPSIZE,
                                         max_steps=steps, **kw)

    def step(engine, r, net, tf, **kw):
        kw = dict(kw, differentiable=True)
        if engine == "segment":
            kw["enable_early_out"] = False

        def run():
            net.zero_grad(set_to_none=True)
            leaf = tf.detach().clone().requires_grad_(True)
            img = march(engine, r, net, leaf, **kw)
            (img ** 2).mean().backward()
        return run

    def forward(engine, r, net, tf, **kw):
        kw = dict(kw, differentiable=True)
        if engine == "segment":
            kw["enable_early_out"] = False

        def run():
            with torch.no_grad():
                march(engine, r, net, tf, **kw)
        return run

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if dev.type == "cuda" else "cpu"}
    big = rays(args.size[0])
    for engine in ("mega", "segment") if "P" in args.parts else ():
        out[f"P {engine} shaded"] = timed(lambda: march(
            engine, big[engine], flagship, ramp, need_normals=True,
            brdf=phong))
    small = rays(args.size[1])
    for engine, width in STEPS if "B" in args.parts else ():
        grid = torch.randn(8, 16, 16, 16,
                           generator=torch.Generator().manual_seed(7)) * 0.3
        net = SceneRepresentationNetwork.make(
            layers=":".join([str(width)] * 3), num_fourier=14,
            output_mode="density", seed=7,
            latent=LatentSpace(static_grid=grid)).to(dev)
        for name, tf, kw in (("ramp", ramp, {}),
                             ("gauss4", gauss, {"tf_mode": "gaussian"})):
            case = f"B {engine} {width} {name}"
            out[f"{case} step"] = timed(step(engine, small[engine], net, tf,
                                             **kw))
            out[f"{case} fwd"] = timed(forward(engine, small[engine], net,
                                               tf, **kw))
    for n in [3] + args.knots if "K" in args.parts else ():
        tf = ramp if n == 3 else ramp_knots(ramp_tf, n).to(dev)
        for engine in ("mega", "segment"):
            out[f"K {engine} {n} frame"] = timed(lambda: march(
                engine, big[engine], flagship, tf))
            out[f"K {engine} {n} step"] = timed(step(engine, big[engine],
                                                     flagship, tf))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
