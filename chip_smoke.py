"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, renders the dense
flagship through the product path (``LoadedModel.prepare_network_render``
in FUSED mode, 512x512, world stepsize 1/512), holds each kernel against
its plain PyTorch version and the render against the plain lattice
oracle, times the render, and prints one JSON line per kernel and a last
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Exits non-zero without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

import torch

WIDTH = HEIGHT = 512
STEPSIZE = 1.0 / 512
CAMERA = dict(pitch=0.3, yaw=0.5, distance=1.6)
KERNEL_TOL = 1e-4      # kernel vs its plain version, same inputs
ORACLE_TOL = 2e-2      # bf16-table render vs the f32 lattice oracle
TIMED_CAMERAS = 4
# H100 SXM published dense peaks (NVIDIA data sheet) at 700 W
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters):
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after one
    warm-up call (CUDA events)."""
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


def sample_flops(net):
    """Floating-point operations of one evaluated sample, from the weight
    shapes: Fourier projection, the MLP's multiply-adds, the trilerp of
    16 channels over 8 corners with its weights, TF and compositing."""
    f = net.input.num_fourier
    mlp = sum(l.weight.numel() for l in net.layers)
    trilerp = 8 * 16 * 2 + 8 * 3
    return 2 * (3 * f + mlp) + trilerp + 24


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from fvsrn_tpu_torch.camera import CameraOnASphere
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.ops import _build, fused_mega
    from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                               max_steps_bound, trace_dvr)
    from fvsrn_tpu_torch.scenes import dense_scene

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {kind} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build every kernel of the path (one nvcc per source, together)
    t0 = time.perf_counter()
    secs = _build.build(["mega_fwd"])
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    print(_build.ptxas_report("mega_fwd").strip(), flush=True)

    # 3. the main path: product render of the dense flagship
    tf, npz = dense_scene()
    cfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE)
    model = LoadedModel.from_checkpoint(npz, tf=tf, config=cfg)
    cam = CameraOnASphere.make(**CAMERA)
    t0 = time.perf_counter()
    render = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    fused_mega.LAUNCHES = 0
    img = render()
    torch.cuda.synchronize()
    launches = fused_mega.LAUNCHES
    check(tuple(img.shape) == (HEIGHT, WIDTH, 4), f"shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    amax = float(img[..., 3].max())
    check(amax > 0.5, f"alpha max {amax}")
    check(launches > 0, "the render did not launch mega_fwd")
    print(f"phase 3 render: {WIDTH}x{HEIGHT} h=1/{round(1 / STEPSIZE)} "
          f"alpha max {amax:.4f}, mega_fwd launches {launches}, "
          f"planning {plan_s:.2f} s", flush=True)

    # 4. kernel vs its plain version on the same rays and clip
    got, samples = render.march(return_samples=True)
    plain, samples_plain = render.march(fused_mega.mega_trace_dvr_plain,
                                        return_samples=True)
    err = float((got - plain).abs().max())
    n_samples = int(samples.sum())
    n_samples_plain = int(samples_plain.sum())
    print(f"phase 4 kernel vs plain: max|d| {err:.3e} (tol {KERNEL_TOL}), "
          f"samples {n_samples} vs {n_samples_plain}", flush=True)
    check(err <= KERNEL_TOL, f"kernel vs plain {err}")

    # 5. kernel vs the f32 lattice oracle (bf16-table contract)
    vol = VolumeInterpolationNetwork(render.network, model.box_min,
                                     model.box_size)
    ocfg = RayEvaluationSteppingDvr.make(stepsize=STEPSIZE,
                                         enable_early_out=False)
    oracle = trace_dvr(render.ray_start, render.ray_dir, vol, render.tf,
                       ocfg, max_steps_bound(model.box_size, STEPSIZE),
                       tmax_in=render.tmax_clip, lattice=True).color
    oerr = float((got - oracle).abs().max())
    print(f"phase 5 kernel vs lattice oracle: max|d| {oerr:.3e} "
          f"(tol {ORACLE_TOL})", flush=True)
    check(oerr < ORACLE_TOL, f"kernel vs oracle {oerr}")

    # 6. timing
    mean_ms, std_ms, frames = model.time_rendering(
        LoadedModel.rotation_cameras(TIMED_CAMERAS), WIDTH, HEIGHT)
    kernel_ms = cuda_ms(lambda: render.march(), 10)
    plain_ms = cuda_ms(
        lambda: render.march(fused_mega.mega_trace_dvr_plain), 1)
    flops = n_samples * sample_flops(render.network)
    table_bytes = 16 * render.network.latent.static_grid[0].numel() * 2
    n_rays = WIDTH * HEIGHT
    io_bytes = n_rays * (6 + 1 + 4) * 4 + table_bytes + 15_000
    bound_s = max(flops / PEAK_BF16_TC, io_bytes / PEAK_BYTES)
    bound_f32_s = max(flops / PEAK_F32, io_bytes / PEAK_BYTES)
    print(f"phase 6 timing [{smi}]: product render {mean_ms:.3f} ms/frame "
          f"(std {std_ms:.3f}, {len(frames)} cameras), "
          f"{n_rays / mean_ms / 1e3:.3f} Mrays/s; kernel {kernel_ms:.3f} ms; "
          f"plain {plain_ms:.1f} ms; samples/frame {n_samples} "
          f"({n_samples / n_rays:.1f}/ray); bound {bound_s * 1e3:.4f} ms "
          f"(bf16 tensor cores, share {bound_s * 1e3 / kernel_ms:.4f}), "
          f"{bound_f32_s * 1e3:.4f} ms (f32 CUDA cores, share "
          f"{bound_f32_s * 1e3 / kernel_ms:.4f}), bound by operations "
          f"({flops / 1e9:.1f} GFLOP, {io_bytes / 1e6:.1f} MB)", flush=True)

    # 7. kernels
    print(json.dumps({"kernels": [{
        "name": "mega_fwd", "route": "cuda",
        "source": "fvsrn_tpu_torch/csrc/mega_fwd.cu",
        "replaces": "fvsrn_tpu/ops/fused_mega.py:274",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "operations", "library_ms": None,
        "bound_f32_ms": bound_f32_s * 1e3, "frame_ms": mean_ms,
        "samples": n_samples, "oracle_max_abs_err": oerr}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
