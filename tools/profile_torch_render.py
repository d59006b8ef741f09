"""Where the time of the port's product render goes, on one NVIDIA GPU.

    python3 tools/profile_torch_render.py [out.json]

For the dense flagship at 512x512, stepsize 1/512 (the chip_smoke
configuration), per camera of ``LoadedModel.rotation_cameras(4)`` plus
the chip_smoke camera: the fused kernel's time (CUDA events), the whole
frame's time, the samples the frame evaluates and the time per sample.
Then a ``torch.profiler`` window over a few frames of one camera: device
time by kernel name and the device's busy share of the window. Last,
the instruction mix of the built kernel (``cuobjdump -sass``), where
the toolkit has it. Prints the card's name and power limit first, and
writes everything as JSON to ``out.json`` when given.
"""
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = HEIGHT = 512
STEPSIZE = 1.0 / 512
PROFILED_FRAMES = 3


def cuda_ms(fn, iters):
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


def sass_mix(lib_path):
    """Opcode counts of the kernel's SASS, or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    ops = collections.Counter()
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m:
            ops[m.group(1)] += 1
    keep = ("FFMA", "FMUL", "FADD", "LDS", "LDG", "MUFU", "BRA", "BAR",
            "FSETP", "STL", "LDL")
    return {k: v for k, v in sorted(ops.items())
            if k.split(".")[0] in keep}


def lane_efficiency(packet, stepsize, warp=32):
    """Warp lane use of the kernel's sample loop, from the ray packet.

    A warp runs the sample body at lattice point k when any of its 32
    rays has k valid (k >= k0_ray, k*h <= tmax), so its iterations are
    the union of its rays' valid ranges. Returns (valid samples, warp
    iterations, efficiency = valid / (32 * iterations)). The tile vote
    is ignored, so this is the march without early-out."""
    k0 = packet[:, 6].double()
    k1 = torch.floor(packet[:, 7].double() / stepsize)
    live = k1 >= k0
    valid = torch.where(live, k1 - k0 + 1, torch.zeros_like(k0)).sum()
    k0i = torch.where(live, k0, torch.zeros_like(k0)).long()
    k1i = torch.where(live, k1, torch.full_like(k1, -1.0)).long()
    n_warps = packet.shape[0] // warp
    span = int(k1i.max()) + 2
    cover = torch.zeros(n_warps, span, device=packet.device)
    w = torch.arange(packet.shape[0], device=packet.device) // warp
    cover.index_put_((w[live], k0i[live]), torch.ones_like(k0[live]).float(),
                     accumulate=True)
    cover.index_put_((w[live], k1i[live] + 1),
                     -torch.ones_like(k0[live]).float(), accumulate=True)
    iters = (cover.cumsum(dim=1) > 0).sum()
    return int(valid), int(iters), float(valid) / (warp * float(iters))


def main():
    if not torch.cuda.is_available():
        print("profile_torch_render: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fvsrn_tpu_torch.camera import CameraOnASphere
    from fvsrn_tpu_torch.inference import LoadedModel
    from fvsrn_tpu_torch.ops import _build
    from fvsrn_tpu_torch.ops.fused_mega import ray_packet
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    from fvsrn_tpu_torch.scenes import dense_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build(["mega_fwd"])
    _, tf, npz = dense_scene()
    model = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=STEPSIZE))
    cams = {f"rotation{i}": c for i, c in
            enumerate(LoadedModel.rotation_cameras(4))}
    cams["smoke"] = CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6)
    rows = {}
    renders = {}
    for name, cam in cams.items():
        t0 = time.perf_counter()
        r = model.prepare_network_render(cam, WIDTH, HEIGHT, "FUSED")
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        renders[name] = r
        _, samples = r.march(return_samples=True)
        n = int(samples.sum())
        kernel_ms = cuda_ms(lambda: r.march(), 5)
        frame_ms = cuda_ms(r, 5)
        valid, iters, eff = lane_efficiency(
            ray_packet(r.ray_start, r.ray_dir, r.box_min, r.box_size,
                       STEPSIZE, r.tmax_clip), STEPSIZE)
        rows[name] = dict(samples=n, samples_per_ray=n / (WIDTH * HEIGHT),
                          kernel_ms=kernel_ms, frame_ms=frame_ms,
                          ns_per_sample=kernel_ms * 1e6 / n,
                          planning_s=plan_s, samples_without_vote=valid,
                          warp_iterations=iters, lane_efficiency=eff)
        print(f"{name}: {json.dumps(rows[name])}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    r = renders["smoke"]
    r()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_FRAMES):
            r()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels[ev.key] = dict(device_ms=dev_us / 1e3 / PROFILED_FRAMES,
                                   calls=ev.count / PROFILED_FRAMES)
    busy_ms = sum(k["device_ms"] for k in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])
    prof_out = dict(frames=PROFILED_FRAMES, wall_ms_per_frame=wall_ms
                    / PROFILED_FRAMES, device_busy_ms_per_frame=busy_ms,
                    busy_share=busy_ms * PROFILED_FRAMES / wall_ms,
                    kernels=dict(top[:12]))
    print("profile:", json.dumps(prof_out), flush=True)
    mix = sass_mix(_build.library_path("mega_fwd"))
    print("sass:", json.dumps(mix), flush=True)
    out = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
               cameras=rows, profile=prof_out, sass=mix,
               ptxas=_build.ptxas_report("mega_fwd"))
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
