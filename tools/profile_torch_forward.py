"""Where the two forward marches (csrc/segment_fwd.cu, csrc/mega_fwd.cu)
spend their time: each built with -DSMLP_PROFILE, whose clock64 phase
timers (march_common.cuh) sum the cycles of every lane by phase, at
chip_smoke.py's shapes: route 2 of the dense flagship at 1920x1080
(phase A, both launches of the call) and route 1 at 512x512 (phases 4-6),
stepsize 1/512, the smoke camera, bf16 table. The phases: building the
tile's rows (position, Fourier features, latent fetch), the network's
layers, the head and TF, compositing, the tile vote's barrier (route 1),
and the rest (sample masks, lists, loop control). Shares are of the
summed lane cycles, so a phase in which lanes idle counts its full
length. Also times each kernel as built for the port (CUDA events).

    python3 tools/profile_torch_forward.py [out.json]

Needs one CUDA card and nvcc; prints one JSON object.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fvsrn_tpu_torch.camera import CameraOnASphere  # noqa: E402
from fvsrn_tpu_torch.inference import LoadedModel  # noqa: E402
from fvsrn_tpu_torch.ops import _build  # noqa: E402
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr  # noqa
from fvsrn_tpu_torch.scenes import dense_scene  # noqa: E402

# march_common.cuh's timer indices of the forwards
PHASES = {0: "rows", 1: "layers", 2: "head and TF", 3: "compositing",
          4: "vote barrier", 5: "masks, lists, control"}
CASES = {"segment_fwd": (1920, 1080, "segment"),
         "mega_fwd": (512, 512, "mega")}


def cuda_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def profiled_library(name: str) -> ctypes.CDLL:
    so = os.path.join(_build.BUILD_DIR, f"{name}-profile.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-DSMLP_PROFILE", "-o", so,
                    os.path.join(_build.CSRC_DIR, f"{name}.cu")],
                   check=True)
    return ctypes.CDLL(so)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    _, tf, npz = dense_scene()
    model = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=1 / 512))
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6)
    _build.build(list(CASES))
    result = {"device": torch.cuda.get_device_name(0)}
    for name, (w, h, route) in CASES.items():
        render = model.prepare_network_render(cam, w, h, "FUSED")
        assert render.route == route, render.route
        kernel_ms = cuda_ms(render.march)
        built = _build._LIBS.get(name)
        lib = _build._LIBS[name] = profiled_library(name)
        buf = (ctypes.c_ulonglong * 16)()
        profiled_ms = cuda_ms(render.march)
        lib.smlp_prof_read(buf)            # reset; then one call read
        render.march()
        torch.cuda.synchronize()
        lib.smlp_prof_read(buf)
        _build._LIBS[name] = built
        total = sum(buf[i] for i in PHASES)
        result[name] = {
            "shape": [w, h], "kernel_ms": kernel_ms,
            "profiled_ms": profiled_ms, "warp_cycles": total,
            "share": {p: buf[i] / max(total, 1) for i, p in PHASES.items()}}
    line = json.dumps(result)
    print(line)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
