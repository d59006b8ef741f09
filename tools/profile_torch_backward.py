"""Where the per-segment backward (csrc/segment_bwd.cu) spends its time:
the phases of the batched sample MLP (csrc/sample_mlp.cuh) timed by
clock64 on thread 0 of each block, in a build with -DSMLP_PROFILE, at
chip_smoke.py's phase F shapes (the flagship at 512x512, stepsize 1/512,
the smoke camera, row-major rays). Each phase ends at a block barrier, so
its share is of the blocks' time; the timers' own atomics inflate the
short phases. Also times the kernel as built for the port (CUDA events).

    python3 tools/profile_torch_backward.py [out.json]

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

from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays  # noqa
from fvsrn_tpu_torch.ops import _build, fused_dvr  # noqa: E402
from fvsrn_tpu_torch.ops.fused_dvr_bwd import launch_segment_bwd  # noqa
from fvsrn_tpu_torch.raytracer.dvr import max_steps_bound  # noqa: E402
from fvsrn_tpu_torch.scenes import dense_scene  # noqa: E402
from fvsrn_tpu_torch.train.checkpoints import load_weights  # noqa: E402

# sample_mlp.cuh's timer indices
PHASES = {0: "A build rows", 1: "A forward", 2: "A head", 3: "B recurrence",
          4: "C build rows", 5: "C forward", 6: "C head",
          7: "C output layer", 8: "C hidden layers", 9: "C first layer",
          14: "C biases, Fourier, TF", 10: "C latent scatter"}
INNER = {12: "forward layers (A and C)"}


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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    box, h = ((-0.5,) * 3, (1.0,) * 3), 1 / 512
    _, tf, npz = dense_scene()
    net = load_weights(npz).to(dev)
    tf_d = tf.tensor.to(dev)
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.5,
                                                distance=1.6), 512, 512,
                           device=dev)
    rs, rd = rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    spec, rays, kbase = fused_dvr._segment_setup(
        rs, rd, net, *box, density_min=0.0, density_max=1.0,
        blend_mode="beer_lambert", alpha_early_out=0.999, seg=32, tile=256,
        differentiable=True, latent_mode="table", table_dtype=torch.float32,
        n_seg=None, need_normals=False, iso_value=None, tf_mode="piecewise",
        tmax_clip=None, stepsize=h, max_steps=max_steps_bound(box[1], h),
        enable_early_out=False)
    weights = fused_dvr.pack_segment_weights(net, tf_d)
    table = fused_dvr.segment_table(net, torch.float32, dev)
    out, _, carries, death = fused_dvr.launch_segment(
        spec, net, rays, kbase, weights, table, tf_d.shape[0],
        store_carries=True)
    d_out = torch.empty(out.shape, device=dev).uniform_(
        -1, 1, generator=torch.Generator(dev).manual_seed(3)) / out.numel()
    args = (spec, net, rays, kbase, weights, table, carries, death, d_out,
            tf_d.shape[0])
    kernel_ms = cuda_ms(lambda: launch_segment_bwd(*args))

    so = os.path.join(_build.BUILD_DIR, "segment_bwd-profile.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-DSMLP_PROFILE", "-o", so,
                    os.path.join(_build.CSRC_DIR, "segment_bwd.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    _build._LIBS["segment_bwd"] = lib
    buf = (ctypes.c_ulonglong * 16)()
    profiled_ms = cuda_ms(lambda: launch_segment_bwd(*args))
    lib.smlp_prof_read(buf)                # reset; then one launch read
    launch_segment_bwd(*args)
    torch.cuda.synchronize()
    lib.smlp_prof_read(buf)
    total = sum(buf[i] for i in PHASES)
    result = {
        "device": torch.cuda.get_device_name(0), "kernel_ms": kernel_ms,
        "profiled_ms": profiled_ms,
        "blocks": -(-rays.shape[0] // 64),
        "block_cycles": total,
        "share": {name: buf[i] / total for i, name in PHASES.items()},
        "inner_share": {name: buf[i] / total for i, name in INNER.items()}}
    line = json.dumps(result)
    print(line)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
