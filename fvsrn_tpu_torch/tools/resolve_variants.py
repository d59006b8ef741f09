"""Variants of row 11's kernel (``resolve_kernel`` of ``csrc/probes.cu``)
timed against each other on the card.

Each variant is a copy of ``probes.cu`` with one of its constants changed
by text (lanes that share a table row, warps a block, channels a lane,
programmatic dependent launch), built by ``nvcc`` into
``build/resolve_variants/``. Each is checked against
``onehot_resolve_plain`` (exactly, at the tools' shapes), then
timed at the tools' shapes (a (sz3p, 128) bf16 table, 8192 row ids) in a
CUDA graph of 400 launches, every variant once in turn and again in the
reverse order. ``--extra name=path`` adds another ``probes.cu`` (another
commit's) to the same turns. Two diagnostics are timed beside them and
not checked: the stores alone, and the row ids without the table.

    python -m fvsrn_tpu_torch.tools.resolve_variants [--extra parent=...]

Card only. Prints one line per variant and size with both times.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, probes
from ._timing import us_per_call

SOURCE = os.path.join(_build.PKG_DIR, "csrc", "probes.cu")
OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "resolve_variants")
ROW_LANES = "constexpr int kRowLanes = 4;"
WARPS = "constexpr int kResolveWarps = 4;"
WIDE = "  if (c % 8 == 0)\n    return n % 4"
# programmatic dependent launch: the next launch's blocks are scheduled
# while this one runs and wait (griddepcontrol.wait) for its completion
PDL = [
    ("  const int lane = threadIdx.x & 31;\n  const long n_groups",
     '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n'
     '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     "  const int lane = threadIdx.x & 31;\n  const long n_groups"),
    ("  resolve_kernel<V, vec><<<(unsigned)blocks, 32 * kResolveWarps, 0,\n"
     "                           stream>>>(tab, rows, c, lrow, out, n);",
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3((unsigned)blocks);\n"
     "  cfg.blockDim = dim3(32 * kResolveWarps);\n"
     "  cfg.stream = stream;\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
     "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n"
     "  cfg.attrs = attr;\n"
     "  cfg.numAttrs = 1;\n"
     "  cudaLaunchKernelEx(&cfg, resolve_kernel<V, vec>, tab, rows, c, "
     "lrow, out, n);")]
ROW_IDS = "const int4 q = *reinterpret_cast<const int4*>(lrow + s0);"
ROWS = "  if (l >= 0 && l < rows) {"
VARIANTS = {
    "B4 (as built)": [],
    "B4, programmatic dependent launch": PDL,
    "B1": [(ROW_LANES, "constexpr int kRowLanes = 1;")],
    "B2": [(ROW_LANES, "constexpr int kRowLanes = 2;")],
    "B8": [(ROW_LANES, "constexpr int kRowLanes = 8;")],
    "B4, 2 warps a block": [(WARPS, "constexpr int kResolveWarps = 2;")],
    "B4, 8 warps a block": [(WARPS, "constexpr int kResolveWarps = 8;")],
    "B8, 4 channels a lane": [
        (ROW_LANES, "constexpr int kRowLanes = 8;"),
        (WIDE, "  if (false)\n    return n % 4")],
}
# diagnostics, not the function (their output is not checked): the
# kernel's stores alone (no row id or table load), and the row ids
# without the table rows (each id stored, so its load is kept)
DIAGNOSTICS = {
    "stores only": [
        (ROW_IDS, "const int4 q = make_int4(-1, -1, -1, -1);")],
    "row ids, no rows": [(ROWS, "  r.w[0] = (uint32_t)l;\n  if (false) {")],
}
ITERS = 400


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _variant_source(name: str, subs) -> str:
    text = open(SOURCE).read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in probes.cu")
        text = text.replace(old, new)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, _slug(name) + ".cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(sources: dict) -> dict:
    """{name: ctypes entry point}, one nvcc per source, all at once."""
    procs = {}
    for name, src in sources.items():
        so = os.path.join(OUT_DIR, _slug(name) + ".so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        fn = ctypes.CDLL(so).onehot_resolve_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _inputs(sz3p: int, n: int, dev):
    tab = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (sz3p, 128)).astype(np.float32)).to(dev).to(torch.bfloat16)
    lrow = torch.from_numpy(np.random.default_rng(1).integers(
        0, sz3p, (1, n)).astype(np.int32)).to(dev)
    return tab, lrow


def _call(fn, tab, lrow):
    n = lrow.numel()
    out = torch.empty(tab.shape[1], n, dtype=torch.float32,
                      device=tab.device)
    err = fn(tab.data_ptr(), tab.shape[0], tab.shape[1], lrow.data_ptr(),
             out.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def run(extra: dict) -> dict:
    """{(sz3p, name): [us, us]} for every variant and ``extra`` source."""
    dev = torch.device("cuda")
    sources = {name: _variant_source(name, subs)
               for name, subs in {**VARIANTS, **DIAGNOSTICS}.items()}
    sources.update(extra)
    fns = build(sources)
    for sz3p, n in ((128, 8192), (928, 8192), (928, 8193)):
        tab, lrow = _inputs(sz3p, n, dev)
        want = probes.onehot_resolve_plain(tab, lrow)
        for name, fn in fns.items():
            if name in DIAGNOSTICS:
                _call(fn, tab, lrow)
            elif not torch.equal(_call(fn, tab, lrow), want):
                raise AssertionError(f"{name} differs from the plain version "
                                     f"at sz3p {sz3p}, n {n}")
    order = list(fns) + list(fns)[::-1]
    times = {}
    for sz3p in (128, 928):
        tab, lrow = _inputs(sz3p, 8192, dev)
        for name in order:
            us = us_per_call(lambda: _call(fns[name], tab, lrow), ITERS, dev,
                             graph=True)
            times.setdefault((sz3p, name), []).append(us)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", action="append", default=[],
                    help="name=path of another probes.cu")
    args = ap.parse_args(argv)
    extra = dict(e.split("=", 1) for e in args.extra)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for (sz3p, name), us in run(extra).items():
        print(f"resolve sz3p {sz3p} {name}: "
              + " / ".join(f"{u:.3f}" for u in us) + " us/launch",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
