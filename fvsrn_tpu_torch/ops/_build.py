"""Build the port's CUDA sources and load them with ctypes.

Each ``fvsrn_tpu_torch/csrc/<name>.cu`` has a plain C interface and
compiles on its own with ``nvcc`` for ``sm_90a`` into
``build/fvsrn_tpu_torch/<name>-<hash>.so`` at the repository root. The
hash covers the source, the shared headers and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.
No PyTorch header is compiled (that build takes minutes); pointers and
the stream cross as integers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "fvsrn_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every source of the port (csrc/<name>.cu); the megakernel's one per
# hidden width (32, 48, 64), its normals instances too; the per-segment
# engine's normals instances apart from its render's
SOURCES = ("mega_fwd", "mega_fwd48", "mega_fwd64", "mega_fwd_nrm",
           "mega_fwd_nrm48", "mega_fwd_nrm64", "mega_bwd", "mega_bwd48",
           "mega_bwd64", "segment_fwd", "segment_fwd_nrm", "segment_bwd",
           "sample_eval", "probes")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return found


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh"))
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash(name)}.so")


def build(names) -> dict[str, float]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    took (0.0 when already built). The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out[:-3] + ".log", "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}, see {log.name})")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "; ".join(failed))
    return seconds


def ptxas_report(name: str) -> str:
    """The ptxas lines of ``name``'s build log: registers, shared memory,
    stack frame and spills of each kernel ('' if not built here)."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return "".join(line for line in f
                       if "ptxas" in line or "stack frame" in line)


def ptxas_instances(report: str) -> dict[str, tuple[int, int, int, int]]:
    """{mangled kernel: (registers, spill stores, spill loads, stack
    frame bytes)} of a ptxas -v report (:func:`ptxas_report`'s, or
    nvcc's output)."""
    found, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if fn and m:
            stack, st, ld = (int(v) for v in m.groups())
            found[fn] = [None, st, ld, stack]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if fn and m and fn in found:
            found[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items() if v[0] is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib
