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

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "fvsrn_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every source of the port (csrc/<name>.cu); the megakernel's one per
# hidden width (32, 48, 64; 128 below) and ray tile (256; 128 in the _t128
# sources),
# the forward in five parts (SnakeAlt on the piecewise TF, SnakeAlt on the
# other TF modes, every other network on the piecewise TF, every other
# network on the texture and preintegrated TFs and on the Gaussians:
# mega_fwd.cuh's MEGA_PART), the last two and the normals instances on
# 256-ray tiles only (the render's and the screen trainer's tile); the
# per-segment engine's forward in four (the piecewise TF, the other modes
# of SnakeAlt networks, the texture and preintegrated TFs of every other
# activation, their Gaussians), its normals instances apart from its
# render's; the width-128 instances last
_TILE256_ONLY = ("mega_fwd_nrm", "mega_fwd_anytf", "mega_fwd_anyg")
MEGA_SOURCES = tuple(f"{kind}{w}{t}"
                     for kind in ("mega_fwd", "mega_fwd_tf", "mega_fwd_any",
                                  "mega_fwd_nrm", "mega_bwd",
                                  "mega_fwd_anytf", "mega_fwd_anyg")
                     for t in ("", "_t128") for w in ("", "48", "64")
                     if not (kind in _TILE256_ONLY and t))
# the width-128 instances (the wide plans: hidden matrices in device
# memory), 256-ray tiles; the normals instances last
WIDE_SOURCES = tuple(f"{kind}128" for kind in (
    "mega_fwd", "mega_fwd_tf", "mega_fwd_any", "mega_fwd_anytf",
    "mega_fwd_anyg", "mega_bwd", "segment_fwd", "segment_fwd_tf",
    "segment_fwd_anytf", "segment_fwd_anyg", "segment_bwd", "sample_eval",
    "mega_fwd_nrm", "segment_fwd_nrm"))
SOURCES = MEGA_SOURCES + ("segment_fwd", "segment_fwd_tf", "segment_fwd_nrm",
                          "segment_bwd", "sample_eval", "probes",
                          "segment_fwd_anytf", "segment_fwd_anyg"
                          ) + WIDE_SOURCES

_LIBS: dict[str, ctypes.CDLL] = {}
_PENDING: dict[str, concurrent.futures.Future] = {}
_RUNNING: set = set()
_LOCK = threading.Lock()
_STOPPED = False
WAITED: dict[str, float] = {}
FINISHED: dict[str, float] = {}   # perf_counter() at each build's end


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
    """The flags, ``name``'s source, the sources it includes and every
    header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src) as f:
        included = re.findall(r'#include "(\w+\.cu)"', f.read())
    paths = [src] + [os.path.join(CSRC_DIR, f) for f in included] + sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh"))
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash(name)}.so")


def _compile(name: str, nice: int) -> float:
    """Compile ``name`` unless built; the seconds its ``nvcc`` took."""
    out = library_path(name)
    if os.path.exists(out):
        return 0.0
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    if nice and shutil.which("nice"):
        cmd = ["nice", "-n", str(nice)] + cmd
    t0 = time.perf_counter()
    with open(out[:-3] + ".log", "w") as log:
        with _LOCK:
            if _STOPPED:
                raise RuntimeError(f"CUDA build of {name} stopped")
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT)
            _RUNNING.add(proc)
        try:
            rc = proc.wait()
        finally:
            with _LOCK:
                _RUNNING.discard(proc)
    if rc != 0:
        raise RuntimeError(f"CUDA build failed: {name} (nvcc exit {rc}, "
                           f"see {log.name})")
    os.replace(tmp, out)
    FINISHED[name] = time.perf_counter()
    return FINISHED[name] - t0


def start(names, jobs: int | None = None, nice: int = 0) -> dict:
    """Compile every source in ``names`` that is not built yet, in the
    background: at most ``jobs`` ``nvcc`` at a time (all at once by
    default), started in the order given, each at niceness ``nice``.
    Returns {name: future of the seconds its nvcc took}; :func:`load` and
    :func:`ptxas_report` wait for a source still building, and raise if
    its build failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = [n for n in names if n not in _PENDING]
    if names:
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=jobs or len(names), thread_name_prefix="nvcc")
        for name in names:
            _PENDING[name] = pool.submit(_compile, name, nice)
        pool.shutdown(wait=False)
    return {n: _PENDING[n] for n in names}


def build(names) -> dict[str, float]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together, and wait for them. Returns
    the seconds each took (0.0 when already built). The ptxas report
    (registers, shared memory, spills) is kept beside each library as
    ``.log``."""
    start(names)
    seconds, failed = {}, []
    for name in names:
        try:
            seconds[name] = _PENDING[name].result()
        except RuntimeError as e:
            failed.append(str(e))
    if failed:
        raise RuntimeError("; ".join(failed))
    return seconds


def stop() -> None:
    """Kill every ``nvcc`` this process started and start no more (a
    caller that fails while sources still build in the background)."""
    global _STOPPED
    with _LOCK:
        _STOPPED = True
        for proc in _RUNNING:
            proc.kill()


def _wait(name: str) -> None:
    """Wait for ``name``'s background build; the seconds waited go to
    ``WAITED`` (the build's share of a caller's critical path)."""
    fut = _PENDING.get(name)
    if fut is not None:
        t0 = time.perf_counter()
        fut.result()
        WAITED[name] = WAITED.get(name, 0.0) + time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The ptxas lines of ``name``'s build log: registers, shared memory,
    stack frame and spills of each kernel ('' if not built here)."""
    _wait(name)
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
        _wait(name)
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib
