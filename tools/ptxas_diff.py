"""Registers and spills of the port's CUDA kernels against another
checkout's, instance by instance (card machine: needs nvcc).

    python3 tools/ptxas_diff.py <other checkout> [source ...]

Builds each named source (default: mega_fwd mega_bwd) of
``fvsrn_tpu_torch/csrc`` in this checkout (``ops/_build.build``, reusing a
library already built, and its ptxas report) and in the other one with
``ops/_build.NVCC_FLAGS`` (ptxas -v) into ``build/ptxas_diff/``, every
nvcc started together, and prints
for every kernel instance both checkouts compile its registers, spill
stores and loads and stack frame, then how many agree. An instance is
matched by its mangled name, with the template arguments a later
checkout may have added to the megakernels taken out: the hidden width
first (``Li32E`` after the name) and a last activation argument of
SnakeAlt (``Li6E``), so that the width-32 SnakeAlt instances of
``mega_fwd_kernel<H, Table, kMasked, TFM, ACT>`` meet those of
``mega_fwd_kernel<Table, kMasked, TFM>``; and a last ``false`` (``Lb0E``),
so that ``mega_bwd_kernel<H, TFM, kRay = false>`` meets
``mega_bwd_kernel<H, TFM>`` (the ray-gradient instances have no
counterpart in an older checkout).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fvsrn_tpu_torch.ops import _build  # noqa: E402


def start_nvcc(csrc: str, name: str, out_dir: str) -> subprocess.Popen:
    """nvcc on ``csrc/<name>.cu``, its output (the ptxas report) piped."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
           os.path.join(out_dir, f"{name}.so"),
           os.path.join(csrc, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def key(name: str) -> str:
    """The instance's name from the kernel's own name on (the anonymous
    namespace's mangled name carries a hash of the source's path), with
    a width-32 first argument and a SnakeAlt last argument taken out
    (see the module doc)."""
    end = name.find("_kernelI") + len("_kernel")
    for n in range(len("_kernel") + 1, end + 1):   # <length><identifier>
        if name[end - n - len(str(n)):end - n] == str(n):
            name = name[end - n:]
            break
    name = re.sub(r"(kernel)ILi32E", r"\1I", name)
    name = re.sub(r"Lb0E(E+v)", r"\1", name)   # the backward's kRay false
    return re.sub(r"Li6E(E+v)", r"\1", name)


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    other = os.path.join(os.path.abspath(argv[0]), "fvsrn_tpu_torch", "csrc")
    names = argv[1:] or ["mega_fwd", "mega_bwd"]
    out = os.path.join(ROOT, "build", "ptxas_diff")
    procs = {n: start_nvcc(other, n, out) for n in names}
    _build.build(names)
    equal = total = 0
    for name in names:
        log, _ = procs[name].communicate()
        if procs[name].returncode != 0:
            raise RuntimeError(f"nvcc failed on {other}/{name}.cu:\n{log}")
        with open(_build.library_path(name)[:-3] + ".log") as f:
            ours = _build.ptxas_instances(f.read())
        with open(os.path.join(out, f"{name}.log"), "w") as f:
            f.write(log)
        theirs = {key(k): v for k, v in _build.ptxas_instances(log).items()}
        print(f"{name}: {len(ours)} instances here, {len(theirs)} in the "
              f"other checkout")
        for k, v in sorted(ours.items()):
            w = theirs.get(key(k))
            if w is None:
                continue
            total += 1
            equal += (v[:3] == w[:3])
            print(f"{name} {k}: registers {v[0]} / {w[0]}, spill stores "
                  f"{v[1]} / {w[1]}, spill loads {v[2]} / {w[2]}, stack "
                  f"{v[3]} / {w[3]}{'' if v[:3] == w[:3] else '  DIFFERS'}")
    print(f"ptxas_diff: registers and spills equal on {equal} of {total} "
          f"instances both checkouts compile (this / other)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
