"""The lane-table gather probes (``tools/probe_lane_gather.py`` of the JAX
package) on the port's kernels, ``csrc/probes.cu``.

Shapes of the sub-box latent resolve: a (128, 128) table gathered along
its rows by (128, N=8192) int32 indices (float32 and bf16 table), the same
gather from a (128, 928) table, and the resolve of (1, N) row ids from a
bf16 (sz3p, 128) table into float32 (128, N) for sz3p 128 and 928. Each
is checked against the JAX tool's NumPy oracle and timed over ``ITERS``
launches: on the card captured in a CUDA graph (the device's time, as the
JAX tool timed ITERS iterations inside one kernel), and launched one by
one from Python (``eager_us``, which adds the host's launch cost).

    python -m fvsrn_tpu_torch.tools.probe_lane_gather [--device cuda|cpu]

``--device cpu`` runs the plain PyTorch versions (and times them on the
host). Prints ``<name>: ok=... us/call (... ns/sample)`` for each probe.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ..ops import probes
from ..utils.device import resolve_device
from ._timing import us_per_call

N = 8192
ITERS = 400


def _as(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """``a`` rounded to ``dtype`` (round to nearest even) and read back as
    float32: NumPy's own ``astype`` of the JAX tool's oracle."""
    return torch.from_numpy(a).to(dtype).to(torch.float32).numpy()


def _result(name, ok, dev, kernel, plain, library, out, want, nbytes,
            iters, compare):
    """Error against the oracle, time per launch and bytes of one probe.
    With ``compare`` (on the card, where the kernel is not the plain
    version) instead the plain version's error and time and the library
    call's time."""
    card = dev.type == "cuda"
    if compare:
        return {"name": name,
                "plain_max_abs_err": float((kernel() - plain()).abs().max()),
                "plain_us": us_per_call(plain, max(1, iters // 20), dev),
                "library_us": us_per_call(library, iters, dev, graph=card)}
    return {"name": name, "ok": bool(ok),
            "max_abs_err": float(np.abs(out - want).max()),
            "us": us_per_call(kernel, iters, dev, graph=card),
            "eager_us": us_per_call(kernel, iters, dev), "bytes": nbytes}


def probe_gather_single(dtype: torch.dtype, device="cuda",
                        n: Optional[int] = None, iters: Optional[int] = None,
                        compare: bool = False) -> dict:
    """(128, 128) lane table, (128, n) idx -> (128, n)."""
    dev = resolve_device(device)
    n, iters = n or N, iters or ITERS
    tab = np.random.default_rng(0).standard_normal((128, 128)).astype(
        np.float32)
    idx = np.random.default_rng(1).integers(0, 128, (128, n)).astype(
        np.int32)
    want = np.take_along_axis(_as(tab, dtype), idx, axis=1).astype(
        np.float32)
    tab_d = torch.from_numpy(tab).to(dev).to(dtype)
    idx_d = torch.from_numpy(idx).to(dev)
    idx64 = idx_d.to(torch.int64)
    out = probes.gather_single(tab_d, idx_d).cpu().numpy()
    return _result(
        f"gather single {'bf16' if dtype == torch.bfloat16 else 'f32'}",
        np.array_equal(out, want), dev,
        lambda: probes.gather_single(tab_d, idx_d),
        lambda: probes.gather_single_plain(tab_d, idx_d),
        lambda: torch.gather(tab_d, 1, idx64), out, want,
        idx.nbytes + 128 * n * 4 + tab_d.numel() * tab_d.element_size(),
        iters, compare)


def probe_gather_chunked(sz3p: int, device="cuda", n: Optional[int] = None,
                         iters: Optional[int] = None,
                         compare: bool = False) -> dict:
    """(128, sz3p) float32 table gathered by (128, n) idx -> (128, n)."""
    dev = resolve_device(device)
    n, iters = n or N, iters or ITERS
    tab_t = np.random.default_rng(0).standard_normal((128, sz3p)).astype(
        np.float32)
    idx = np.random.default_rng(1).integers(0, sz3p, (128, n)).astype(
        np.int32)
    want = np.take_along_axis(tab_t, idx, axis=1).astype(np.float32)
    tab_d = torch.from_numpy(tab_t).to(dev)
    idx_d = torch.from_numpy(idx).to(dev)
    idx64 = idx_d.to(torch.int64)
    out = probes.gather_chunked(tab_d, idx_d).cpu().numpy()
    return _result(
        f"gather chunked {sz3p} f32", np.allclose(out, want), dev,
        lambda: probes.gather_chunked(tab_d, idx_d),
        lambda: probes.gather_chunked_plain(tab_d, idx_d),
        lambda: torch.gather(tab_d, 1, idx64), out, want,
        idx.nbytes + 128 * n * 4 + tab_t.nbytes, iters, compare)


def probe_onehot(sz3p: int, device="cuda", n: Optional[int] = None,
                 iters: Optional[int] = None,
                 compare: bool = False) -> dict:
    """The sub-box resolve of (1, n) row ids from a bf16 (sz3p, 128)
    table. The library call is one ``index_select`` on the kernel's own
    inputs (the table, seen transposed, and the int32 row ids) into the
    kernel's (128, n) layout; no single PyTorch call also widens to
    float32, so it writes bf16, half the kernel's output bytes."""
    dev = resolve_device(device)
    n, iters = n or N, iters or ITERS
    tab = np.random.default_rng(0).standard_normal((sz3p, 128)).astype(
        np.float32)
    lrow = np.random.default_rng(1).integers(0, sz3p, (1, n)).astype(
        np.int32)
    want = _as(tab, torch.bfloat16)[lrow[0]].T
    tab_d = torch.from_numpy(tab).to(dev).to(torch.bfloat16)
    lrow_d = torch.from_numpy(lrow).to(dev)
    out = probes.onehot_resolve(tab_d, lrow_d).cpu().numpy()
    rows = np.unique(lrow).size
    return _result(
        f"onehot {sz3p} bf16", np.allclose(out, want, atol=1e-3), dev,
        lambda: probes.onehot_resolve(tab_d, lrow_d),
        lambda: probes.onehot_resolve_plain(tab_d, lrow_d),
        lambda: torch.index_select(tab_d.T, 1, lrow_d[0]), out, want,
        lrow.nbytes + 128 * n * 4 + rows * 128 * 2, iters, compare)


PROBES = (
    ("gather_single", lambda dev, **kw: probe_gather_single(
        torch.float32, dev, **kw)),
    ("gather_single", lambda dev, **kw: probe_gather_single(
        torch.bfloat16, dev, **kw)),
    ("gather_chunked", lambda dev, **kw: probe_gather_chunked(
        928, dev, **kw)),
    ("onehot_resolve", lambda dev, **kw: probe_onehot(128, dev, **kw)),
    ("onehot_resolve", lambda dev, **kw: probe_onehot(928, dev, **kw)),
)


def run_all(device="cuda", **kw) -> list:
    """Every probe of the JAX tool, in its order: (kernel name, result)."""
    return [(kernel, fn(device, **kw)) for kernel, fn in PROBES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu, plain versions")
    print(f"device: {where}", flush=True)
    ok = True
    for _, res in run_all(dev):
        ok &= res["ok"]
        print(f"{res['name']}: ok={res['ok']} {res['us']:.1f} us/call "
              f"({res['us'] * 1e3 / N:.2f} ns/sample)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
