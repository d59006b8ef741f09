"""The megakernel prototype (``tools/proto_mega.py`` of the JAX package) on
the port's kernel, ``csrc/probes.cu``.

A (T=4, S=3) grid of (128-ray tile, segment) programs over an (8, 512)
float32 ray array and a resident (34, 34, 640) float32 table: each program
reduces ray rows 0-2 of its tile to slice starts, sums the (6, 16, 256)
box of the table there into the tile's output block, and adds ones into a
counts table at the same box. Checked against the JAX tool's NumPy loop
(relative 1e-5 on the output, exact on the counts).

    python -m fvsrn_tpu_torch.tools.proto_mega [--device cuda|cpu]

``--device cpu`` runs the plain PyTorch version. Prints the errors, the
time per launch and ``PROTO OK``.
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

T, S = 4, 3
TILE = probes.TILE
Z, Y, X = 34, 34, 640          # table dims (32^3 grid slab layout)
BZ, BY, BX = probes.BOX        # slice sizes
ITERS = 400


def make_inputs():
    """(rays (8, T*TILE), tab (Z, Y, X)) float32, drawn as the JAX tool
    draws them (its first, discarded draw included)."""
    rng = np.random.default_rng(0)
    rng.integers(0, 8, (T, 8, TILE))
    rays = np.concatenate(
        [rng.integers(0, 8, (8, TILE)).astype(np.float32) for _ in range(T)],
        axis=1)
    tab = rng.standard_normal((Z, Y, X)).astype(np.float32)
    return rays, tab


def reference(rays: np.ndarray, tab: np.ndarray):
    """The JAX tool's NumPy oracle: (out (8, T*TILE), counts (Z, Y, X))."""
    ref = np.zeros((8, T * TILE), np.float32)
    rtab = np.zeros((Z, Y, X), np.float32)
    for t in range(T):
        r = rays[:, t * TILE:(t + 1) * TILE]
        for s in range(S):
            zmin = int(np.clip(r[0].min() + s, 0, Z - BZ))
            ymin = int(np.clip((r[1].min() // 8) * 8, 0, Y - BY))
            xb = int(np.clip(r[2].min(), 0, (X - BX) // 128))
            box = tab[zmin:zmin + BZ, ymin:ymin + BY,
                      xb * 128:xb * 128 + BX]
            ref[:, t * TILE:(t + 1) * TILE] += box.sum() + r
            rtab[zmin:zmin + BZ, ymin:ymin + BY,
                 xb * 128:xb * 128 + BX] += 1.0
    return ref, rtab


def errors(out: np.ndarray, dtab: np.ndarray, ref: np.ndarray,
           rtab: np.ndarray):
    """(relative output error, absolute counts error), as the JAX tool
    measures them."""
    err1 = float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))
    return err1, float(np.abs(dtab - rtab).max())


def run(device="cuda", iters: Optional[int] = None,
        compare: bool = False) -> dict:
    """The prototype on ``device`` against the NumPy oracle: its errors,
    time per launch in us (on the card the replay of a CUDA graph of
    ``iters`` launches, and ``eager_us`` launched one by one) and the
    bytes the function must move (rays and the boxes it reads in, the
    output and the whole counts table out).
    With ``compare`` (on the card) instead the plain version's error
    against the kernel and its time."""
    dev = resolve_device(device)
    iters = iters or ITERS
    rays_np, tab_np = make_inputs()
    rays = torch.from_numpy(rays_np).to(dev)
    tab = torch.from_numpy(tab_np).to(dev)
    out, dtab = probes.proto_mega(rays, tab, S)
    if compare:
        p_out, p_dtab = probes.proto_mega_plain(rays, tab, S)
        scale = max(1.0, float(p_out.abs().max()))
        return {"plain_max_abs_err": max(
                    float((out - p_out).abs().max()) / scale,
                    float((dtab - p_dtab).abs().max())),
                "plain_us": us_per_call(
                    lambda: probes.proto_mega_plain(rays, tab, S), 5, dev)}
    ref, rtab = reference(rays_np, tab_np)
    err1, err2 = errors(out.cpu().numpy(), dtab.cpu().numpy(), ref, rtab)
    return {"out_rel_err": err1, "dtab_abs_err": err2,
            "ok": err1 < 1e-5 and err2 < 1e-5,
            "us": us_per_call(lambda: probes.proto_mega(rays, tab, S), iters,
                              dev, graph=dev.type == "cuda"),
            "eager_us": us_per_call(lambda: probes.proto_mega(rays, tab, S),
                                    iters, dev),
            "bytes": (rays.numel() * 4 * 2 + tab.numel() * 4
                      + int((rtab > 0).sum()) * 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    print("out rel err:", res["out_rel_err"], "dtab abs err:",
          res["dtab_abs_err"])
    print(f"proto_mega [{args.device}]: {res['us']:.1f} us/call "
          f"({res['eager_us']:.1f} launched one by one)")
    assert res["out_rel_err"] < 1e-5, "out mismatch"
    assert res["dtab_abs_err"] < 1e-5, "dtab mismatch"
    print("PROTO OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
