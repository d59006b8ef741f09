"""Figure generation from artifact JSONs.

Counterpart of ``fvsrn_tpu/eval/figures.py``: the compression
rate-distortion curve (the teaser figure's analog), the bench history
across rounds and the scaling-efficiency chart, with the same palette,
styling, input file patterns (``COMPRESSION_R05.json``,
``BENCH_r*.json``, ``SCALING_r*.json``) and schemas. The inputs are read
from a ``--root`` the caller names: there is no default, since the JSONs
at the repository's root are the TPU package's and not the port's
numbers. The bench history's title names the input's ``"device"`` when
it has one, and no device otherwise. Host tooling: matplotlib is imported
inside the functions.

Styling follows a fixed validated categorical palette (slots assigned
in fixed order, one axis per chart, thin marks, direct labels, muted
grid) rather than matplotlib defaults.

Usage: python -m fvsrn_tpu_torch.eval.figures --root <dir of the port's
       JSONs> [--out figures/]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

# validated categorical palette (fixed slot order; see dataviz notes)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"]
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
GRID = "#e4e3df"


def _style(ax, title, xlabel, ylabel):
    ax.set_facecolor(SURFACE)
    ax.set_title(title, color=TEXT, fontsize=11, loc="left", pad=10)
    ax.set_xlabel(xlabel, color=TEXT2, fontsize=9)
    ax.set_ylabel(ylabel, color=TEXT2, fontsize=9)
    ax.tick_params(colors=TEXT2, labelsize=8)
    ax.grid(True, color=GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    for s in ax.spines.values():
        s.set_visible(False)


def fig_compression(root: str, out: str):
    """Rate-distortion curves per codec + the SRN point (the teaser)."""
    import matplotlib.pyplot as plt
    path = os.path.join(root, "COMPRESSION_R05.json")
    if not os.path.exists(path):
        return None
    data = json.load(open(path))
    codecs = {}
    for k, v in data.items():
        m = re.match(r"([a-z]+)@", k)
        if m and isinstance(v, dict) and "psnr" in v:
            codecs.setdefault(m.group(1), []).append(
                (v["bytes"], v["psnr"]))
    fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    order = ["tthresh", "dwt", "quantize", "tucker"]
    for i, name in enumerate(c for c in order if c in codecs):
        pts = sorted(codecs[name])
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        c = SERIES[i]
        ax.plot(xs, ys, "-o", color=c, linewidth=2, markersize=5)
        ax.annotate(name, (xs[-1], ys[-1]), xytext=(6, 0),
                    textcoords="offset points", color=TEXT,
                    fontsize=9, va="center")
    net = data.get("network")
    if net and net.get("psnr"):
        ax.plot([net["bytes"]], [net["psnr"]], "D", color=SERIES[4],
                markersize=8)
        ax.annotate("SRN", (net["bytes"], net["psnr"]), xytext=(6, 0),
                    textcoords="offset points", color=TEXT, fontsize=9,
                    va="center")
    ax.set_xscale("log")
    _style(ax, "Volume compression rate-distortion (64³ Marschner-Lobb)",
           "compressed bytes (log)", "PSNR (dB)")
    fig.tight_layout()
    p = os.path.join(out, "compression_rd.png")
    fig.savefig(p, facecolor=SURFACE)
    plt.close(fig)
    return p


def fig_bench_history(root: str, out: str):
    """fwd+bwd and forward Mrays/s across rounds."""
    import matplotlib.pyplot as plt
    rounds = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        m = re.search(r"BENCH_r(\d+)\.json$", path)
        if m is None:        # scratch copies like BENCH_r05_old.json
            continue
        blob = json.load(open(path))
        parsed = blob.get("parsed", blob)
        if not isinstance(parsed, dict) or "value" not in parsed:
            continue
        device = blob.get("device", parsed.get("device"))
        rounds.append((int(m.group(1)), parsed,
                       device if isinstance(device, str) else None))
    rounds.sort(key=lambda r: r[0])
    if not rounds:
        return None
    xs = [r for r, _, _ in rounds]

    def fwd_bwd(p):
        # round 3's primary "value" was the forward render rate; its
        # fwd+bwd lives in train_fwd_bwd_mrays -- normalize per round
        if "train_fwd_bwd_mrays" in p:
            return p["train_fwd_bwd_mrays"]
        return p["value"]

    def forward(p):
        if "forward_mrays" in p:
            return p["forward_mrays"]
        if "train_fwd_bwd_mrays" in p:
            return p["value"]          # round 3: value WAS the forward
        return None

    fb = [fwd_bwd(p) for _, p, _ in rounds]
    fwd = [forward(p) for _, p, _ in rounds]
    fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    ax.plot(xs, fb, "-o", color=SERIES[0], linewidth=2, markersize=5)
    ax.annotate("fwd+bwd (dense)", (xs[-1], fb[-1]), xytext=(6, 0),
                textcoords="offset points", color=TEXT, fontsize=9,
                va="center")
    fx = [(x, v) for x, v in zip(xs, fwd) if v is not None]
    if fx:
        ax.plot([x for x, _ in fx], [v for _, v in fx], "-o",
                color=SERIES[1], linewidth=2, markersize=5)
        ax.annotate("forward (dense)", fx[-1], xytext=(6, 0),
                    textcoords="offset points", color=TEXT, fontsize=9,
                    va="center")
    last = rounds[-1][1]
    for key, label, dy in (("sparse_fwd_bwd_mrays",
                            "fwd+bwd (sparse)", -10),
                           ("sparse_forward_mrays",
                            "forward (sparse)", 10)):
        if key in last:
            ax.plot([xs[-1]], [last[key]], "D", color=SERIES[2],
                    markersize=7)
            ax.annotate(label, (xs[-1], last[key]), xytext=(6, dy),
                        textcoords="offset points", color=TEXT,
                        fontsize=9, va="center")
    ax.set_xticks(xs)
    ax.set_xlim(xs[0] - 0.2, xs[-1] + 1.6)
    device = rounds[-1][2]
    _style(ax, "Fused SRN DVR throughput by round "
               "(512², stepsize 1/512" + (f", {device}" if device else "")
           + ")", "round", "Mrays/s")
    fig.tight_layout()
    p = os.path.join(out, "bench_history.png")
    fig.savefig(p, facecolor=SURFACE)
    plt.close(fig)
    return p


def fig_scaling(root: str, out: str):
    """Scaling efficiency over devices (pinned virtual mesh)."""
    import matplotlib.pyplot as plt
    paths = sorted(glob.glob(os.path.join(root, "SCALING_r*.json")))
    if not paths:
        return None
    blob = json.load(open(paths[-1]))
    res = blob.get("virtual_cpu_mesh_pinned", {}).get("results", {})
    if not res:
        return None
    ns = sorted(int(k) for k in res)
    eff = [res[str(n)]["efficiency_vs_linear"] for n in ns]
    fig, ax = plt.subplots(figsize=(5.2, 3.8), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    bars = ax.bar([str(n) for n in ns], eff, color=SERIES[0],
                  width=0.55)
    for b, e in zip(bars, eff):
        ax.annotate(f"{e * 100:.0f}%",
                    (b.get_x() + b.get_width() / 2, e),
                    xytext=(0, 3), textcoords="offset points",
                    ha="center", color=TEXT, fontsize=9)
    ax.axhline(0.85, color=TEXT2, linewidth=1, linestyle="--")
    ax.annotate("0.85 gate", (0.02, 0.85), xycoords=("axes fraction",
                                                     "data"),
                xytext=(0, 4), textcoords="offset points",
                color=TEXT2, fontsize=8)
    ax.set_ylim(0, 1.1)
    _style(ax, "DP render scaling efficiency (pinned virtual mesh)",
           "devices", "efficiency vs linear")
    fig.tight_layout()
    p = os.path.join(out, "scaling.png")
    fig.savefig(p, facecolor=SURFACE)
    plt.close(fig)
    return p


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True,
                   help="directory of the port's artifact JSONs "
                        "(COMPRESSION_R05.json, BENCH_r*.json, "
                        "SCALING_r*.json)")
    p.add_argument("--out", default=None,
                   help="output directory (default <root>/figures)")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    out = args.out or os.path.join(root, "figures")
    os.makedirs(out, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    made = [f for f in (fig_compression(root, out),
                        fig_bench_history(root, out),
                        fig_scaling(root, out)) if f]
    for f in made:
        print(f)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
