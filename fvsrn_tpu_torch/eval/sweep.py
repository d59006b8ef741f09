"""Generic ablation-sweep loop behind the eval_* figure scripts (the
port of ``fvsrn_tpu/eval/sweep.py``).

The reference drives every paper figure with a dedicated script that
enumerates training configs, trains each with the volnet trainer, and
collects quality stats into tables/plots -- all variations of one loop
(reference: applications/volnet/eval_ActivationFunctions.py,
eval_Fourier.py, eval_network_configs.py, eval_ScreenVsWorld.py,
eval_world_DensityVsColor.py, eval_Importance.py; index in
README.md:137-163). Here that loop is a single harness: a sweep is a list
of ``(name, option-overrides)``; each entry trains through
:func:`fvsrn_tpu_torch.train.main.run` on the device and is scored on
held-out world samples (L1/L2 against the scene volume, drawn from the
JAX package's key for ``seed + 999``, so the samples are its own bit for
bit). ``render=True`` also times one FUSED render of each trained net at
128x128 (``LoadedModel.prepare_network_render``: the megakernel, row 1,
on the card where the network takes that route).

Results print as a table and optionally persist to CSV.
"""
from __future__ import annotations

import csv
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

RENDER_SIZE = 128


def default_options(scene: str, output: str) -> dict:
    """The training CLI's defaults for ``scene``, writing ``output``
    (``train.main.init_parser``, as the JAX package takes them)."""
    from ..train.main import init_parser
    return vars(init_parser().parse_args([scene, output]))


def _score_world(network, scene: str, *, samples: int, seed: int,
                 device="cuda") -> dict:
    """Held-out world-space L1/L2 of the trained SRN vs the scene volume
    (reference: evaluation.py EvaluateWorld used by the eval scripts)."""
    from ..train.losses import LossNetWorld
    from ..train.main import _resolve_scene
    from ..train.world import build_world_dataset, evaluate_world
    from ..utils import prng

    volume, tf, cfg = _resolve_scene(scene)
    is_rgbo = network.output_mode.startswith("rgbo")
    ds = build_world_dataset(
        volume, samples, sampler="random",
        tf=(tf if is_rgbo else None),
        stepsize=float(cfg.stepsize) if is_rgbo else 1.0,
        key=prng.prng_key(seed + 999), device=device)
    mode = "rgbo" if is_rgbo else "density"
    l1 = LossNetWorld(mode=mode, l1=1.0, l2=0.0)
    l2 = LossNetWorld(mode=mode, l1=0.0, l2=1.0)
    with torch.no_grad():
        return {"world_l1": float(evaluate_world(network, ds, l1)[0]),
                "world_l2": float(evaluate_world(network, ds, l2)[0])}


def _render_ms(network, scene: str, *, width: int = RENDER_SIZE,
               device="cuda") -> float:
    """One warm FUSED render of the trained net, timed by
    ``utils.timer.GPUTimer`` (CUDA events on the card; on the CPU the
    host clock around the plain versions)."""
    from ..inference import LoadedModel
    from ..train.main import _resolve_scene
    from ..utils.timer import GPUTimer

    _, tf, cfg = _resolve_scene(scene)
    model = LoadedModel(network, tf, config=cfg)
    cam = model.rotation_cameras(1)[0]
    render = model.prepare_network_render(cam, width, width, "FUSED",
                                          device=device)
    render().mean().item()                    # build + warm
    timer = GPUTimer(device)
    timer.start()
    render().mean()
    return timer.stop()


def _format(value) -> str:
    return f"{value:.5g}" if isinstance(value, float) else str(value)


def run_sweep(configs: Sequence[tuple], *, base: Optional[dict] = None,
              scene: str = "IMPLICIT:MARSCHNER_LOBB",
              out_dir: Optional[str] = None,
              out_csv: Optional[str] = None,
              eval_samples: int = 16384,
              render: bool = False, device="cuda",
              networks: Optional[dict] = None) -> list:
    """Train and score every (name, overrides) entry on ``device``.
    Returns the rows (list of dicts), prints a table, optionally writes
    CSV. ``render=True`` additionally times one FUSED screen render of
    each trained net. A dict given as ``networks`` receives each trained
    network under its entry's name."""
    from ..train.main import run

    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="fvsrn_sweep_")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for name, overrides in configs:
        opt = default_options(scene, os.path.join(out_dir, f"{name}.npz"))
        opt["device"] = str(device)
        opt.update(base or {})
        opt.update(overrides)
        t0 = time.time()
        res = run(opt)
        row = {"name": name,
               "final_loss": res["history"][-1],
               "train_seconds": round(time.time() - t0, 1)}
        row.update(_score_world(res["network"], opt["scene"],
                                samples=eval_samples, seed=opt["seed"],
                                device=opt["device"]))
        if render:
            row["render_ms"] = round(_render_ms(
                res["network"], opt["scene"], device=opt["device"]), 1)
        if networks is not None:
            networks[name] = res["network"]
        rows.append(row)
        print(f"[sweep] {name}: loss {row['final_loss']:.5f} "
              f"world_l2 {row['world_l2']:.5f} "
              f"({row['train_seconds']}s)", flush=True)

    keys = list(rows[0].keys()) if rows else []
    widths = {k: max(len(k), *(len(_format(r[k])) for r in rows))
              for k in keys}
    print("  ".join(k.ljust(widths[k]) for k in keys))
    for r in rows:
        print("  ".join(_format(r[k]).ljust(widths[k]) for k in keys))
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {out_csv}")
    return rows


def sweep_main(configs_fn, description: str, argv=None, *,
               networks: Optional[dict] = None):
    """Shared CLI for the thin eval_* scripts: --epochs/--samples control
    the quick-vs-paper scale, --csv persists the table, --device picks
    the card (default) or the CPU. ``networks`` as in :func:`run_sweep`."""
    import argparse
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--scene", default="IMPLICIT:MARSCHNER_LOBB")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--samples", type=int, default=64 * 64 * 4)
    p.add_argument("--csv", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--render", action="store_true",
                   help="also time a fused (megakernel) screen render "
                        "of each trained net")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    base = {"epochs": args.epochs, "samples": args.samples}
    run_sweep(configs_fn(args), base=base, scene=args.scene,
              out_dir=args.out_dir, out_csv=args.csv,
              render=args.render, device=args.device, networks=networks)
    return 0
