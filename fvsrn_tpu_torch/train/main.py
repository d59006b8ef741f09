"""Training entry point: world- and screen-space SRN fitting.

Counterpart of ``fvsrn_tpu/train/main.py``: the same options, the network
and latent-grid initialization from the seed, ground truth from an
implicit field (``IMPLICIT:<EQUATION>``) or a scene JSON file
(``modules.registry.load_from_json``: its selected volume, a ``.cvol``
voxel grid or an implicit field, with its TF and stepping), and a
``.npz`` run file (``train.checkpoints.save_run``) written every
``--save_frequency`` epochs and at the end.

- ``--mode world`` (the default): the network fitted to volume samples
  (``train/world.py``): positions from ``--sampler``, a share
  ``--importance`` of them importance-sampled, the dataset rebuilt every
  ``--rebuild_dataset`` epochs from the per-voxel loss grid; JAX's random
  draws bit for bit (``utils.prng``).
- ``--mode screen``: a differentiable render against ground-truth
  images, through the fused march's kernels when the configuration is one
  they take (``--no_fused`` for the plain march). ``--data_parallel N``
  trains on N ranks (``train.screen.train_screen`` over a mesh, BASELINE
  config 4): under ``torchrun`` the N processes it started (its world size must
  be N), otherwise N ranks this process spawns on its host
  (``parallel.mesh.spawn``: ``nccl`` with a card a rank, ``gloo`` where
  ranks share a card or on the CPU). Rank 0 alone writes the run file and
  prints. As in the JAX package the flag is read in screen mode only.

``--tensorboard DIR`` logs ``loss/total`` at every epoch through
``torch.utils.tensorboard`` where it can be imported (a line on stderr
otherwise, and training goes on). ``--optimizer lbfgs`` is refused: the
trainer's steps take no closure, which L-BFGS needs (the JAX trainer
fails at its first update; ROADMAP.md, "differs on purpose").

Runs on the card unless ``--device cpu`` is given.

Usage:
  python -m fvsrn_tpu_torch.train.main <scene.json|IMPLICIT:NAME> out.npz
      --mode world --layers 32:32:32 --activation SnakeAlt:2 ...
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..models.latent import LatentSpace
from ..models.network_volume import VolumeInterpolationNetwork
from ..models.srn import SceneRepresentationNetwork
from ..modules.registry import load_from_json
from ..parallel import mesh as mesh_mod
from ..raytracer.dvr import RayEvaluationSteppingDvr, max_steps_bound
from ..transfer import TransferFunctionPiecewiseLinear
from ..utils import prng
from ..utils.device import resolve_device
from ..volume.implicit import VolumeInterpolationImplicit
from .checkpoints import save_run
from .importance import (importance_sampling,
                         importance_sampling_with_probability_grid,
                         loss_probability_grid)
from .losses import LossNetScreen, LossNetWorld
from .optimizer import make_optimizer
from .screen import (build_screen_dataset, fused_screen_supported,
                     screen_mega_kwargs, train_screen)
from .world import build_world_dataset, train_world_epochs


def init_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a scene representation network")
    p.add_argument("scene", help="scene JSON path or IMPLICIT:<EQUATION>")
    p.add_argument("output", help="output .npz run file")

    g = p.add_argument_group("Network")
    g.add_argument("--layers", default="32:32:32")
    g.add_argument("--activation", default="SnakeAlt:2")
    g.add_argument("--outputmode", default="density:direct",
                   choices=["density", "density:direct", "rgbo",
                            "rgbo:direct", "rgbo:exp"])
    g.add_argument("--fouriercount", type=int, default=14)
    g.add_argument("--fourierstd", type=float, default=1.0,
                   help="<=0 selects the NeRF block-identity matrix")
    g.add_argument("--volumetric_features_channels", type=int, default=0)
    g.add_argument("--volumetric_features_resolution", type=int,
                   default=0)
    g.add_argument("--volumetric_features_std", type=float, default=0.01)
    g.add_argument("--seed", type=int, default=42)

    g = p.add_argument_group("Data")
    g.add_argument("--mode", choices=["world", "screen"], default="world")
    g.add_argument("--samples", type=int, default=256 ** 2,
                   help="world samples")
    g.add_argument("--sampler", default="halton",
                   choices=["random", "halton", "plastic"])
    g.add_argument("--importance", type=float, default=0.0,
                   help=">0: fraction of importance-sampled positions")
    g.add_argument("--rebuild_dataset", type=int, default=0,
                   help="rebuild the dataset every N epochs from the "
                        "per-voxel loss grid")
    g.add_argument("--screen_cameras", type=int, default=16)
    g.add_argument("--screen_size", type=int, default=64)
    g.add_argument("--data_parallel", type=int, default=0)

    g = p.add_argument_group("Optimization")
    g.add_argument("-o", "--optimizer", default="Adam")
    g.add_argument("-lr", type=float, default=0.01)
    g.add_argument("-i", "--epochs", type=int, default=50)
    g.add_argument("--lr_gamma", type=float, default=0.5)
    g.add_argument("--lr_step", type=int, default=500)
    g.add_argument("--batch_size", type=int, default=64 * 64 * 2)

    g = p.add_argument_group("Loss")
    g.add_argument("-l1", type=float, default=1.0)
    g.add_argument("-l2", type=float, default=0.0)
    g.add_argument("--dssim", type=float, default=0.0)

    g = p.add_argument_group("Output")
    g.add_argument("--save_frequency", type=int, default=10)
    g.add_argument("--tensorboard", default=None)
    g.add_argument("--stepsize", type=float, default=1 / 128)
    g.add_argument("--no_fused", action="store_true",
                   help="screen mode: the plain march instead of the "
                        "fused kernels")
    g.add_argument("--scan_epoch", action="store_true",
                   help="accepted for the JAX package's parser; world "
                        "epochs run as a Python loop of steps either way")
    g.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p


def _resolve_scene(spec: str):
    """(volume, tf, stepping config) of ``IMPLICIT:<EQUATION>`` or of a
    scene JSON file's selected modules."""
    if spec.startswith("IMPLICIT:"):
        vol = VolumeInterpolationImplicit.make(spec.split(":", 1)[1])
        tf = TransferFunctionPiecewiseLinear.make(
            rgb=[[0.9, 0.4, 0.1], [1.0, 1.0, 0.6]],
            opacity=[0.0, 20.0], positions=[0.0, 1.0])
        return vol, tf, RayEvaluationSteppingDvr.make(stepsize=1 / 128)
    ev = load_from_json(spec).evaluator
    if ev.volume is None:
        raise ValueError("scene has no loadable volume (dataset missing?)")
    return ev.volume, ev.tf, ev.ray_config


def make_network(opt: dict) -> SceneRepresentationNetwork:
    """The run's initial network on the CPU: ``SceneRepresentationNetwork
    .make`` from ``--seed``, its latent grid (when asked for) drawn from
    ``np.random.default_rng(seed)``, as the JAX package draws it."""
    latent = LatentSpace()
    if (opt["volumetric_features_channels"] > 0
            and opt["volumetric_features_resolution"] > 0):
        rng = np.random.default_rng(opt["seed"])
        r = opt["volumetric_features_resolution"]
        latent = LatentSpace(static_grid=torch.from_numpy((
            rng.standard_normal(
                (opt["volumetric_features_channels"], r, r, r))
            * opt["volumetric_features_std"]).astype(np.float32)))
    return SceneRepresentationNetwork.make(
        layers=opt["layers"], activation=opt["activation"],
        output_mode=opt["outputmode"], num_fourier=opt["fouriercount"],
        fourier_std=opt["fourierstd"], latent=latent, seed=opt["seed"])


def open_tensorboard(logdir: str):
    """A ``SummaryWriter`` on ``logdir``, or None (with the JAX package's
    line on stderr) where ``torch.utils.tensorboard`` cannot be
    imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard unavailable; continuing without",
              file=sys.stderr)
        return None
    return SummaryWriter(logdir)


def _run_rank(mesh, opt: dict) -> dict:
    """One rank of a spawned ``--data_parallel`` run: :func:`run` in the
    group ``spawn`` started, the network returned on the CPU."""
    out = run(opt)
    out["network"] = out["network"].cpu()
    return out


def run(opt: dict) -> dict:
    """Programmatic entry; returns {'history', 'network', 'rank'} and, in
    screen mode, 'fused'. With ``data_parallel`` N > 1 in screen mode,
    outside a process group and outside ``torchrun``, spawns the N ranks
    and returns rank 0's result, its network on the CPU."""
    if opt["optimizer"].lower() == "lbfgs":
        raise ValueError("--optimizer lbfgs needs a closure at every step, "
                         "which the trainer's steps do not pass; use "
                         "train.optimizer.make_optimizer directly")
    n_dp = int(opt.get("data_parallel") or 0) if opt["mode"] == "screen" \
        else 0
    if n_dp and opt["screen_cameras"] % n_dp:
        raise ValueError(f"need cameras ({opt['screen_cameras']}) divisible "
                         f"by --data_parallel ({n_dp})")
    if (n_dp > 1 and not torch.distributed.is_initialized()
            and not mesh_mod.under_torchrun()):
        return mesh_mod.spawn(_run_rank, n_dp, opt,
                              device=opt.get("device", "cuda"))
    dev = resolve_device(opt.get("device", "cuda"))
    if not n_dp:
        return _train(opt, dev, None)
    own_group = not torch.distributed.is_initialized()
    mesh = mesh_mod.make_mesh(n_dp, device=dev)
    try:
        return _train(opt, mesh.device, mesh)
    finally:
        if own_group:
            mesh_mod.close_mesh()


def _train(opt: dict, dev, mesh) -> dict:
    """:func:`run`'s training on ``dev``, as one rank of ``mesh`` (or in
    one process with None)."""
    main_rank = mesh is None or mesh.is_main
    volume, tf, ray_config = _resolve_scene(opt["scene"])
    ray_config = RayEvaluationSteppingDvr.make(
        **dict(ray_config.__dict__, stepsize=opt["stepsize"]))

    net = make_network(opt).to(dev)

    def make_opt(params):
        return make_optimizer(params, opt["optimizer"], lr=opt["lr"],
                              lr_step=opt["lr_step"],
                              lr_gamma=opt["lr_gamma"])

    history = []
    t_start = time.time()
    writer = None
    if opt.get("tensorboard") and main_rank:
        writer = open_tensorboard(opt["tensorboard"])

    def epoch_cb(e, network, loss_val):
        history.append(loss_val)
        if writer is not None:
            writer.add_scalar("loss/total", loss_val, len(history) - 1)
        if (e + 1) % opt["save_frequency"] == 0 and main_rank:
            save_run(opt["output"], network, opt, history)

    out = {"history": history, "rank": 0 if mesh is None else mesh.rank}
    try:
        if opt["mode"] == "world":
            net = _train_world(opt, net, volume, tf, make_opt, epoch_cb, dev)
        else:
            net, out["fused"] = _train_screen(opt, net, volume, tf,
                                              ray_config, make_opt,
                                              epoch_cb, dev, mesh)
    finally:
        if writer is not None:
            writer.close()
    if main_rank:
        save_run(opt["output"], net,
                 dict(opt, seconds=time.time() - t_start), history)
    out["network"] = net
    return out


def _train_screen(opt, net, volume, tf, ray_config, make_opt, epoch_cb, dev,
                  mesh):
    """Screen mode as the JAX package runs it, on the ranks of ``mesh``
    when one is given: (network, whether the fused march ran)."""
    loss = LossNetScreen(l1=opt["l1"], l2=opt["l2"], dssim=opt["dssim"])
    ds = build_screen_dataset(volume, tf, ray_config,
                              num_cameras=opt["screen_cameras"],
                              width=opt["screen_size"],
                              height=opt["screen_size"], device=dev)
    max_steps = max_steps_bound((1.0, 1.0, 1.0), float(ray_config.stepsize))
    use_fused = (not opt.get("no_fused")
                 and fused_screen_supported(net, tf, ds.width, ds.height))
    fused_kwargs = None
    if use_fused:
        fused_kwargs = screen_mega_kwargs(ds)
        if mesh is None or mesh.is_main:
            print("screen mode: fused march enabled (--no_fused for the "
                  "plain march)", file=sys.stderr)
    kw = dict(epochs=opt["epochs"], max_steps=max_steps, use_fused=use_fused,
              fused_kwargs=fused_kwargs, callback=epoch_cb)
    net, _ = train_screen(net, ds, tf, ray_config, loss,
                          make_opt(net.parameters()), mesh=mesh, **kw)
    return net, use_fused


def _train_world(opt, net, volume, tf, make_opt, epoch_cb, dev):
    """World mode as the JAX package runs it: rgbo networks fit TF
    colors, density networks raw densities; the dataset from
    ``prng_key(seed)``, its last ``importance`` share importance-sampled
    from ``prng_key(seed + 1)``, rebuilt from the loss grid with
    ``prng_key(seed + epochs_left)`` every ``rebuild_dataset`` epochs."""
    is_rgbo = opt["outputmode"].startswith("rgbo")
    loss = LossNetWorld(mode="rgbo" if is_rgbo else "density",
                        l1=opt["l1"], l2=opt["l2"])
    key = prng.prng_key(opt["seed"])

    def build_ds(positions=None):
        return build_world_dataset(
            volume, opt["samples"], sampler=opt["sampler"], key=key,
            tf=(tf if is_rgbo else None), stepsize=float(opt["stepsize"]),
            positions=positions, device=dev)

    ds = build_ds()
    if opt["importance"] > 0:
        n_imp = int(opt["samples"] * opt["importance"])
        pos_i, _, _ = importance_sampling(
            prng.prng_key(opt["seed"] + 1), volume, n_imp, tf=tf,
            min_prob=0.01, device=dev)
        ds = build_ds(positions=torch.cat(
            [ds.positions[:opt["samples"] - n_imp], pos_i]))
    rebuild = opt["rebuild_dataset"]
    epochs_left = opt["epochs"]
    phase_len = rebuild if rebuild > 0 else epochs_left
    while epochs_left > 0:
        n = min(phase_len, epochs_left)
        net, _ = train_world_epochs(
            net, ds, loss, make_opt, batch_size=opt["batch_size"], epochs=n,
            scan_epoch=opt.get("scan_epoch", False), callback=epoch_cb)
        epochs_left -= n
        if epochs_left > 0 and rebuild > 0:
            grid = loss_probability_grid(VolumeInterpolationNetwork(net),
                                         volume, resolution=32, device=dev)
            pos, _, _ = importance_sampling_with_probability_grid(
                prng.prng_key(opt["seed"] + epochs_left), volume, grid,
                opt["samples"], min_prob=0.05, device=dev)
            ds = build_ds(positions=pos)
    return net


def main(argv=None):
    opt = vars(init_parser().parse_args(argv))
    result = run(opt)
    if result["rank"] != 0:
        return 0
    h = result["history"]
    print(f"trained {len(h)} epochs; loss {h[0]:.5f} -> {h[-1]:.5f}; "
          f"run file: {opt['output']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
