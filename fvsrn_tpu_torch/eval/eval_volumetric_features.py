"""Timing + quality evaluation of SRN rendering modes (the port of
``fvsrn_tpu/eval/eval_volumetric_features.py``).

Rebuild of the reference's headline evaluation harness
(reference: applications/volnet/eval_VolumetricFeatures.py:147-200):
render N cameras at a fixed resolution/stepsize in every evaluation mode,
discard the first frame as warm-up, report frame-time mean±std, and score
SSIM (and LPIPS, when its weights are configured) of the network render
against the reference-volume render.

Defaults = the protocol of the reference harness: 512x512 at world
stepsize 1/512 (eval_VolumetricFeatures.py:148-156), 4 cameras, FUSED
against PLAIN32; the emitted JSON states the protocol. FUSED is the
product render (``LoadedModel.prepare_network_render``: the megakernel,
``csrc/mega_fwd.cuh``, on the card), PLAIN32 the plain float32 march.
Frames are timed by ``utils.timer.GPUTimer`` (CUDA events on the card).

Usage:
  python -m fvsrn_tpu_torch.eval.eval_volumetric_features
      [--scene dense|sparse] [--width 512] [--stepsize 0.001953125]
      [--cameras 4] [--train-epochs 40] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

PROTOCOL_REFERENCE = ("eval_VolumetricFeatures.py:147-200 (512^2, "
                      "stepsize 1/512, warm-up frame discarded)")
CAMERA = dict(distance=1.7, pitch=0.35)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--stepsize", type=float, default=1 / 512)
    p.add_argument("--cameras", type=int, default=4)
    p.add_argument("--train-epochs", type=int, default=40)
    p.add_argument("--equation", default="MARSCHNER_LOBB")
    p.add_argument("--scene", choices=["dense", "sparse"], default=None,
                   help="use a canonical benchmark scene "
                        "(fvsrn_tpu_torch/scenes.py: volume + TF + trained "
                        "weights); overrides --equation and supplies "
                        "--checkpoint when not given")
    p.add_argument("--modes", nargs="+",
                   default=["FUSED", "PLAIN32"])
    p.add_argument("--checkpoint", default=None,
                   help="load a trained run (.npz) instead of "
                        "quick-fitting")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p.parse_args(argv)


def load_model(args):
    """The ``LoadedModel`` to evaluate, with its reference volume and the
    protocol's stepping: the scene's or ``--checkpoint``'s weights, else
    the JAX package's quick fit (the flagship's shape, world-trained
    ``--train-epochs`` epochs on 65,536 Halton samples) on the device."""
    from ..inference import LoadedModel
    from ..raytracer.dvr import RayEvaluationSteppingDvr
    from ..transfer import TransferFunctionPiecewiseLinear
    from ..utils.device import resolve_device
    from ..volume.implicit import VolumeInterpolationImplicit

    dev = resolve_device(args.device)
    if args.scene is not None:
        from ..scenes import dense_scene, sparse_scene
        volume, tf, ckpt = (dense_scene if args.scene == "dense"
                            else sparse_scene)()
        if args.checkpoint is None:
            args.checkpoint = ckpt
    else:
        volume = VolumeInterpolationImplicit.make(args.equation)
        tf = TransferFunctionPiecewiseLinear.make(
            rgb=[[0.1, 0.1, 0.8], [0.9, 0.4, 0.1], [1.0, 1.0, 0.6]],
            opacity=[0.0, 10.0, 30.0], positions=[0.0, 0.5, 1.0])
    config = RayEvaluationSteppingDvr.make(stepsize=args.stepsize)
    if args.checkpoint:
        return LoadedModel.from_checkpoint(args.checkpoint, tf=tf,
                                           config=config,
                                           reference_volume=volume)
    return LoadedModel(_quick_fit(volume, args.train_epochs, dev), tf,
                       config=config, reference_volume=volume)


def _quick_fit(volume, epochs: int, dev):
    from ..models.latent import LatentSpace
    from ..models.srn import SceneRepresentationNetwork
    from ..train.losses import LossNetWorld
    from ..train.optimizer import make_optimizer
    from ..train.world import build_world_dataset, train_world_epochs

    rng = np.random.default_rng(0)
    latent = LatentSpace(static_grid=torch.from_numpy(
        (rng.standard_normal((16, 32, 32, 32)) * 0.01).astype(np.float32)))
    net = SceneRepresentationNetwork.make(
        layers="32:32:32", activation="SnakeAlt:2", num_fourier=14,
        output_mode="density:direct", latent=latent, seed=1).to(dev)
    ds = build_world_dataset(volume, 65536, sampler="halton", device=dev)
    loss = LossNetWorld(mode="density", l1=1.0)

    def make_opt(params):
        return make_optimizer(params, "Adam", lr=5e-3, lr_step=1000,
                              lr_gamma=0.5)

    net, hist = train_world_epochs(net, ds, loss, make_opt, batch_size=8192,
                                   epochs=epochs)
    print(f"quick fit: L1 {hist[0]:.4f} -> {hist[-1]:.4f}", file=sys.stderr)
    return net


def _nchw(img):
    return torch.movedim(img[None], -1, 1)


def evaluate(model, args, *, images=None) -> dict:
    """The harness's JSON record: the protocol, then per mode the frame
    time (mean, std, Mrays/s over cameras 1..N-1) and SSIM / LPIPS of
    camera 0's frame against ``render_reference``. ``images``, a dict,
    receives camera 0's frame per mode and the reference ("reference")."""
    from ..inference import LoadedModel
    from ..train.losses import ssim
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cameras = LoadedModel.rotation_cameras(args.cameras, **CAMERA)
    results = {"protocol": {
        "width": args.width, "height": args.height,
        "stepsize": args.stepsize, "cameras": args.cameras,
        "reference": PROTOCOL_REFERENCE}}
    ref_img = model.render_reference(cameras[0], args.width, args.height,
                                     device=dev)
    if images is not None:
        images["reference"] = ref_img
    # LPIPS when weights are configured (FVSRN_LPIPS_BACKBONE/_LINEAR);
    # reported as null otherwise -- SSIM is the substitute metric
    lpips_model = None
    try:
        from ..train.lpips import load_lpips
        lpips_model = load_lpips().to(dev)
    except (FileNotFoundError, ImportError):
        pass
    for mode in args.modes:
        mean_ms, std_ms, _ = model.time_rendering(
            cameras, width=args.width, height=args.height, mode=mode,
            device=dev)
        net_img = model.render_network(cameras[0], args.width, args.height,
                                       mode, device=dev)
        if images is not None:
            images[mode] = net_img
        with torch.no_grad():
            s = float(ssim(_nchw(net_img), _nchw(ref_img)))
            lp = None
            if lpips_model is not None:
                lp = round(float(lpips_model(
                    _nchw(net_img[..., :3]), _nchw(ref_img[..., :3]))[0]), 4)
        mrays = args.width * args.height / (mean_ms / 1000) / 1e6
        results[mode] = {
            "frame_ms_mean": round(mean_ms, 3),
            "frame_ms_std": round(std_ms, 3),
            "mrays_per_s": round(mrays, 3),
            "ssim_vs_reference": round(s, 4),
            "lpips_vs_reference": lp,
        }
        if lp is None:
            results[mode]["lpips_note"] = (
                "no LPIPS weights found (set FVSRN_LPIPS_BACKBONE/"
                "FVSRN_LPIPS_LINEAR); SSIM is the substitute metric")
        print(f"{mode}: {mean_ms:.1f}±{std_ms:.1f} ms "
              f"({mrays:.2f} Mrays/s), SSIM {s:.4f}, LPIPS {lp}",
              file=sys.stderr)
    return results


def main(argv=None):
    args = parse_args(argv)
    print(json.dumps(evaluate(load_model(args), args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
