"""Network-vs-classical-compression comparison ("teaser" figure), the port
of ``fvsrn_tpu/eval/eval_compression_teaser.py``.

Rebuild of the reference's compression comparison
(reference: applications/volnet/eval_CompressionTeaser.py:1-8,169-241):
fit an SRN at a given parameter budget, compare against TThresh, Tucker,
quantization and DWT baselines (``compression.py``, NumPy on the host),
report bytes, ratio and reconstruction PSNR. The implicit field is
voxelized and the SRN fitted on the device (world training: plain
PyTorch, no TPU kernel on this path); the network's reconstruction PSNR
comes from the network volume on the device.

Usage: python -m fvsrn_tpu_torch.eval.eval_compression_teaser
       [--resolution 64] [--equation E] [--train-epochs N]
       [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _network_bytes(net) -> int:
    """The network's size stored as float16: every parameter once (the
    leaves of the JAX package's network: Fourier matrices, layers, latent
    grids and vectors)."""
    return sum(p.detach().cpu().numpy().astype(np.float16).nbytes
               for p in net.parameters())


def teaser(resolution: int = 64, equation: str = "MARSCHNER_LOBB",
           train_epochs: int = 60, *, device="cuda") -> dict:
    """The comparison table: each codec's {bytes, ratio, psnr} and the
    network's {bytes, ratio, psnr, final_l1}."""
    from ..compression import compression_teaser
    from ..models.latent import LatentSpace
    from ..models.network_volume import VolumeInterpolationNetwork
    from ..models.srn import SceneRepresentationNetwork
    from ..train.losses import LossNetWorld
    from ..train.optimizer import make_optimizer
    from ..train.world import build_world_dataset, train_world_epochs
    from ..utils.device import resolve_device
    from ..volume.grid import VolumeInterpolationGrid
    from ..volume.implicit import create_implicit_grid

    dev = resolve_device(device)
    grid_t = create_implicit_grid(resolution, equation, device=dev)
    grid = grid_t.cpu().numpy()
    volume = VolumeInterpolationGrid.from_grid(grid_t)

    rng = np.random.default_rng(0)
    latent = LatentSpace(static_grid=torch.from_numpy(
        (rng.standard_normal((8, 16, 16, 16)) * 0.01).astype(np.float32)))
    net = SceneRepresentationNetwork.make(
        layers="32:32", activation="SnakeAlt:2", num_fourier=10,
        output_mode="density:direct", latent=latent, seed=2).to(dev)
    ds = build_world_dataset(volume, 65536, sampler="halton", device=dev)
    loss = LossNetWorld(mode="density", l1=1.0)

    def make_opt(params):
        return make_optimizer(params, "Adam", lr=5e-3, lr_step=1000,
                              lr_gamma=0.5)

    net, hist = train_world_epochs(net, ds, loss, make_opt, batch_size=8192,
                                   epochs=train_epochs)
    print(f"fit: L1 {hist[0]:.4f} -> {hist[-1]:.4f}", file=sys.stderr)

    # network reconstruction PSNR on the voxel grid
    netvol = VolumeInterpolationNetwork(net)
    axes = (np.arange(resolution) + 0.5) / resolution
    gx, gy, gz = np.meshgrid(axes, axes, axes, indexing="ij")
    pos = torch.as_tensor(np.stack([gx, gy, gz], -1).reshape(-1, 3),
                          dtype=torch.float32, device=dev)
    with torch.no_grad():
        world = netvol.box_min + pos * netvol.box_size
        rec = netvol.eval_density(world)[0].cpu().numpy().reshape(grid.shape)
    mse = float(np.mean((rec - grid) ** 2))
    rng_ = float(grid.max() - grid.min()) or 1.0
    net_psnr = 10 * np.log10(rng_ * rng_ / max(mse, 1e-12))

    table = compression_teaser(grid, _network_bytes(net))
    table["network"]["psnr"] = round(net_psnr, 2)
    table["network"]["final_l1"] = round(hist[-1], 5)
    return table


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--equation", default="MARSCHNER_LOBB")
    p.add_argument("--train-epochs", type=int, default=60)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    table = teaser(args.resolution, args.equation, args.train_epochs,
                   device=args.device)
    print(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
