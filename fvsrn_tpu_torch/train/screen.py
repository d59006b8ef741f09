"""Screen-space SRN training: a differentiable render and an image loss.

Counterpart of ``fvsrn_tpu/train/screen.py``:

- ``build_screen_dataset``: fibonacci-sphere cameras and ground-truth
  renders of the reference volume by the plain ``trace_dvr``, optionally
  cached in an ``.npz`` file (the JAX package's hdf5 cache, the same
  reuse rule: the file is read when its camera count, width and height
  match, else the dataset is rendered again and the file rewritten);
- ``evaluate_screen``: the differentiable render of the SRN plus the image
  loss, through a fused march chosen by the JAX package's engine rule
  (``fused_kwargs["engine"]``: "scan", the default, is the per-segment
  engine's ``ops.fused_dvr.fused_trace_dvr(differentiable=True)``;
  "mega", which :func:`screen_mega_kwargs` sets, the megakernel's
  ``ops.fused_mega.mega_trace_dvr``; the CUDA kernels on the card, their
  plain versions on the CPU) or through the plain ``trace_dvr`` with
  per-step checkpointing;
- ``train_screen``: the epoch loop over camera minibatches, one Adam step
  and one scheduler step per minibatch, aborting on a non-finite loss;
  given a ``parallel.mesh.Mesh``, the same loop over its ranks (BASELINE
  config 4), the gradients averaged over the ranks
  (``parallel.train_step.make_dp_screen_train_step``);
  ``train_screen_dp`` is that loop under the JAX package's name.

Each epoch's camera order is JAX's ``random.permutation`` of the epoch's
key (``utils.prng``, bit for bit), as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from ..camera import fibonacci_sphere_cameras, generate_rays
from ..models.network_volume import VolumeInterpolationNetwork
from ..ops.fused_dvr import (block_ray_permutation, fused_tf_args,
                             fused_trace_dvr, mega_supported, require_srn)
from ..ops.fused_mega import KERNEL_SEG, KERNEL_TILE, mega_trace_dvr
from ..raytracer.dvr import (RayEvaluationSteppingDvr, max_steps_bound,
                             trace_dvr)
from ..transfer import (TransferFunctionGaussian,
                        TransferFunctionPiecewiseLinear,
                        TransferFunctionTexture)
from ..utils import prng
from ..utils.device import resolve_device
from .losses import LossNetScreen


class ScreenDataset(NamedTuple):
    """Per-camera rays and ground-truth rgba images (flattened)."""
    ray_start: Tensor   # (C, H*W, 3)
    ray_dir: Tensor     # (C, H*W, 3)
    targets: Tensor     # (C, H*W, 4)
    width: int
    height: int


def build_screen_dataset(volume, tf, config: RayEvaluationSteppingDvr, *,
                         num_cameras: int = 16, width: int = 64,
                         height: int = 64, distance: float = 1.6,
                         center=(0.0, 0.0, 0.0),
                         max_steps: Optional[int] = None,
                         render_chunk: int = 1 << 18,
                         cache_path: Optional[str] = None,
                         device="cuda") -> ScreenDataset:
    """Render ground-truth images of ``volume`` from fibonacci-sphere
    cameras on ``device``. ``render_chunk`` rays are marched at a time
    (the result does not depend on it). ``cache_path``: an ``.npz`` file
    read instead of rendering when its ``num_cameras``, ``width`` and
    ``height`` match (nothing else is compared, as in the JAX package),
    else written after rendering."""
    dev = resolve_device(device)
    if cache_path is not None and os.path.exists(cache_path):
        with np.load(cache_path) as f:
            if (int(f["num_cameras"]) == num_cameras
                    and int(f["width"]) == width
                    and int(f["height"]) == height):
                return ScreenDataset(
                    *(torch.from_numpy(f[k]).to(dev)
                      for k in ("ray_start", "ray_dir", "targets")),
                    width, height)
    volume = volume.to(dev)
    tf = tf.to(dev)
    cams = fibonacci_sphere_cameras(num_cameras, center=center,
                                    distance=distance)
    start, direction = generate_rays(cams, width, height, device=dev)
    start = start.reshape(num_cameras, -1, 3).contiguous()
    direction = direction.reshape(num_cameras, -1, 3).contiguous()
    if max_steps is None:
        max_steps = max_steps_bound(volume.box_size.tolist(),
                                    float(config.stepsize))
    targets = []
    with torch.no_grad():
        for c in range(num_cameras):
            targets.append(torch.cat([
                trace_dvr(start[c, i:i + render_chunk],
                          direction[c, i:i + render_chunk], volume, tf,
                          config, max_steps).color
                for i in range(0, start.shape[1], render_chunk)]))
    ds = ScreenDataset(start, direction, torch.stack(targets), width, height)
    if cache_path is not None:
        # a file object: np.savez would append ".npz" to a bare path
        with open(cache_path, "wb") as f:
            np.savez(f, num_cameras=num_cameras, width=width, height=height,
                     **{k: getattr(ds, k).cpu().numpy()
                        for k in ("ray_start", "ray_dir", "targets")})
    return ds


def fused_screen_supported(network, tf, width: int, height: int) -> bool:
    """Whether screen training routes through the fused march, by the JAX
    package's rule: a piecewise-linear, texture (any preintegration) or
    Gaussian TF, images that tile into 16x16 pixel blocks with at least
    one 256-ray tile, and no latent grid or one that fits the JAX
    megakernel's float32 slab (``ops.fused_dvr.mega_supported``: <= 16
    channels within its budget; a larger grid trains by the plain march,
    as in JAX); keyframed time or ensemble grids train by the plain march
    (their per-frame resolve is not certified by the JAX screen
    trainer), latent vectors fused (folded into layer 0's bias at time 0,
    ensemble 0). One difference on purpose: a Gaussian TF that is
    ``analytic`` or ``scale_with_gradient`` trains by the plain march,
    since the fused kernels evaluate neither (the JAX package routes it
    fused and trains the plain Gaussians instead). The network is not
    screened here: the kernels train every TF mode on every activation,
    with or without direction input, at hidden widths up to 64; where
    they do not take a network (hidden layers wider than 64, say),
    ``mega_trace_dvr`` raises ``NotImplementedError`` on the card
    (``--no_fused`` selects the plain march). A network that is
    not an SRN (the variant and meta networks) raises
    ``NotImplementedError``: it trains by the plain march alone."""
    require_srn(network, "fused screen step")
    if isinstance(tf, TransferFunctionGaussian):
        if tf.analytic or tf.scale_with_gradient:
            return False
    elif not isinstance(tf, (TransferFunctionPiecewiseLinear,
                             TransferFunctionTexture)):
        return False
    if width % 16 or height % 16 or width * height < KERNEL_TILE:
        return False
    lat = network.latent
    if lat.time_grid is not None or lat.ensemble_grid is not None:
        return False
    grid = lat.static_grid
    return grid is None or mega_supported(tuple(grid.shape), torch.float32)


def screen_mega_kwargs(dataset: ScreenDataset) -> dict:
    """The ``fused_kwargs`` of :func:`evaluate_screen` that select the
    megakernel (``engine="mega"``), with the 16x16 pixel-block
    permutation that makes every 256-ray tile spatially coherent. (The JAX
    package also certifies a latent footprint here for the TPU's resident
    slab; the CUDA kernels fetch from the whole table and need none.)"""
    perm, inv = block_ray_permutation(dataset.width, dataset.height, 16, 16,
                                      device=dataset.ray_start.device)
    return dict(engine="mega", block_perm=perm, block_perm_inv=inv,
                seg=KERNEL_SEG, tile=KERNEL_TILE)


# fused_kwargs that only the TPU kernels read
_TPU_ONLY_KWARGS = ("interpret", "subbox")


def evaluate_screen(network, batch_rays_start: Tensor,
                    batch_rays_dir: Tensor, batch_targets: Tensor, tf,
                    config: RayEvaluationSteppingDvr, loss: LossNetScreen,
                    max_steps: int, width: int, height: int,
                    use_fused: bool = False,
                    fused_kwargs: Optional[dict] = None):
    """Differentiable render + image loss: (total, individual terms).
    ``use_fused`` routes the render through a fused march by the JAX
    package's rule: ``fused_kwargs["engine"]`` "scan" (the default) runs
    the per-segment engine's differentiable march (per-ray sampling, no
    early-out: every segment runs), "mega" (:func:`screen_mega_kwargs`)
    the megakernel on rays reordered by ``block_perm`` (32-point
    segments, 256-ray tiles, the tile vote unless ``enable_early_out`` is
    False). The remaining keys go to the march (``seg``, ``tile``,
    ``enable_early_out``, ``alpha_early_out``, ``density_min``,
    ``density_max``, ``table_dtype``, ``latent_mode``, ...); the TF's
    ``tf_mode`` and ``tf_pre`` come from the TF unless given
    (``ops.fused_dvr.fused_tf_args``); ``interpret`` and ``subbox``,
    which only the TPU kernels read, are accepted and ignored. Otherwise
    the plain march runs with per-step checkpointing."""
    netvol = VolumeInterpolationNetwork(network)
    box = (netvol.box_min.tolist(), netvol.box_size.tolist())
    fk = {k: v for k, v in (fused_kwargs or {}).items()
          if k not in _TPU_ONLY_KWARGS}
    engine = fk.pop("engine", "scan") if use_fused else "scan"
    if use_fused and "tf_mode" not in fk:
        fk.update(fused_tf_args(tf)[1])
    if use_fused and engine == "mega":
        perm = fk.pop("block_perm", None)
        inv = fk.pop("block_perm_inv", None)
        hw = width * height
        rs = batch_rays_start.reshape(-1, hw, 3)
        rd = batch_rays_dir.reshape(-1, hw, 3)
        if perm is not None:
            rs, rd = rs[:, perm], rd[:, perm]
        color = mega_trace_dvr(
            rs.reshape(-1, 3), rd.reshape(-1, 3), network, *box, tf.tensor,
            stepsize=float(config.stepsize), differentiable=True, **fk)
        color = color.reshape(-1, hw, 4)
        if inv is not None:
            color = color[:, inv]
        color = color.reshape(-1, 4)
    elif use_fused:
        color = fused_trace_dvr(
            batch_rays_start.reshape(-1, 3), batch_rays_dir.reshape(-1, 3),
            network, *box, tf.tensor, stepsize=float(config.stepsize),
            max_steps=max_steps, enable_early_out=False, differentiable=True,
            **fk)
    else:
        color = trace_dvr(batch_rays_start.reshape(-1, 3),
                          batch_rays_dir.reshape(-1, 3), netvol, tf, config,
                          max_steps, checkpoint_chunk=1).color
    b = batch_targets.shape[0] if batch_targets.ndim == 3 else 1
    pred = color.reshape(b, height, width, 4).permute(0, 3, 1, 2)
    ref = batch_targets.reshape(b, height, width, 4).permute(0, 3, 1, 2)
    return loss(pred, ref, return_individual=True)


def train_screen(network, dataset: ScreenDataset, tf,
                 config: RayEvaluationSteppingDvr, loss: LossNetScreen,
                 optimizer, *, epochs: int, cameras_per_batch: int = 1,
                 max_steps: Optional[int] = None, key=None,
                 use_fused: bool = False,
                 fused_kwargs: Optional[dict] = None,
                 callback: Optional[Callable] = None, mesh=None):
    """Epoch loop over camera minibatches. ``optimizer`` is the
    ``(torch.optim.Optimizer, scheduler)`` pair of
    ``train.optimizer.make_optimizer``; the scheduler steps after every
    update. Each epoch's order is ``prng.permutation(sub, C)`` with
    ``key, sub = prng.split(key)`` (``key`` default ``prng_key(0)``, the
    JAX package's). ``mesh`` (a ``parallel.mesh.Mesh``): data-parallel
    over its ranks (BASELINE config 4), called on every rank with the
    whole dataset. The network is first broadcast from rank 0, each
    minibatch holds ``cameras_per_batch`` cameras a rank, rank r takes
    its slice, and the gradients are averaged over the ranks
    (``parallel.train_step.make_dp_screen_train_step``): the
    single-process step on the whole minibatch. Every rank draws the same
    order. Raises ``ValueError`` when the camera count is not a multiple
    of the world size, and ``FloatingPointError`` when an epoch's mean
    loss is not finite. Returns (network, history of per-epoch mean
    losses), the same on every rank."""
    opt, scheduler = optimizer
    if key is None:
        key = prng.prng_key(0)
    n_cams = dataset.ray_start.shape[0]
    if max_steps is None:
        max_steps = max_steps_bound((1.0, 1.0, 1.0), float(config.stepsize))
    tf = tf.to(dataset.ray_start.device)
    if mesh is None:
        def step(rs, rd, tgt):
            opt.zero_grad(set_to_none=True)
            total, _ = evaluate_screen(
                network, rs, rd, tgt, tf, config, loss, max_steps,
                dataset.width, dataset.height, use_fused=use_fused,
                fused_kwargs=fused_kwargs)
            total.backward()
            opt.step()
            scheduler.step()
            return total.detach()
    else:
        from ..parallel.mesh import replicate, shard_batch
        from ..parallel.train_step import make_dp_screen_train_step

        if n_cams % mesh.world_size:
            raise ValueError(f"need cameras ({n_cams}) divisible by the "
                             f"world size ({mesh.world_size})")
        cameras_per_batch *= mesh.world_size
        replicate(mesh, network)
        dp_step = make_dp_screen_train_step(
            mesh, tf, config, loss, optimizer, width=dataset.width,
            height=dataset.height, max_steps=max_steps, use_fused=use_fused,
            fused_kwargs=fused_kwargs)

        def step(*batch):
            return dp_step(network, *shard_batch(mesh, batch))
    history = []
    for e in range(epochs):
        key, sub = prng.split(key)
        perm = prng.permutation(sub, n_cams)
        totals = []
        for i in range(0, n_cams, cameras_per_batch):
            idx = perm[i:i + cameras_per_batch].to(dataset.ray_start.device)
            totals.append(float(step(dataset.ray_start[idx],
                                     dataset.ray_dir[idx],
                                     dataset.targets[idx])))
        history.append(float(np.mean(totals)))
        if callback is not None:
            callback(e, network, history[-1])
        if not np.isfinite(history[-1]):
            raise FloatingPointError(
                f"screen training loss became non-finite at epoch {e}")
    return network, history


def train_screen_dp(network, dataset: ScreenDataset, tf,
                    config: RayEvaluationSteppingDvr, loss: LossNetScreen,
                    optimizer, *, epochs: int, mesh, **kwargs):
    """The JAX package's name for :func:`train_screen` over the ranks of
    ``mesh``: one camera a rank a step unless ``cameras_per_batch`` says
    more."""
    return train_screen(network, dataset, tf, config, loss, optimizer,
                        epochs=epochs, mesh=mesh, **kwargs)
