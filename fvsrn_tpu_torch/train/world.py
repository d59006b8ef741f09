"""World-space SRN training: fit the network to volume samples.

Counterpart of ``fvsrn_tpu/train/world.py``:

- ``build_world_dataset``: positions in [0, 1]^3 from a sampler, targets
  from the volume on the caller's device (densities, or rgbo colors
  through the TF);
- ``evaluate_world``: the network's world-mode forward and the world
  loss;
- ``make_train_step`` / ``train_world_epochs``: the epoch loop over
  minibatches in the order of JAX's ``random.permutation`` (``utils.prng``,
  bit for bit), one optimizer and one scheduler step a minibatch,
  aborting on a non-finite epoch loss.

The JAX package runs no Pallas kernel here: its step is plain XLA, and
the port's is plain PyTorch (forward, autograd, Adam) on the card. JAX can
run an epoch as one ``lax.scan``; PyTorch has no counterpart, so
``scan_epoch`` is accepted and the steps run as a Python loop either way.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor

from .. import transfer as transfer_mod
from ..utils import prng
from ..utils.device import resolve_device
from .losses import LossNetWorld
from .sampling import get_sampled_positions


class WorldDataset(NamedTuple):
    """World-space training data on the device."""
    positions: Tensor  # (N, 3) in [0, 1]^3
    targets: Tensor    # (N, 1) densities or (N, 4) rgbo
    tf: Tensor         # (N,) tf index (conditioning)
    time: Tensor       # (N,)
    ensemble: Tensor   # (N,)


def build_world_dataset(volume, num_samples: int, *, sampler: str = "random",
                        tf=None, density_min: float = 0.0,
                        density_max: float = 1.0, stepsize: float = 1.0,
                        time: float = 0.0, ensemble: float = 0.0,
                        start_index: int = 0, key=None,
                        positions=None, device="cuda") -> WorldDataset:
    """Sample positions (or take ``positions``) and evaluate the targets
    on ``device``: densities (N, 1) with ``tf=None``, else rgbo colors
    (N, 4) of ``transfer.evaluate``. The volume is read at box_min + p *
    box_size."""
    dev = resolve_device(device)
    if positions is None:
        positions = get_sampled_positions(sampler, num_samples, 3,
                                          start_index, key=key, device=dev)
    positions = torch.as_tensor(positions, dtype=torch.float32).to(dev)
    volume = volume.to(dev)
    with torch.no_grad():
        world = volume.box_min + positions * volume.box_size
        density, _ = volume.eval_density(world)
        targets = density[..., None]
        if tf is not None:
            targets = transfer_mod.evaluate(tf.to(dev), targets, density_min,
                                            density_max, stepsize=stepsize)
    n = positions.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    return WorldDataset(positions=positions, targets=targets,
                        tf=torch.zeros(n, **f32),
                        time=torch.full((n,), time, **f32),
                        ensemble=torch.full((n,), ensemble, **f32))


def evaluate_world(network, batch: WorldDataset, loss: LossNetWorld):
    """Forward (the batch's time and ensemble conditioning the network)
    and loss on a batch: (total, individual losses)."""
    pred = network(batch.positions, batch.tf, batch.time, batch.ensemble,
                   mode="world")
    return loss(pred, batch.targets, return_individual=True)


def make_train_step(loss: LossNetWorld, optimizer,
                    trainable: Optional[Callable] = None):
    """The train step on ``optimizer``, an (optimizer, scheduler) pair of
    ``train.optimizer.make_optimizer``: (network, batch) -> (total,
    individual), the network updated in place. ``trainable(network)``
    masks the gradients after the backward and before the optimizer step,
    as the JAX package's mask of the gradient tree does (e.g.
    ``train.generalization.latent_only_mask``: a masked gradient is zero,
    and Adam moves no parameter whose gradients were always zero)."""
    opt, scheduler = optimizer

    def step(network, batch: WorldDataset):
        opt.zero_grad(set_to_none=True)
        total, individual = evaluate_world(network, batch, loss)
        total.backward()
        if trainable is not None:
            trainable(network)
        opt.step()
        scheduler.step()
        return total.detach(), individual

    return step


def train_world_epochs(network, dataset: WorldDataset, loss: LossNetWorld,
                       make_opt: Callable, *, batch_size: int, epochs: int,
                       key=None, shuffle: bool = True, callback=None,
                       scan_epoch: bool = True):
    """Run ``epochs`` epochs of minibatch training. ``make_opt(params)``
    returns a fresh (optimizer, scheduler) pair, as the JAX package
    initializes a fresh optimizer state at each call. Each epoch's order
    is ``permutation(sub, N)`` with ``key, sub = split(key)`` (``key``
    default ``prng_key(0)``); ``N // batch_size`` full batches a
    epoch. Returns (network, history of per-epoch mean losses)."""
    del scan_epoch  # one Python loop of steps (see the module docstring)
    if key is None:
        key = prng.prng_key(0)
    n = dataset.positions.shape[0]
    # a dataset smaller than one batch still trains, one full batch an epoch
    batch_size = min(batch_size, n)
    nbatch = n // batch_size
    dev = dataset.positions.device
    step = make_train_step(loss, make_opt(network.parameters()))
    history = []
    for e in range(epochs):
        key, sub = prng.split(key)
        perm = (prng.permutation(sub, n, device=dev) if shuffle
                else torch.arange(n, device=dev))
        totals = []
        for i in range(nbatch):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            batch = WorldDataset(*(a[idx] for a in dataset))
            totals.append(step(network, batch)[0])
        history.append(float(torch.mean(torch.stack(totals))))
        if callback is not None:
            callback(e, network, history[-1])
        if not math.isfinite(history[-1]):
            raise FloatingPointError(
                f"training loss became non-finite at epoch {e}")
    return network, history
