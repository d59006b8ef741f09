"""Ensemble generalization: retrain only the latent grids.

Counterpart of ``fvsrn_tpu/train/generalization.py``: a trained network
gets a fresh ensemble latent grid for new ensemble members
(``generalize_to_new_ensembles``, drawn with numpy's
``default_rng(seed)``, so the grid is the JAX package's bit for bit), and
``latent_only_mask``, passed as ``trainable`` to
``train.world.make_train_step``, zeroes every gradient outside the latent
space, so the step fits the grids with the MLP frozen.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..models.srn import SceneRepresentationNetwork


def generalize_to_new_ensembles(net: SceneRepresentationNetwork,
                                num_ensembles: int, std: float = 0.01,
                                seed: int = 0) -> SceneRepresentationNetwork:
    """A copy of ``net`` whose ensemble grid is replaced by a fresh one of
    ``num_ensembles`` members, normal with ``std``; the rest is shared
    with ``net`` by value (copied)."""
    grid = net.latent.ensemble_grid
    if grid is None:
        raise ValueError(
            "network was not built with ensemble-dependent latent grids")
    rng = np.random.default_rng(seed)
    fresh = (rng.standard_normal((num_ensembles,) + tuple(grid.shape[1:]))
             * std).astype(np.float32)
    out = copy.deepcopy(net)
    out.latent.ensemble_grid = nn.Parameter(
        torch.from_numpy(fresh).to(grid.device))
    return out


def latent_only_mask(network: SceneRepresentationNetwork) -> None:
    """Zero the gradient of every parameter outside ``network.latent``
    (in place; a missing gradient becomes zeros, as the JAX mask gives
    zeros to every leaf)."""
    latent = {id(p) for p in network.latent.parameters()}
    for p in network.parameters():
        if id(p) not in latent:
            p.grad = torch.zeros_like(p)
