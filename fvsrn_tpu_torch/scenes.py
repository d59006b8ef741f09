"""Benchmark scenes of the port.

Counterpart of ``fvsrn_tpu/scenes.py``: each scene is (analytic volume,
TF, weights path).

- ``dense``: the Marschner-Lobb flagship with a ramp-from-zero TF, under
  which every density maps to a nonzero opacity (no empty space to skip);
- ``sparse``: the MULTI_SHELL field with a zero-opacity band below
  density 0.30, where occupancy culling has empty space to skip;
- ``dense_tf_modes``: the dense flagship's ramp TF in the other TF modes
  the fused marches take (texture, 1D- and 2D-preintegrated, Gaussians).
"""
from __future__ import annotations

import os

import torch

from .transfer import (TransferFunctionGaussian,
                       TransferFunctionPiecewiseLinear,
                       TransferFunctionTexture)
from .volume.implicit import VolumeInterpolationImplicit

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")

# the zero band of the sparse TF: opacity == 0 for density < this
SPARSE_ZERO_BAND = 0.30


def dense_scene():
    """(volume, tf, weights_path) of the dense-TF flagship; the weights
    are the ``.npz`` export of ``assets/flagship_mlobb.hdf5``."""
    volume = VolumeInterpolationImplicit.make("MARSCHNER_LOBB")
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.1, 0.1, 0.8], [0.9, 0.4, 0.1], [1.0, 1.0, 0.6]],
        opacity=[0.0, 10.0, 30.0], positions=[0.0, 0.5, 1.0])
    return volume, tf, os.path.join(ASSET_DIR, "flagship_mlobb_torch.npz")


def sparse_scene():
    """(volume, tf, weights_path) of the sparse-TF flagship; the weights
    are the ``.npz`` export of ``assets/flagship_shell.hdf5``."""
    volume = VolumeInterpolationImplicit.make("MULTI_SHELL")
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.2, 0.4, 1.0], [0.2, 0.4, 1.0], [1.0, 0.6, 0.15],
             [1.0, 0.95, 0.7]],
        opacity=[0.0, 0.0, 18.0, 40.0],
        positions=[0.0, SPARSE_ZERO_BAND, 0.6, 1.0])
    return volume, tf, os.path.join(ASSET_DIR, "flagship_shell_torch.npz")


def dense_tf_modes(stepsize: float, texels: int = 256,
                   preint_1d: int = 512, preint_2d: int = 128) -> dict:
    """The dense flagship's ramp TF as a ``texels``-texel texture (sampled
    at the texel centers), that texture with its 1D preintegration
    (``preint_1d`` + 1 rows) and with its 2D preintegration
    (``preint_2d``^2 cells at ``stepsize``), and a sum of four Gaussians
    over the ramp's colors: {tf_mode: TF} on the CPU."""
    _, ramp, _ = dense_scene()
    d = (torch.arange(texels, dtype=torch.float32) + 0.5) / texels
    tex = TransferFunctionTexture(ramp.eval_normalized(d, None, None, 1.0))
    gauss = TransferFunctionGaussian(torch.tensor(
        [[0.1, 0.1, 0.8, 6.0, 0.25, 0.12],
         [0.9, 0.4, 0.1, 12.0, 0.5, 0.1],
         [1.0, 0.7, 0.3, 20.0, 0.72, 0.1],
         [1.0, 1.0, 0.6, 30.0, 0.95, 0.08]]))
    return {"texture": tex,
            "preint1d": tex.with_preintegration(preint_1d),
            "preint2d": tex.with_preintegration_2d(preint_2d,
                                                   stepsize=stepsize),
            "gaussian": gauss}
