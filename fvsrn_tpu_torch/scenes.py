"""Benchmark scenes of the port.

Counterpart of ``fvsrn_tpu/scenes.py`` for the dense flagship: the
Marschner-Lobb SRN with a ramp-from-zero TF, under which every density
maps to a nonzero opacity (no empty space to skip). The analytic volume
and the sparse scene are not ported yet.
"""
from __future__ import annotations

import os

from .transfer import TransferFunctionPiecewiseLinear

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def dense_scene():
    """(tf, weights_path) of the dense-TF flagship; the weights are the
    ``.npz`` export of ``assets/flagship_mlobb.hdf5``."""
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.1, 0.1, 0.8], [0.9, 0.4, 0.1], [1.0, 1.0, 0.6]],
        opacity=[0.0, 10.0, 30.0], positions=[0.0, 0.5, 1.0])
    return tf, os.path.join(ASSET_DIR, "flagship_mlobb_torch.npz")
