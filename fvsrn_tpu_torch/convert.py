"""Build the port's SRN from weights exported by the JAX package.

The arrays are keyed by their pytree path in the JAX network
(``input.fourier_matrix``, ``input.fourier_matrix_time``,
``layers.{i}.weight``, ``layers.{i}.bias``, ``latent.static_grid``,
``latent.time_grid``, ``latent.ensemble_grid``, ``latent.time_vector``,
``latent.ensemble_vector``); ``meta`` carries the static fields, which
the arrays cannot hold. ``tools/export_torch_weights.py`` writes both.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.latent import LatentSpace
from .models.srn import InputParametrization, Layer, SceneRepresentationNetwork

LATENT_KEYS = ("static_grid", "time_grid", "ensemble_grid", "time_vector",
               "ensemble_vector")
SUPPORTED_KEYS = (("input.fourier_matrix", "input.fourier_matrix_time")
                  + tuple(f"latent.{k}" for k in LATENT_KEYS))


def srn_from_arrays(arrays: dict[str, np.ndarray],
                    meta: dict) -> SceneRepresentationNetwork:
    """``meta``: {"layers": [{"activation", "activation_param"}, ...],
    "output_mode", "has_direction", "disable_direction_in_fourier",
    "use_time_direct", "time_dependent"} (the last two False when
    missing). Raises on arrays it does not know."""
    n_layers = len(meta["layers"])
    expected = set(SUPPORTED_KEYS) | {
        f"layers.{i}.{p}" for i in range(n_layers) for p in ("weight",
                                                             "bias")}
    unknown = set(arrays) - expected
    if unknown:
        raise NotImplementedError(
            f"arrays not supported by the port: {sorted(unknown)}")

    def t(key):
        a = arrays.get(key)
        return None if a is None else torch.from_numpy(
            np.array(a, dtype=np.float32))

    inp = InputParametrization(
        fourier_matrix=t("input.fourier_matrix"),
        has_direction=bool(meta.get("has_direction", False)),
        disable_direction_in_fourier=bool(
            meta.get("disable_direction_in_fourier", True)),
        fourier_matrix_time=t("input.fourier_matrix_time"),
        use_time_direct=bool(meta.get("use_time_direct", False)))
    layers = [Layer(t(f"layers.{i}.weight"), t(f"layers.{i}.bias"),
                    activation=spec["activation"],
                    activation_param=spec["activation_param"])
              for i, spec in enumerate(meta["layers"])]
    latent = LatentSpace(
        **{k: t(f"latent.{k}") for k in LATENT_KEYS},
        time_dependent=bool(meta.get("time_dependent", False)))
    return SceneRepresentationNetwork(inp, layers, latent,
                                      output_mode=meta["output_mode"])
