"""Build the port's SRN from weights exported by the JAX package.

The arrays are keyed by their pytree path in the JAX network
(``input.fourier_matrix``, ``input.fourier_matrix_time``,
``layers.{i}.weight``, ``layers.{i}.bias``, ``latent.static_grid``,
``latent.time_grid``, ``latent.ensemble_grid``, ``latent.time_vector``,
``latent.ensemble_vector``); ``meta`` carries the static fields, which
the arrays cannot hold. ``tools/export_torch_weights.py`` writes both.
:func:`lpips_from_jax` carries an LPIPS model's weights across the same
way. :func:`residual_sine_from_arrays`, :func:`modulated_sine_from_arrays`
and :func:`meta_from_arrays` carry the variant and meta networks
(``models/variants.py``, ``models/meta.py``) across, their arrays keyed
by their pytree paths in the same way (``first_w``, ``blocks.{i}.{j}``,
``syn_layers.{i}.{j}``, ``meta_layers.{i}.weight``, ...).
"""
from __future__ import annotations

import numpy as np
import torch

from .models.latent import LatentSpace
from .models.meta import MetaSceneNetwork
from .models.srn import InputParametrization, Layer, SceneRepresentationNetwork
from .models.variants import ModulatedSineNetwork, ResidualSineNetwork
from .train.lpips import LPIPS

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


def lpips_from_jax(conv_w, conv_b, lin_w, arch: str = "alex") -> LPIPS:
    """The port's ``LPIPS`` from the JAX package's model's leaves as
    NumPy arrays (``conv_w``, ``conv_b``, ``lin_w``: sequences of
    ``np.asarray`` of its fields of those names) and its ``arch``."""
    return LPIPS([np.asarray(w, np.float32) for w in conv_w],
                 [np.asarray(b, np.float32) for b in conv_b],
                 [np.asarray(w, np.float32) for w in lin_w], arch=arch)


def _input_and_latent(arrays: dict, names: set):
    """The Fourier input (no direction) and latent space of a variant or
    meta network's arrays; raises on arrays other than ``names``, the
    Fourier matrices and the latent arrays."""
    unknown = set(arrays) - set(names) - set(SUPPORTED_KEYS)
    if unknown:
        raise NotImplementedError(
            f"arrays not supported by the port: {sorted(unknown)}")

    def t(key):
        a = arrays.get(key)
        return None if a is None else torch.from_numpy(
            np.array(a, dtype=np.float32))

    inp = InputParametrization(fourier_matrix=t("input.fourier_matrix"))
    latent = LatentSpace(**{k: t(f"latent.{k}") for k in LATENT_KEYS})
    return inp, latent


def residual_sine_from_arrays(arrays: dict[str, np.ndarray],
                              meta: dict) -> ResidualSineNetwork:
    """``meta``: {"block_weights": [(a1, a2), ...], "omega0",
    "output_mode"}; arrays ``first_w``, ``first_b``, ``blocks.{i}.{0..3}``
    (w1, b1, w2, b2), ``out_w``, ``out_b`` and the Fourier matrix."""
    n = len(meta["block_weights"])
    names = {"first_w", "first_b", "out_w", "out_b"} | {
        f"blocks.{i}.{j}" for i in range(n) for j in range(4)}
    inp, _ = _input_and_latent(arrays, names)
    return ResidualSineNetwork(
        inp, arrays["first_w"], arrays["first_b"],
        [[arrays[f"blocks.{i}.{j}"] for j in range(4)] for i in range(n)],
        arrays["out_w"], arrays["out_b"],
        block_weights=meta["block_weights"], omega0=meta["omega0"],
        output_mode=meta["output_mode"])


def modulated_sine_from_arrays(arrays: dict[str, np.ndarray],
                               meta: dict) -> ModulatedSineNetwork:
    """``meta``: {"num_layers", "w0", "output_mode"}; arrays
    ``syn_layers.{i}.{0,1}`` and ``mod_layers.{i}.{0,1}`` (weight, bias),
    ``out_w``, ``out_b``, the latent vectors and the Fourier matrix."""
    n = int(meta["num_layers"])
    names = {"out_w", "out_b"} | {
        f"{k}.{i}.{j}" for k in ("syn_layers", "mod_layers")
        for i in range(n) for j in range(2)}
    inp, latent = _input_and_latent(arrays, names)
    return ModulatedSineNetwork(
        inp, latent,
        [(arrays[f"syn_layers.{i}.0"], arrays[f"syn_layers.{i}.1"])
         for i in range(n)],
        [(arrays[f"mod_layers.{i}.0"], arrays[f"mod_layers.{i}.1"])
         for i in range(n)],
        arrays["out_w"], arrays["out_b"], w0=meta["w0"],
        output_mode=meta["output_mode"])


def meta_from_arrays(arrays: dict[str, np.ndarray],
                     meta: dict) -> MetaSceneNetwork:
    """``meta``: {"meta_layers": [{"activation", "activation_param"},
    ...], "inner_shapes", "inner_activation", "inner_act_param",
    "output_mode"}; arrays ``meta_layers.{i}.weight`` and ``.bias``, the
    latent vectors and the Fourier matrix."""
    specs = meta["meta_layers"]
    names = {f"meta_layers.{i}.{p}" for i in range(len(specs))
             for p in ("weight", "bias")}
    inp, latent = _input_and_latent(arrays, names)

    def t(key):
        return torch.from_numpy(np.array(arrays[key], dtype=np.float32))

    layers = [Layer(t(f"meta_layers.{i}.weight"), t(f"meta_layers.{i}.bias"),
                    activation=spec["activation"],
                    activation_param=spec["activation_param"])
              for i, spec in enumerate(specs)]
    return MetaSceneNetwork(inp, layers, latent,
                            inner_shapes=meta["inner_shapes"],
                            inner_activation=meta["inner_activation"],
                            inner_act_param=meta["inner_act_param"],
                            output_mode=meta["output_mode"])
