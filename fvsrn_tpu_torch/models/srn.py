"""Scene representation network (SRN).

Counterpart of ``fvsrn_tpu/models/srn.py``: Fourier input
parametrization (position, direction and time), a stack of linear layers
with the activation zoo, the output parametrizations, and latent
conditioning (grids, keyframed grids, latent vectors). Weights follow
``nn.Linear`` conventions, (out, in), as in the JAX package. Networks
are built from exported arrays (``fvsrn_tpu_torch.convert``) or freshly
by ``SceneRepresentationNetwork.make``, whose numpy draws repeat the JAX
package's, so one seed gives bit-identical initial weights; every array
is an ``nn.Parameter`` that the screen trainer (``train/screen.py``)
updates.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import Tensor, nn

from .activations import apply_activation, parse_activation
from .latent import LatentSpace

OUTPUT_MODES = ("density", "density:direct", "rgbo", "rgbo:direct",
                "rgbo:exp")


class InputParametrization(nn.Module):
    """Fourier features: the output is [base inputs, cos(x B^T),
    sin(x B^T), cos(t Bt^T), sin(t Bt^T), extra channels], with the
    position (and direction) Fourier matrix B (F, 3|6) and the time one Bt
    (Ft, 1), both premultiplied by 2*pi. The input is [position,
    direction, time, extra]; the time column is an input when the network
    has time Fourier features or takes time directly
    (``use_time_direct``, which also passes it on as a base input)."""

    def __init__(self, fourier_matrix: Optional[Tensor] = None,
                 has_direction: bool = False,
                 disable_direction_in_fourier: bool = True,
                 fourier_matrix_time: Optional[Tensor] = None,
                 use_time_direct: bool = False):
        super().__init__()
        self.fourier_matrix = (nn.Parameter(fourier_matrix)
                               if fourier_matrix is not None else None)
        self.fourier_matrix_time = (nn.Parameter(fourier_matrix_time)
                                    if fourier_matrix_time is not None
                                    else None)
        self.has_direction = has_direction
        self.disable_direction_in_fourier = disable_direction_in_fourier
        self.use_time_direct = bool(use_time_direct)

    @classmethod
    def make(cls, num_fourier: int = 0, fourier_std: float = 1.0,
             has_direction: bool = False,
             disable_direction_in_fourier: bool = True,
             use_time_direct: bool = False, num_time_fourier: int = 0,
             seed: int = 42) -> "InputParametrization":
        """Gaussian (``fourier_std`` > 0) or NeRF block-identity
        (``fourier_std`` <= 0) Fourier matrices, drawn with
        ``np.random.default_rng(seed)``: ``num_fourier`` features in all,
        the last ``num_time_fourier`` of them of time."""
        rng = np.random.default_rng(seed)
        out = 6 if (has_direction and not disable_direction_in_fourier) else 3
        num_pos = (num_fourier - num_time_fourier if num_time_fourier > 0
                   else num_fourier)
        b = b_time = None
        if num_fourier > 0:
            if fourier_std > 0:
                b = rng.normal(0.0, fourier_std, (num_pos, out))
                b = b * (2 * np.pi)
            else:
                blocks = int(np.ceil(num_pos / out))
                b = np.concatenate([2.0 ** i * np.eye(out)
                                    for i in range(blocks)],
                                   axis=0)[:num_pos] * (2 * np.pi)
            b = torch.from_numpy(b.astype(np.float32))
            if num_time_fourier > 0:
                if fourier_std > 0:
                    bt = rng.normal(0.0, fourier_std, (num_time_fourier, 1))
                else:
                    bt = np.asarray([[2 ** i]
                                     for i in range(num_time_fourier)])
                b_time = torch.from_numpy(
                    (bt * (2 * np.pi)).astype(np.float32))
        return cls(b, has_direction=has_direction,
                   disable_direction_in_fourier=disable_direction_in_fourier,
                   fourier_matrix_time=b_time,
                   use_time_direct=use_time_direct)

    @property
    def num_fourier(self) -> int:
        return sum(m.shape[0] for m in (self.fourier_matrix,
                                        self.fourier_matrix_time)
                   if m is not None)

    def has_time(self) -> bool:
        return self.use_time_direct or self.fourier_matrix_time is not None

    def num_input_channels(self) -> int:
        return (3 + (3 if self.has_direction else 0)
                + (1 if self.has_time() else 0))

    def num_direct_output_channels(self) -> int:
        return (3 + (3 if self.has_direction else 0)
                + (1 if self.use_time_direct else 0))

    def num_output_channels(self) -> int:
        return self.num_direct_output_channels() + 2 * self.num_fourier

    def forward(self, x: Tensor) -> Tensor:
        """(N, inputs + extra) -> (N, outputs + extra). The time Fourier
        features read column 3, as in the JAX package (the time column
        of a network without direction input)."""
        parts = [x[:, :self.num_direct_output_channels()]]
        if self.fourier_matrix is not None:
            n_f = self.fourier_matrix.shape[1]
            f = x[:, :n_f] @ self.fourier_matrix.T
            parts += [torch.cos(f), torch.sin(f)]
        if self.fourier_matrix_time is not None:
            ft = x[:, 3:4] @ self.fourier_matrix_time.T
            parts += [torch.cos(ft), torch.sin(ft)]
        parts.append(x[:, self.num_input_channels():])
        return torch.cat(parts, dim=1)


class Layer(nn.Module):
    """One linear layer, weight (out, in), followed by its activation."""

    def __init__(self, weight: Tensor, bias: Tensor,
                 activation: str = "None", activation_param: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.activation = activation
        self.activation_param = float(activation_param)

    def forward(self, x: Tensor) -> Tensor:
        y = x @ self.weight.T + self.bias
        return apply_activation(self.activation, y, self.activation_param)


def apply_output(mode: str, x: Tensor, eval_mode: str = "screen") -> Tensor:
    """Output parametrization of the last layer's pre-activation."""
    if mode == "density":
        return torch.sigmoid(x)
    if mode == "density:direct":
        return torch.clamp(x, 0.0, 1.0) if eval_mode == "screen" else x
    rgb, absorption = x[..., :3], x[..., 3:]
    if mode == "rgbo":
        rgb = torch.sigmoid(rgb)
        absorption = nn.functional.softplus(absorption)
    elif mode == "rgbo:direct":
        if eval_mode == "screen":
            rgb = torch.clamp(rgb, 0.0, 1.0)
            absorption = torch.clamp(absorption, min=0.0)
    elif mode == "rgbo:exp":
        rgb = torch.sigmoid(rgb)
        absorption = torch.exp(absorption)
    else:
        raise ValueError(f"unknown output mode {mode}")
    return torch.cat([rgb, absorption], dim=-1)


class SceneRepresentationNetwork(nn.Module):
    def __init__(self, input: InputParametrization, layers: Sequence[Layer],
                 latent: LatentSpace, output_mode: str = "density"):
        super().__init__()
        if output_mode not in OUTPUT_MODES:
            raise ValueError(f"output_mode must be one of {OUTPUT_MODES}")
        self.input = input
        self.layers = nn.ModuleList(layers)
        self.latent = latent
        self.output_mode = output_mode

    @classmethod
    def make(cls, *, layers: str = "32:32:32", activation: str = "SnakeAlt:2",
             output_mode: str = "density", num_fourier: int = 14,
             fourier_std: float = 1.0, use_direction: bool = False,
             disable_direction_in_fourier: bool = True,
             use_time_direct: bool = False, num_time_fourier: int = 0,
             latent: Optional[LatentSpace] = None,
             seed: int = 42) -> "SceneRepresentationNetwork":
        """Build with torch ``nn.Linear``'s default init, drawn with
        ``np.random.default_rng(seed + 1)`` (the Fourier matrix with
        ``seed``) in the JAX package's order."""
        if output_mode not in OUTPUT_MODES:
            raise ValueError(f"output_mode must be one of {OUTPUT_MODES}")
        latent = latent if latent is not None else LatentSpace()
        inp = InputParametrization.make(
            num_fourier=num_fourier, fourier_std=fourier_std,
            has_direction=use_direction,
            disable_direction_in_fourier=disable_direction_in_fourier,
            use_time_direct=use_time_direct,
            num_time_fourier=num_time_fourier, seed=seed)
        act_name, act_param = parse_activation(activation)
        sizes = [int(s) for s in layers.split(":")]
        out_channels = 1 if output_mode.startswith("density") else 4
        rng = np.random.default_rng(seed + 1)
        layer_list = []
        last = inp.num_output_channels() + latent.total_channels
        specs = [(s, (act_name, act_param)) for s in sizes]
        specs.append((out_channels, ("None", 1.0)))
        for i, (size, act) in enumerate(specs):
            bound = 1.0 / math.sqrt(last)
            w = rng.uniform(-bound, bound, (size, last)).astype(np.float32)
            b = rng.uniform(-bound, bound, (size,)).astype(np.float32)
            if i == len(sizes) and out_channels == 4:
                b = np.abs(b) + 1.0     # positive initial output
            layer_list.append(Layer(torch.from_numpy(w), torch.from_numpy(b),
                                    activation=act[0],
                                    activation_param=act[1]))
            last = size
        return cls(inp, layer_list, latent, output_mode=output_mode)

    @property
    def use_direction(self) -> bool:
        return self.input.has_direction

    def forward(self, x: Tensor, tf: Optional[Tensor] = None,
                time: Optional[Tensor] = None,
                ensemble: Optional[Tensor] = None,
                mode: str = "screen") -> Tensor:
        """x (N, 3) positions in [0, 1]^3, or (N, 6) with direction;
        ``time``/``ensemble`` (N,) conditioning, zeros by default (``tf``,
        the TF index, conditions nothing, as in the JAX package). Returns
        (N, 1) for density networks, (N, 4) for rgbo ones."""
        if mode not in ("screen", "world"):
            raise ValueError(mode)
        n = x.shape[0]
        if time is None:
            time = x.new_zeros(n)
        if ensemble is None:
            ensemble = x.new_zeros(n)
        parts = [x]
        if self.input.has_time():
            parts.append(time.reshape(n, 1).to(x.dtype))
        feats = self.latent.evaluate(x[:, :3], time, ensemble)
        y = self.input(torch.cat(parts + feats, dim=1))
        for layer in self.layers:
            y = layer(y)
        return apply_output(self.output_mode, y, mode)
