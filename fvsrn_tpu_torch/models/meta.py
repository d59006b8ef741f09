"""Meta-network SRN: a hypernetwork predicts the inner MLP's weights.

Counterpart of ``fvsrn_tpu/models/meta.py``: the latent conditioning
(time and ensemble vectors) feeds a meta MLP whose output is the flat
parameter vector of the inner network, unpacked layer by layer as the
(out, in) weight and then the bias; the inner network evaluates the
Fourier-encoded positions with those weights. Latents are uniform per
batch: the batch's first time and ensemble condition every position.

Pretraining: phase 1 trains a latent-independent parameter vector;
phase 2 fits the meta net to reproduce it for every training latent
(:func:`fit_meta_to_parameters`); phase 3 trains end to end.

The network renders and trains through the plain marches only
(``VolumeInterpolationNetwork`` -> ``trace_dvr``, ``LoadedModel``'s
PLAIN32); the fused kernels refuse it (``ops.fused_dvr.require_srn``).
``make`` draws from ``np.random.default_rng`` in the JAX package's order,
so one seed gives the JAX network's weights bit for bit.
"""
from __future__ import annotations

import copy
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import Tensor, nn

from .activations import apply_activation, parse_activation
from .latent import LatentSpace
from .srn import InputParametrization, Layer, apply_output
from .variants import _conditioning, latent_vector


def _inner_param_count(shapes: Sequence[tuple[int, int]]) -> int:
    return sum(o * i + o for o, i in shapes)


class MetaSceneNetwork(nn.Module):
    """SRN whose inner weights come from a meta MLP over the latent."""
    use_direction = False

    def __init__(self, input: InputParametrization,
                 meta_layers: Sequence[Layer], latent: LatentSpace,
                 inner_shapes: Sequence[tuple[int, int]] = (),
                 inner_activation: str = "SnakeAlt",
                 inner_act_param: float = 1.0,
                 output_mode: str = "density"):
        super().__init__()
        self.input = input
        self.meta_layers = nn.ModuleList(meta_layers)
        self.latent = latent
        self.inner_shapes = tuple((int(o), int(i)) for o, i in inner_shapes)
        self.inner_activation = inner_activation
        self.inner_act_param = float(inner_act_param)
        self.output_mode = output_mode

    @classmethod
    def make(cls, *, layers: str = "32:32", activation: str = "SnakeAlt:2",
             meta_layers: str = "64:64", meta_activation: str = "ReLU",
             output_mode: str = "density", num_fourier: int = 8,
             fourier_std: float = 1.0, latent: Optional[LatentSpace] = None,
             seed: int = 42) -> "MetaSceneNetwork":
        latent = latent if latent is not None else LatentSpace()
        z_dim = latent.total_channels
        if z_dim == 0:
            raise ValueError("meta network needs latent conditioning")
        inp = InputParametrization.make(
            num_fourier=num_fourier, fourier_std=fourier_std, seed=seed)
        act_name, act_param = parse_activation(activation)
        sizes = [int(s) for s in layers.split(":")]
        out_channels = 1 if output_mode.startswith("density") else 4
        shapes, last = [], inp.num_output_channels()
        for s in sizes:
            shapes.append((s, last))
            last = s
        shapes.append((out_channels, last))
        n_params = _inner_param_count(shapes)

        meta_act, meta_p = parse_activation(meta_activation)
        rng = np.random.default_rng(seed + 7)
        mlayers, mlast = [], z_dim
        for s in (int(v) for v in meta_layers.split(":")):
            bound = 1.0 / math.sqrt(mlast)
            w = rng.uniform(-bound, bound, (s, mlast)).astype(np.float32)
            b = rng.uniform(-bound, bound, (s,)).astype(np.float32)
            mlayers.append(Layer(torch.from_numpy(w), torch.from_numpy(b),
                                 activation=meta_act,
                                 activation_param=meta_p))
            mlast = s
        # the last meta layer: a small weight, and a bias that predicts
        # torch-Linear-scale inner weights
        w = (rng.standard_normal((n_params, mlast))
             * (0.01 / math.sqrt(mlast))).astype(np.float32)
        b = np.concatenate([
            rng.uniform(-1.0 / math.sqrt(i), 1.0 / math.sqrt(i),
                        (o * i + o,)).astype(np.float32)
            for o, i in shapes])
        mlayers.append(Layer(torch.from_numpy(w), torch.from_numpy(b),
                             activation="None"))
        return cls(inp, mlayers, latent, inner_shapes=shapes,
                   inner_activation=act_name, inner_act_param=act_param,
                   output_mode=output_mode)

    def predict_parameters(self, z: Tensor) -> Tensor:
        """z (Z,) -> the flat inner parameter vector; z (B, Z) -> (B, P)."""
        h = z[None, :] if z.dim() == 1 else z
        for layer in self.meta_layers:
            h = layer(h)
        return h[0] if z.dim() == 1 else h

    def _unpack(self, params: Tensor):
        """[(weight (out, in), bias (out,)), ...] of the inner layers."""
        out, off = [], 0
        for o, i in self.inner_shapes:
            w = params[off:off + o * i].reshape(o, i)
            off += o * i
            out.append((w, params[off:off + o]))
            off += o
        return out

    def forward(self, x: Tensor, tf=None, time: Optional[Tensor] = None,
                ensemble: Optional[Tensor] = None,
                mode: str = "screen") -> Tensor:
        t, e = _conditioning(x, time, ensemble)
        params = self.predict_parameters(latent_vector(self.latent, t, e))
        y = self.input(x)
        last = len(self.inner_shapes) - 1
        for k, (w, b) in enumerate(self._unpack(params)):
            y = y @ w.T + b
            if k < last:
                y = apply_activation(self.inner_activation, y,
                                     self.inner_act_param)
        return apply_output(self.output_mode, y, mode)


def fit_meta_to_parameters(net: MetaSceneNetwork, z_samples: Tensor,
                           target_params: Tensor, *, steps: int = 200,
                           lr: float = 1e-3) -> MetaSceneNetwork:
    """Phase-2 pretraining: a copy of ``net`` whose meta MLP is fitted by
    Adam (optax's update, a constant rate) to predict ``target_params``
    (P,) for every training latent of ``z_samples`` (B, Z), on the mean
    squared error. ``net`` is left as it is."""
    from ..train.optimizer import make_optimizer
    fitted = copy.deepcopy(net)
    params = list(fitted.meta_layers.parameters())
    opt, sched = make_optimizer(params, "Adam", lr=lr, lr_gamma=1.0)
    target = target_params[None, :]
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((fitted.predict_parameters(z_samples) - target)
                          ** 2)
        loss.backward()
        opt.step()
        sched.step()
    return fitted
