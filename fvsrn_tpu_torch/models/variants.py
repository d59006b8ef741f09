"""SRN architecture variants: ResidualSine and ModulatedSine.

Counterpart of ``fvsrn_tpu/models/variants.py``:

- ``ResidualSineNetwork``: a first linear layer and Sine(w0), residual
  sine blocks sin(w0 W x) with 0.5 averaging on designated blocks and
  SIREN-style initialization, a linear output;
- ``ModulatedSineNetwork``: a synthesizer branch with sine activations
  (no ``w0`` factor) whose hidden states are gated by a ReLU modulator
  branch driven by the latent code, which the modulator re-ingests at
  every layer.

Both take the SRN's call signature ``(x, tf=None, time=None,
ensemble=None, mode=...)``, so ``VolumeInterpolationNetwork`` and the
plain marches (``trace_dvr``, ``LoadedModel``'s PLAIN32) drive them; the
fused kernels take the SRN only and refuse them
(``ops.fused_dvr.require_srn``). ``make`` draws from
``np.random.default_rng`` in the JAX package's order, so one seed gives
the JAX network's weights bit for bit; ``convert.py`` carries a JAX
network's arrays across.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import Tensor, nn

from .latent import LatentSpace, interp1d
from .srn import InputParametrization, apply_output


def _p(a) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)))


class _Affine(nn.Module):
    """y = x W^T + b, weight (out, in)."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = _p(weight)
        self.bias = _p(bias)

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.weight.T + self.bias


class _SineBlock(nn.Module):
    """A residual block's two sine layers (w1, b1, w2, b2)."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = _p(w1), _p(b1), _p(w2), _p(b2)


def _conditioning(x: Tensor, time, ensemble):
    """The batch's scalar time and ensemble (its first entries; zeros when
    not given)."""
    t = x.new_zeros(()) if time is None else torch.reshape(time, (-1,))[0]
    e = x.new_zeros(()) if ensemble is None \
        else torch.reshape(ensemble, (-1,))[0]
    return t, e


def latent_vector(latent: LatentSpace, time: Tensor,
                  ensemble: Tensor) -> Tensor:
    """The uniform-batch latent code at scalar (time, ensemble): the
    ensemble vector, then the time vector, each interpolated over its
    keyframes."""
    parts = []
    for vec, at in ((latent.ensemble_vector, ensemble),
                    (latent.time_vector, time)):
        if vec is not None:
            parts.append(interp1d(vec, at.reshape(1, 1))[0, :, 0])
    return torch.cat(parts)


class ResidualSineNetwork(nn.Module):
    """first linear + Sine(w0), then residual sine blocks, linear out."""
    use_direction = False

    def __init__(self, input: InputParametrization, first_w, first_b,
                 blocks: Sequence, out_w, out_b,
                 block_weights: Sequence = (), omega0: float = 30.0,
                 output_mode: str = "density"):
        super().__init__()
        self.input = input
        self.first = _Affine(first_w, first_b)
        self.blocks = nn.ModuleList(_SineBlock(*b) for b in blocks)
        self.out = _Affine(out_w, out_b)
        self.block_weights = tuple(tuple(float(a) for a in w)
                                   for w in block_weights)
        self.omega0 = float(omega0)
        self.output_mode = output_mode

    @classmethod
    def make(cls, *, hidden: int = 32, num_blocks: int = 3,
             num_fourier: int = 0, output_mode: str = "density",
             omega0: float = 30.0, seed: int = 42) -> "ResidualSineNetwork":
        rng = np.random.default_rng(seed)
        inp = InputParametrization.make(num_fourier=num_fourier, seed=seed)
        in_ch = inp.num_output_channels()
        out_ch = 1 if output_mode.startswith("density") else 4
        # SIREN first-layer init
        fw = rng.uniform(-1.0 / in_ch, 1.0 / in_ch,
                         (hidden, in_ch)).astype(np.float32)
        fb = np.zeros(hidden, np.float32)
        bound = math.sqrt(6 / hidden) / omega0
        blocks, weights = [], []
        for i in range(num_blocks):
            w1 = rng.uniform(-bound, bound,
                             (hidden, hidden)).astype(np.float32)
            w2 = rng.uniform(-bound, bound,
                             (hidden, hidden)).astype(np.float32)
            blocks.append((w1, np.zeros(hidden, np.float32),
                           w2, np.zeros(hidden, np.float32)))
            # the first block's input unaveraged, the second-to-last
            # block's output averaged
            weights.append((0.5 if i > 0 else 1.0,
                            0.5 if i == num_blocks - 2 else 1.0))
        ow = rng.uniform(-bound, bound, (out_ch, hidden)).astype(np.float32)
        ob = np.zeros(out_ch, np.float32)
        return cls(inp, fw, fb, blocks, ow, ob, block_weights=weights,
                   omega0=omega0, output_mode=output_mode)

    def forward(self, x: Tensor, tf=None, time: Optional[Tensor] = None,
                ensemble: Optional[Tensor] = None,
                mode: str = "screen") -> Tensor:
        y = self.input(x)
        w0 = self.omega0
        h = torch.sin(w0 * self.first(y))
        for blk, (a1, a2) in zip(self.blocks, self.block_weights):
            s1 = torch.sin(w0 * ((a1 * h) @ blk.w1.T + blk.b1))
            s2 = torch.sin(w0 * (s1 @ blk.w2.T + blk.b2))
            h = a2 * (h + s2)
        return apply_output(self.output_mode, self.out(h), mode)


class ModulatedSineNetwork(nn.Module):
    """Synthesizer (sine) gated by a latent-driven modulator (ReLU)."""
    use_direction = False

    def __init__(self, input: InputParametrization, latent: LatentSpace,
                 syn_layers: Sequence, mod_layers: Sequence, out_w, out_b,
                 w0: float = 30.0, output_mode: str = "density"):
        super().__init__()
        self.input = input
        self.latent = latent
        self.syn_layers = nn.ModuleList(_Affine(*p) for p in syn_layers)
        self.mod_layers = nn.ModuleList(_Affine(*p) for p in mod_layers)
        self.out = _Affine(out_w, out_b)
        self.w0 = float(w0)
        self.output_mode = output_mode

    @classmethod
    def make(cls, *, hidden: int = 32, num_layers: int = 3,
             num_fourier: int = 0, latent: Optional[LatentSpace] = None,
             w0: float = 30.0, output_mode: str = "density",
             seed: int = 42) -> "ModulatedSineNetwork":
        latent = latent if latent is not None else LatentSpace()
        z_dim = latent.total_channels
        if z_dim == 0:
            raise ValueError("ModulatedSine needs a latent code")
        rng = np.random.default_rng(seed)
        inp = InputParametrization.make(num_fourier=num_fourier, seed=seed)
        in_ch = inp.num_output_channels()
        out_ch = 1 if output_mode.startswith("density") else 4
        # half-width layers, so that the parameter count matches the plain
        # network's
        h = hidden // 2
        syn, mod = [], []
        last_i, last_m = in_ch, z_dim
        for _ in range(num_layers):
            bi = 1.0 / math.sqrt(last_i)
            syn.append((rng.uniform(-bi, bi, (h, last_i)).astype(np.float32),
                        rng.uniform(-bi, bi, (h,)).astype(np.float32)))
            bm = 1.0 / math.sqrt(last_m)
            mod.append((rng.uniform(-bm, bm, (h, last_m)).astype(np.float32),
                        rng.uniform(-bm, bm, (h,)).astype(np.float32)))
            last_i = h
            last_m = h + z_dim   # the modulator re-ingests the latent
        bo = 1.0 / math.sqrt(h)
        ow = rng.uniform(-bo, bo, (out_ch, h)).astype(np.float32)
        ob = rng.uniform(-bo, bo, (out_ch,)).astype(np.float32)
        return cls(inp, latent, syn, mod, ow, ob, w0=w0,
                   output_mode=output_mode)

    def forward(self, x: Tensor, tf=None, time: Optional[Tensor] = None,
                ensemble: Optional[Tensor] = None,
                mode: str = "screen") -> Tensor:
        n = x.shape[0]
        t, e = _conditioning(x, time, ensemble)
        z = latent_vector(self.latent, t, e)
        z = z[None, :].expand(n, z.shape[0])
        i = self.input(x)
        hz = z
        for syn, mod in zip(self.syn_layers, self.mod_layers):
            new_h = torch.relu(mod(hz))
            # sin without the w0 factor, as the reference's ModulatedSine
            i = new_h * torch.sin(syn(i))
            hz = torch.cat([new_h, z], dim=1)
        return apply_output(self.output_mode, self.out(i), mode)
