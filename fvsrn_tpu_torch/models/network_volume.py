"""An SRN seen as a volume.

Counterpart of ``fvsrn_tpu/models/network_volume.py``: wraps a
``SceneRepresentationNetwork`` behind the volume contract
(``eval_density``, ``eval_normal`` plus the box) so the plain ray
marchers can sample it. ``gradient_mode`` picks the normal: "adjoint"
differentiates the density with autograd, "fd" takes forward
differences of ``fd_step``, as the JAX package does. ``time`` and
``ensemble`` are the scalar conditioning every sample of the volume gets.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor, nn

from .srn import SceneRepresentationNetwork


class VolumeInterpolationNetwork(nn.Module):
    def __init__(self, network: SceneRepresentationNetwork,
                 box_min=(-0.5, -0.5, -0.5), box_size=(1.0, 1.0, 1.0),
                 time: float = 0.0, ensemble: float = 0.0,
                 gradient_mode: str = "adjoint", fd_step: float = 1e-3):
        super().__init__()
        if gradient_mode not in ("adjoint", "fd"):
            raise ValueError(f"unknown gradient mode {gradient_mode}")
        self.network = network
        self.gradient_mode = gradient_mode
        self.fd_step = float(fd_step)
        self.time = float(np.float32(time))
        self.ensemble = float(np.float32(ensemble))
        dev = next(network.parameters()).device
        self.register_buffer("box_min", torch.as_tensor(
            box_min, dtype=torch.float32, device=dev))
        self.register_buffer("box_size", torch.as_tensor(
            box_size, dtype=torch.float32, device=dev))

    @property
    def outputs_color(self) -> bool:
        """True for rgbo networks, whose output skips the TF."""
        return not self.network.output_mode.startswith("density")

    def eval_density(self, position: Tensor,
                     direction: Optional[Tensor] = None, b: int = 0):
        """World position (..., 3) -> (value, is_inside). Density
        networks give value (...,), rgbo networks (..., 4). A network has
        no batch; ``b`` is taken and not read, as in the JAX package."""
        lead = position.shape[:-1]
        pos01 = (position - self.box_min) / self.box_size
        inside = (pos01 >= 0).all(dim=-1) & (pos01 <= 1).all(dim=-1)
        x = pos01.reshape(-1, 3)
        if self.network.use_direction:
            d = (torch.zeros_like(position) if direction is None
                 else direction.expand(position.shape))
            x = torch.cat([x, d.reshape(-1, 3)], dim=1)
        n = x.shape[0]
        out = self.network(
            x, None, torch.full((n,), self.time, dtype=x.dtype,
                                device=x.device),
            torch.full((n,), self.ensemble, dtype=x.dtype, device=x.device),
            mode="screen")
        if self.outputs_color:
            return out.reshape(lead + (4,)), inside
        return out.reshape(lead), inside

    def eval_normal(self, position: Tensor,
                    direction: Optional[Tensor] = None, b: int = 0) -> Tensor:
        """Gradient of the density with respect to the world position,
        (..., 3); no graph is kept."""
        if self.outputs_color:
            raise ValueError("normals are only defined for density networks")
        if self.gradient_mode == "fd":
            h = self.fd_step
            offs = torch.eye(3, dtype=position.dtype,
                             device=position.device) * h
            d0 = self.eval_density(position, direction)[0]
            return torch.stack(
                [(self.eval_density(position + offs[i], direction)[0] - d0)
                 / h for i in range(3)], dim=-1).detach()
        with torch.enable_grad():
            p = position.detach().requires_grad_(True)
            value = self.eval_density(p, direction)[0]
            (grad,) = torch.autograd.grad(value.sum(), p)
        return grad
