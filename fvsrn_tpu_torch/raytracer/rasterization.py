"""Rasterization pre-pass: particles and streamlines drawn before the rays.

Counterpart of ``fvsrn_tpu/raytracer/rasterization.py``, plain PyTorch as
the JAX module is plain JAX (no TPU kernel): opaque geometry is splatted
into an rgba + depth image first, and the ray march stops at its depth
(``raytracer.evaluator.render_image(background=)``). Particles are traced
through a velocity field (Euler or RK4) and every trajectory point is
drawn as a depth-buffered square splat.

The z-buffer: a point's splat covers the pixels within ``point_radius -
1`` of its rounded position; each pixel keeps the least depth of the
points over it, and the points within 1e-6 of that depth write their
color, offset by offset in the JAX module's order, the last point (by
index) of an offset winning an exact tie, as JAX's scatter leaves it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import Tensor

from ..camera import CameraOnASphere, camera_matrix

FAR = 1e10


@dataclasses.dataclass(frozen=True)
class ParticleIntegration:
    """Particles seeded at ``seeds`` (P, 3), advected ``steps`` times by
    ``dt`` through a velocity field and drawn in ``color`` (rgba)."""
    seeds: Tensor
    color: Tensor
    steps: int = 32
    dt: float = 0.01
    method: str = "rk4"         # "euler" or "rk4"
    point_radius: int = 1

    @classmethod
    def make(cls, seeds, color=(1.0, 1.0, 1.0, 1.0), steps=32, dt=0.01,
             method="rk4", point_radius=1) -> "ParticleIntegration":
        return cls(seeds=torch.as_tensor(seeds, dtype=torch.float32),
                   color=torch.as_tensor(color, dtype=torch.float32),
                   steps=steps, dt=dt, method=method,
                   point_radius=point_radius)

    def trace(self, velocity_fn: Callable[[Tensor], Tensor]) -> Tensor:
        """Streamlines (P, steps + 1, 3), the seeds first;
        ``velocity_fn(pos (N, 3)) -> (N, 3)`` world-space velocities."""
        dt = self.dt
        pos = self.seeds.to(torch.float32)
        traj = [pos]
        for _ in range(self.steps):
            if self.method == "euler":
                pos = pos + dt * velocity_fn(pos)
            else:
                k1 = velocity_fn(pos)
                k2 = velocity_fn(pos + 0.5 * dt * k1)
                k3 = velocity_fn(pos + 0.5 * dt * k2)
                k4 = velocity_fn(pos + dt * k3)
                pos = pos + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            traj.append(pos)
        return torch.stack(traj, dim=1)


def project_points(points: Tensor, camera: CameraOnASphere, width: int,
                   height: int):
    """World points (N, 3) -> (pixel x, pixel y, depth) under the
    camera's reference frame, the inverse of ray generation."""
    m = camera_matrix(camera)[0].to(points.device)
    eye, right, up = m[0], m[1], m[2]
    front = torch.linalg.cross(up, right)
    rel = points - eye
    depth = rel @ front
    tan_y = math.tan(camera.fov_y_radians / 2)
    tan_x = tan_y * width / height
    ndc_x = (rel @ right) / (depth * tan_x)
    ndc_y = (rel @ up) / (depth * tan_y)
    px = (ndc_x + 1) * width / 2 - 0.5
    py = (ndc_y + 1) * height / 2 - 0.5
    return px, py, depth


def rasterize_points(points: Tensor, colors: Tensor,
                     camera: CameraOnASphere, width: int, height: int,
                     point_radius: int = 1) -> Tensor:
    """Depth-buffered point splatting of ``points`` (N, 3) in ``colors``
    (N, 4): a (1, 5, H, W) rgba + depth image (depth 0 where no point
    lands), the nearest point winning (see the module doc)."""
    px, py, depth = project_points(points, camera, width, height)
    dev = points.device
    valid = depth > 1e-4
    ix = torch.round(px).to(torch.int64)
    iy = torch.round(py).to(torch.int64)
    n_pix = height * width
    offsets = range(-point_radius + 1, point_radius)

    def covered(dx, dy):
        x, y = ix + dx, iy + dy
        ok = valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)
        return ok, torch.where(ok, y * width + x, torch.zeros_like(x))

    flat_depth = torch.full((n_pix,), FAR, dtype=torch.float32, device=dev)
    for dy in offsets:
        for dx in offsets:
            ok, idx = covered(dx, dy)
            flat_depth.scatter_reduce_(0, idx[ok], depth[ok], reduce="amin")
    flat_rgba = torch.zeros((n_pix, 4), dtype=torch.float32, device=dev)
    point_id = torch.arange(points.shape[0], device=dev)
    for dy in offsets:
        for dx in offsets:
            ok, idx = covered(dx, dy)
            won = ok & (depth <= flat_depth[idx] + 1e-6)
            # each pixel takes its last winning point: an exact tie
            # resolves as JAX's scatter does, and on any device alike
            last = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
            last.scatter_reduce_(0, idx[won], point_id[won], reduce="amax")
            hit = last >= 0
            flat_rgba[hit] = colors[last[hit]].to(torch.float32)
    depth_img = torch.where(flat_depth >= FAR, torch.zeros_like(flat_depth),
                            flat_depth)
    img = torch.cat([flat_rgba, depth_img[:, None]], dim=1)
    return img.reshape(height, width, 5).permute(2, 0, 1)[None]


def rasterize_particles(particles: ParticleIntegration,
                        velocity_fn: Callable[[Tensor], Tensor],
                        camera: CameraOnASphere, width: int,
                        height: int) -> Tensor:
    """Trace the streamlines and splat every trajectory point: a (1, 5,
    H, W) background for ``render_image``."""
    pts = particles.trace(velocity_fn).reshape(-1, 3)
    colors = particles.color.to(pts.device).expand(pts.shape[0], 4)
    return rasterize_points(pts, colors, camera, width, height,
                            particles.point_radius)
