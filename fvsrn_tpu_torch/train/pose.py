"""Camera pose recovery through the renderer.

Counterpart of ``fvsrn_tpu/train/pose.py``: given an image of the scene
from an unknown orbit pose, recover pitch, yaw and distance by
Levenberg-Marquardt on a finite-difference Jacobian of forward renders
(no backward pass, so any renderer serves: the plain march, the fused
per-segment engine, the megakernel's render, TPU kernel row 1). The JAX
package's measurements chose this recipe: first-order optimizers diverge
on this nonlinear least-squares problem, whose parameters differ in
observability by more than 10x, while damped Gauss-Newton normalizes
each direction's curvature; and a FIXED supersampling jitter smooths
the loss, which pixel-centre sampling aliases.

- :func:`make_pose_render`: ``render(pyd) -> image`` from a rays-to-image
  function, with the fixed jitter drawn as JAX's ``random.uniform``
  (``utils.prng``, bit for bit) from ``jitter_key``;
- :func:`recover_pose`: the host's LM loop in float64 (residuals, normal
  equations, damping), accepting a step only when the cost falls.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..camera import CameraOnASphere, camera_matrix, generate_rays
from ..utils import prng


class PoseResult(NamedTuple):
    """Outcome of :func:`recover_pose`."""
    pyd: np.ndarray            # (3,) recovered pitch/yaw/distance, float32
    cost: float                # final mean-squared residual
    cost0: float               # initial mean-squared residual
    costs: list                # accepted cost per iteration
    iterations: int


def make_pose_render(render_rays: Callable, width: int, height: int, *,
                     fov_y_radians: float, center=(0.0, 0.0, 0.0),
                     orientation: str = "Ym", supersample: int = 4,
                     jitter_key: int = 7, device="cpu") -> Callable:
    """``render(pyd) -> (H*W, C) image`` from ``render_rays(ray_start (R,
    3), ray_dir (R, 3)) -> (R, C)`` on ``device``: ``supersample`` fixed
    jittered sub-pixel samples a pixel, averaged. The jitter is JAX's
    ``uniform(PRNGKey(jitter_key), (S, H, W, 2))``, fixed so that the
    target and every render of the optimization share one estimator (the
    loss is exactly 0 at the true pose). ``pyd`` is anything
    ``torch.as_tensor`` takes, rounded to float32."""
    dev = torch.device(device)
    jitter = None
    if supersample > 1:
        jitter = prng.uniform(prng.prng_key(jitter_key),
                              (supersample, height, width, 2), device=dev)
    center_t = torch.tensor(center, dtype=torch.float32, device=dev)

    def render(pyd):
        cam = CameraOnASphere(
            center=center_t,
            pitch_yaw_distance=torch.as_tensor(
                np.asarray(pyd, np.float32)).to(dev),
            orientation=orientation, fov_y_radians=fov_y_radians)
        s, d = generate_rays(camera_matrix(cam), width, height,
                             fov_y_radians=fov_y_radians, jitter=jitter)
        out = render_rays(s.reshape(-1, 3).contiguous(),
                          d.reshape(-1, 3).contiguous())
        if supersample > 1:
            out = out.reshape(supersample, height * width, -1).mean(dim=0)
        return out

    return render


def recover_pose(render: Callable, target, pyd0, *, iterations: int = 12,
                 fd_eps: float = 2e-3, lam0: float = 1e-2,
                 lam_min: float = 1e-7, lam_max: float = 1e8,
                 fd_mode: str = "central",
                 callback: Optional[Callable] = None) -> PoseResult:
    """Levenberg-Marquardt refinement of pitch/yaw/distance.

    ``render(pyd (3,) float32) -> image`` (any shape; flattened to
    residuals), ``target`` the image from the unknown pose. The Jacobian
    comes from forward renders: 6 an iteration with ``fd_mode="central"``,
    3 with ``"forward"`` (reusing the accepted residual). Each step solves
    ``(J^T J + lam diag(J^T J)) delta = -J^T r`` in float64, lambda
    divided by 3 on an accepted step and multiplied by 10 on a refused
    one (up to 10 tries an iteration); the cost never rises. Stops early
    when no try is accepted. ``callback(it, pyd, cost, lam)`` after each
    iteration."""
    tgt = np.asarray(torch.as_tensor(target).detach().cpu(),
                     np.float64).reshape(-1)
    scale = 1.0 / np.sqrt(tgt.size)

    def resid(p):
        img = render(np.asarray(p, np.float32))
        return (np.asarray(img.detach().cpu(), np.float64).reshape(-1)
                - tgt) * scale

    p = np.asarray(pyd0, np.float64).copy()
    lam = float(lam0)
    r = resid(p)
    cost = float(r @ r)
    cost0 = cost
    costs = [cost]
    for it in range(iterations):
        cols = []
        for i in range(3):
            pp = p.copy()
            pp[i] += fd_eps
            if fd_mode == "forward":
                cols.append((resid(pp) - r) / fd_eps)
            else:
                pm = p.copy()
                pm[i] -= fd_eps
                cols.append((resid(pp) - resid(pm)) / (2 * fd_eps))
        jac = np.stack(cols, axis=1)                       # (N, 3)
        g = jac.T @ r
        h = jac.T @ jac
        accepted = False
        for _ in range(10):
            delta = np.linalg.solve(
                h + lam * np.diag(np.diag(h)) + 1e-12 * np.eye(3), -g)
            p_new = p + delta
            r_new = resid(p_new)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                p, r, cost = p_new, r_new, c_new
                lam = max(lam / 3.0, lam_min)
                accepted = True
                break
            lam = min(lam * 10.0, lam_max)
        costs.append(cost)
        if callback is not None:
            callback(it, p, cost, lam)
        if not accepted:
            break
    return PoseResult(pyd=np.asarray(p, np.float32), cost=cost,
                      cost0=cost0, costs=costs, iterations=len(costs) - 1)
