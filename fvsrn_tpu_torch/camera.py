"""Orbit camera and ray generation.

Counterpart of ``fvsrn_tpu/camera.py``: ``CameraOnASphere`` (pitch, yaw
and distance around a center), its (B, 3, 3) reference frame [origin;
right; up] and one ray per pixel center, returned channel-last as
(B, H, W, 3) like the JAX package. A camera may be batched (B, 3);
``fibonacci_sphere_cameras`` builds the screen-space training cameras.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
from torch import Tensor

from .utils.vecmath import normalize

_ORIENTATION_UP = {
    "Xp": (1, 0, 0), "Xm": (-1, 0, 0),
    "Yp": (0, 1, 0), "Ym": (0, -1, 0),
    "Zp": (0, 0, 1), "Zm": (0, 0, -1),
}
_ORIENTATION_PERMUTATION = {
    "Xp": (2, -1, -3), "Xm": (-2, 1, 3),
    "Yp": (1, 2, 3), "Ym": (-1, -2, -3),
    "Zp": (-3, -1, 2), "Zm": (3, 1, -2),
}
_ORIENTATION_INVERT_YAW = {
    "Xp": False, "Xm": True, "Yp": True, "Ym": False, "Zp": True, "Zm": False,
}


def euler_to_cartesian(pitch: Tensor, yaw: Tensor, distance: Tensor,
                       orientation: str = "Ym") -> Tensor:
    """Spherical coordinates -> offset from the look-at center, (..., 3)."""
    yaw = yaw if _ORIENTATION_INVERT_YAW[orientation] else -yaw
    pitch = -pitch
    pos = torch.stack([
        torch.cos(pitch) * torch.cos(yaw) * distance,
        torch.sin(pitch) * distance,
        torch.cos(pitch) * torch.sin(yaw) * distance,
    ], dim=-1)
    perm = _ORIENTATION_PERMUTATION[orientation]
    idx = [abs(p) - 1 for p in perm]
    sign = torch.tensor([1.0 if p > 0 else -1.0 for p in perm],
                        dtype=pos.dtype, device=pos.device)
    return pos[..., idx] * sign


@dataclass(frozen=True)
class CameraOnASphere:
    """Orbit camera around ``center``, facing inward. ``center`` and
    ``pitch_yaw_distance`` are (3,) or batched (B, 3) float32 tensors."""
    center: Tensor
    pitch_yaw_distance: Tensor
    orientation: str = "Ym"
    fov_y_radians: float = math.radians(45.0)

    @classmethod
    def make(cls, center=(0.0, 0.0, 0.0), pitch=0.0, yaw=0.0, distance=1.0,
             orientation: str = "Ym",
             fov_y_radians: float = math.radians(45.0)) -> "CameraOnASphere":
        return cls(
            center=torch.tensor(center, dtype=torch.float32),
            pitch_yaw_distance=torch.tensor([pitch, yaw, distance],
                                            dtype=torch.float32),
            orientation=orientation, fov_y_radians=fov_y_radians)

    @property
    def batch(self) -> int:
        """The larger of ``center``'s and ``pitch_yaw_distance``'s batch
        (1 for unbatched fields)."""
        b = 1
        for field in (self.center, self.pitch_yaw_distance):
            if field.ndim == 2:
                b = max(b, field.shape[0])
        return b

    def get_parameters(self) -> Tensor:
        """(B, 3, 3) reference frame: rows eye, right, up."""
        return camera_matrix(self)

    def get_origin(self) -> Tensor:
        pyd = torch.atleast_2d(self.pitch_yaw_distance)
        return euler_to_cartesian(pyd[..., 0], pyd[..., 1], pyd[..., 2],
                                  self.orientation) \
            + torch.atleast_2d(self.center)

    def get_front(self) -> Tensor:
        return normalize(torch.atleast_2d(self.center) - self.get_origin())


def camera_matrix(cam: CameraOnASphere) -> Tensor:
    """(B, 3, 3) reference frame [origin; right; up]: front =
    normalize(center - origin), right = normalize(front x up),
    up2 = normalize(right x front)."""
    center = torch.atleast_2d(cam.center)
    pyd = torch.atleast_2d(cam.pitch_yaw_distance)
    origin = euler_to_cartesian(pyd[..., 0], pyd[..., 1], pyd[..., 2],
                                cam.orientation) + center
    up = torch.tensor(_ORIENTATION_UP[cam.orientation], dtype=center.dtype,
                      device=center.device).expand(origin.shape)
    front = normalize(center - origin)
    right = normalize(torch.linalg.cross(front, up))
    up2 = normalize(torch.linalg.cross(right, front))
    return torch.stack([origin, right, up2], dim=-2)


def generate_rays(matrix_or_camera: Union[Tensor, CameraOnASphere],
                  width: int, height: int,
                  fov_y_radians: Optional[float] = None, *,
                  jitter: Optional[Tensor] = None, device=None,
                  dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """One ray per pixel center: ndc = 2*(pix+0.5)/size - 1 and
    dir = normalize(front + ndc.x*tan(fovX/2)*right + ndc.y*tan(fovY/2)*up)
    with front = up x right. ``jitter``: an optional (S, H, W, 2) offset in
    [0, 1) inside each pixel for multisampling, ndc = 2*(pix+jitter)/size
    - 1, the S samples in the batch axis (an unbatched camera only).
    ``device`` defaults to the matrix's. Returns (ray_start, ray_dir),
    each (B, H, W, 3)."""
    if isinstance(matrix_or_camera, CameraOnASphere):
        if fov_y_radians is None:
            fov_y_radians = matrix_or_camera.fov_y_radians
        matrix = camera_matrix(matrix_or_camera)
    else:
        matrix = matrix_or_camera
        if fov_y_radians is None:
            raise ValueError("fov_y_radians required with an explicit matrix")
    matrix = matrix.to(device=device if device is not None
                       else matrix.device, dtype=dtype)
    if matrix.ndim == 2:
        matrix = matrix[None]
    tan_fov_y = math.tan(fov_y_radians / 2)
    tan_fov_x = tan_fov_y * (width / height)

    eye = matrix[:, None, None, 0, :]
    right = matrix[:, None, None, 1, :]
    up = matrix[:, None, None, 2, :]
    front = torch.linalg.cross(up, right)
    x = torch.arange(width, dtype=dtype, device=matrix.device)
    y = torch.arange(height, dtype=dtype, device=matrix.device)
    if jitter is None:
        ndc_x = (2 * (x + 0.5) / width - 1)[None, None, :].expand(
            1, height, width)
        ndc_y = (2 * (y + 0.5) / height - 1)[None, :, None].expand(
            1, height, width)
    else:
        if matrix.shape[0] != 1:
            raise ValueError("multisampling requires an unbatched camera "
                             "(samples occupy the batch axis)")
        jitter = jitter.to(device=matrix.device, dtype=dtype)
        ndc_x = 2 * (x[None, None, :] + jitter[..., 0]) / width - 1
        ndc_y = 2 * (y[None, :, None] + jitter[..., 1]) / height - 1
    direction = normalize(front + ndc_x[..., None] * (tan_fov_x * right)
                          + ndc_y[..., None] * (tan_fov_y * up))
    batch = max(matrix.shape[0], ndc_x.shape[0])
    ray_start = eye.expand(batch, height, width, 3)
    ray_dir = direction.expand(batch, height, width, 3)
    return ray_start, ray_dir


def fibonacci_sphere_cameras(n: int, center=(0.0, 0.0, 0.0), distance=1.0,
                             orientation="Ym",
                             fov_y_radians=math.radians(45.0),
                             pitch_range=(-80.0, 80.0)) -> CameraOnASphere:
    """``n`` batched cameras on a fibonacci spiral around the object, the
    screen-space training distribution. Angles are computed in float64
    with numpy, then stored as float32, as in the JAX package."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)          # polar angle in [0, pi]
    golden = np.pi * (1 + 5 ** 0.5)
    theta = np.mod(golden * i, 2 * np.pi)   # azimuth
    pitch = np.clip(np.pi / 2 - phi, math.radians(pitch_range[0]),
                    math.radians(pitch_range[1]))
    pyd = np.stack([pitch, theta, np.full(n, distance)], axis=-1)
    return CameraOnASphere(
        center=torch.tensor(np.broadcast_to(
            np.asarray(center, np.float32), (n, 3)).copy()),
        pitch_yaw_distance=torch.tensor(np.asarray(pyd, np.float32)),
        orientation=orientation, fov_y_radians=fov_y_radians)
