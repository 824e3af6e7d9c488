"""Camera ray generation (host-side numpy), as ``nerf_tpu.data.rays``:
camera-space direction ``(u - W/2, -(v - H/2), -focal)`` with no half-pixel
offset, rotated by ``c2w[:3,:3]`` and normalised; origin ``c2w[:3,3]``.
"""

from __future__ import annotations

import numpy as np


def compute_rays(
    images: np.ndarray, c2w_matrices: np.ndarray, focal_length: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rays + target pixels for a stack of images.

    Args:
      images: (N, H, W, 3) float32 RGB in [0,1].
      c2w_matrices: (N, 4, 4) camera-to-world transforms.
      focal_length: focal in pixels.

    Returns (rays_o, rays_d, target_pixels), each (N, H*W, 3) float32;
    directions are unit length.
    """
    n, h, w, _ = images.shape
    target_pixels = images.reshape(n, -1, 3).astype(np.float32)

    dirs_cam = _camera_dirs(h, w, focal_length)                 # (H, W, 3)
    rot = c2w_matrices[:, :3, :3].astype(np.float32)
    rays_d = np.einsum("nij,hwj->nhwi", rot, dirs_cam)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)

    origins = c2w_matrices[:, :3, 3].astype(np.float32)          # (N, 3)
    rays_o = np.broadcast_to(origins[:, None, :], (n, h * w, 3)).copy()
    return rays_o, rays_d.reshape(n, -1, 3).astype(np.float32), target_pixels


def compute_rays_single(
    h: int, w: int, focal_length: float, c2w: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Rays for one pose without needing pixel data (eval path).

    Returns (rays_o, rays_d), each (H*W, 3) float32.
    """
    dirs_cam = _camera_dirs(h, w, focal_length)
    rot = np.asarray(c2w, dtype=np.float32)[:3, :3]
    rays_d = dirs_cam @ rot.T
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    origin = np.asarray(c2w, dtype=np.float32)[:3, 3]
    rays_o = np.broadcast_to(origin, (h * w, 3)).copy()
    return rays_o, rays_d.reshape(-1, 3).astype(np.float32)


def _camera_dirs(h: int, w: int, focal_length: float) -> np.ndarray:
    """Camera-space pixel directions (H, W, 3): (u - W/2, -(v - H/2), -f),
    no half-pixel offset."""
    u = np.arange(w, dtype=np.float32)
    v = np.arange(h, dtype=np.float32)
    u_grid, v_grid = np.meshgrid(u, v, indexing="xy")
    x = u_grid - 0.5 * w
    y = -(v_grid - 0.5 * h)
    z = -np.full_like(x, np.float32(focal_length))
    return np.stack([x, y, z], axis=-1)
