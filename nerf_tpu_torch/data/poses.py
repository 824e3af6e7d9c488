"""Synthetic camera poses for novel-view rendering, as
``nerf_tpu.data.poses``: ``pose_spherical`` translates along z by the
radius, rotates by phi about x and theta about y, then applies the fixed
axis swap; the eval orbit is ``pose_spherical(theta, -30, 4)`` for theta in
``linspace(-180, 180, n+1)[:-1]``.
"""

from __future__ import annotations

import numpy as np


def translate_z(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rotate_phi_x(phi: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1] = m[2, 2] = c
    m[1, 2] = -s
    m[2, 1] = s
    return m


def rotate_theta_y(theta: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    m[0, 0] = m[2, 2] = c
    m[0, 2] = -s
    m[2, 0] = s
    return m


_AXIS_SWAP = np.array(
    [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world for a camera on a sphere looking at the origin."""
    c2w = translate_z(radius)
    c2w = rotate_phi_x(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rotate_theta_y(theta_deg / 180.0 * np.pi) @ c2w
    return (_AXIS_SWAP @ c2w).astype(np.float32)


def spherical_orbit(
    num_poses: int, phi_deg: float = -30.0, radius: float = 4.0
) -> np.ndarray:
    """The eval orbit: (num_poses, 4, 4) c2w matrices."""
    thetas = np.linspace(-180.0, 180.0, num_poses + 1)[:-1]
    return np.stack([pose_spherical(t, phi_deg, radius) for t in thetas], axis=0)
