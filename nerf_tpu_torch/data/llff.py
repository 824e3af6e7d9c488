"""LLFF forward-facing dataset loader (``poses_bounds.npy`` format), as
``nerf_tpu.data.llff``, in numpy and in the same operation order, so that
images, poses, bounds, focal, splits and the spiral render path come out
bit for bit the JAX package's:

  * reads ``poses_bounds.npy`` (N rows of a flattened 3x5 [R|t|hwf] matrix
    plus 2 depth bounds) and the ``images_{factor}/`` folder, else
    ``images/`` downsampled here by box averaging;
  * converts LLFF's [down, right, back] axes to NeRF's [right, up, back];
  * rescales by the near bound and recenters the poses on their average;
  * holds out every 8th view as the test split;
  * makes a spiral render path for novel views.

Frames (``.png``, ``.jpg``, ``.jpeg``, as the JAX package lists them) are
read by the port's own decoders (``data/frames.py``: ``utils/png.py`` and
``utils/jpeg.py``, which gives imageio's pixels), so a capture that ships
only an ``images/`` folder of JPEGs loads and is downsampled here as the
JAX package does. Use with ``ops/ndc.py::ndc_rays`` and t in [0, 1].
"""

from __future__ import annotations

import os

import numpy as np

from nerf_tpu_torch.data.frames import read_frame


def _downsample(img: np.ndarray, factor: int) -> np.ndarray:
    h, w = img.shape[:2]
    hf, wf = h // factor, w // factor
    img = img[: hf * factor, : wf * factor]
    return img.reshape(hf, factor, wf, factor, -1).mean(axis=(1, 3))


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _average_pose(poses: np.ndarray) -> np.ndarray:
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _viewmatrix(z, up, center)


def _recenter_poses(poses: np.ndarray) -> np.ndarray:
    c2w = _average_pose(poses)
    bottom = np.array([[0, 0, 0, 1.0]], dtype=np.float32)
    c2w_h = np.concatenate([c2w, bottom], axis=0)
    poses_h = np.concatenate(
        [poses[:, :3, :4], np.broadcast_to(bottom, (poses.shape[0], 1, 4))], axis=1
    )
    out = np.linalg.inv(c2w_h) @ poses_h
    return out[:, :3, :4].astype(np.float32)


def load_llff(
    dataset_path: str,
    factor: int = 8,
    bd_factor: float = 0.75,
    holdout: int = 8,
) -> dict:
    """Load an LLFF scene: a dict with images (N, H, W, 3) f32, poses
    (N, 3, 4) f32, bds (N, 2), focal, hw, i_train / i_test, render_poses
    (120, 3, 4) of the spiral path, and the near/far of NDC (0, 1) and of
    world rays."""
    pb = np.load(os.path.join(dataset_path, "poses_bounds.npy"))  # (N, 17)
    poses = pb[:, :-2].reshape(-1, 3, 5)
    bds = pb[:, -2:]

    # [down, right, back] -> [right, up, back]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2
    )
    hwf = poses[0, :, 4]
    h, w, focal = float(hwf[0]), float(hwf[1]), float(hwf[2])

    img_dir = os.path.join(dataset_path, f"images_{factor}" if factor > 1 else "images")
    pre_downsampled = os.path.isdir(img_dir)
    if not pre_downsampled:
        img_dir = os.path.join(dataset_path, "images")
    names = sorted(
        f
        for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if len(names) != poses.shape[0]:
        raise ValueError(
            f"{len(names)} images in {img_dir} but {poses.shape[0]} poses"
        )

    images = []
    for name in names:
        img = read_frame(os.path.join(img_dir, name)).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = img[..., :3]
        if not pre_downsampled and factor > 1:
            img = _downsample(img, factor)
        images.append(img.astype(np.float32))
    images_arr = np.stack(images, axis=0)

    if factor > 1:
        h, w, focal = h / factor, w / factor, focal / factor
    # the loaded size wins (a pre-downsampled folder may round otherwise)
    h, w = images_arr.shape[1], images_arr.shape[2]

    # rescale so that the nearest depth maps to ~1/bd_factor
    sc = 1.0 if bd_factor is None else 1.0 / (float(bds.min()) * bd_factor)
    poses = poses.astype(np.float32)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    poses34 = _recenter_poses(poses[:, :3, :4])

    n = images_arr.shape[0]
    i_test = np.arange(n)[::holdout]
    i_train = np.array([i for i in range(n) if i not in set(i_test.tolist())])

    render_poses = spiral_render_path(poses34, bds)

    return {
        "images": images_arr,
        "poses": poses34,
        "bds": bds.astype(np.float32),
        "focal": float(focal),
        "hw": (int(h), int(w)),
        "i_train": i_train,
        "i_test": i_test,
        "render_poses": render_poses,
        "near_ndc": 0.0,
        "far_ndc": 1.0,
        "near_world": float(bds.min()) * 0.9,
        "far_world": float(bds.max()) * 1.0,
    }


def spiral_render_path(
    poses: np.ndarray, bds: np.ndarray, num_views: int = 120, num_rots: int = 2
) -> np.ndarray:
    """The standard LLFF spiral camera path around the average pose."""
    c2w = _average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))

    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

    rads = np.percentile(np.abs(poses[:, :3, 3] - c2w[:3, 3]), 90, axis=0)
    rads = np.concatenate([rads, [1.0]])

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * num_rots, num_views + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * 0.5), 1.0])
            * rads
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(_viewmatrix(z, up, c))
    return np.stack(out, axis=0).astype(np.float32)
