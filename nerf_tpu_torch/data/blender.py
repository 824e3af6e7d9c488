"""Blender-synthetic dataset loader (``transforms_{split}.json`` format), as
``nerf_tpu.data.blender``: each frame's PNG scaled to [0,1], RGBA composited
over a white (or black) background, focal ``0.5*W / tan(0.5*camera_angle_x)``,
``single_image`` for the first frame only, optional 2x ``half_res``. PNGs
are read by the port's stdlib decoder (``utils/png.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_tpu_torch.utils.png import read_png


def _downsample2x(img: np.ndarray) -> np.ndarray:
    h, w, c = img.shape
    return img[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2, c).mean(
        axis=(1, 3)
    )


def load_blender(
    dataset_path: str,
    mode: str = "train",
    single_image: bool = False,
    white_background: bool = True,
    half_res: bool = False,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Returns (images (N,H,W,3) float32 in [0,1], c2w (N,4,4) float32, focal).

    With ``white_background`` RGBA frames are composited over white;
    otherwise alpha-premultiplied over black (the original NeRF's
    ``white_bkgd=False`` path).
    """
    transforms_path = os.path.join(dataset_path, f"transforms_{mode}.json")
    with open(transforms_path, "r") as f:
        meta = json.load(f)

    images: list[np.ndarray] = []
    c2w_matrices: list[np.ndarray] = []
    for frame in meta["frames"]:
        rel = frame["file_path"].lstrip("./")
        img_path = os.path.join(dataset_path, rel)
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        img = read_png(img_path).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] == 4:
            alpha = img[..., 3:4]
            if white_background:
                img = img[..., :3] * alpha + (1.0 - alpha)
            else:
                img = img[..., :3] * alpha
        else:
            img = img[..., :3]
        if half_res:
            img = _downsample2x(img)
        images.append(img.astype(np.float32))
        c2w_matrices.append(np.array(frame["transform_matrix"], dtype=np.float32))
        if single_image:
            break

    images_arr = np.stack(images, axis=0)
    c2w_arr = np.stack(c2w_matrices, axis=0)
    w = images_arr.shape[2]
    focal = float(0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"])))
    return images_arr, c2w_arr, focal
