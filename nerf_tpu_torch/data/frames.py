"""A scene's frames read from disk, by extension (any case): ``.png``
through ``utils/png.py``, ``.jpg`` / ``.jpeg`` through ``utils/jpeg.py``.
The Blender and LLFF loaders read every frame here, where the JAX package
reads through imageio."""

from __future__ import annotations

import os

import numpy as np

from nerf_tpu_torch.utils.jpeg import read_jpeg
from nerf_tpu_torch.utils.png import read_png


def read_frame(path: str) -> np.ndarray:
    """(H, W) or (H, W, C) uint8."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext in (".jpg", ".jpeg"):
        return read_jpeg(path)
    raise NotImplementedError(f"{path}: the port reads PNG and JPEG frames only "
                              f"(not {ext or 'a file without an extension'})")
