"""Writes the committed JPEG fixtures beside this file:

    python tests/data/jpeg/make_fixtures.py

  * ``*.jpg``: small JPEGs of every kind the port's decoder
    (``nerf_tpu_torch/utils/jpeg.py``) covers, written by PIL from a seeded
    pattern (and one 4:4:0 file by OpenCV, which PIL cannot write);
  * ``sha256.json``: for each, the shape and the SHA-256 of the pixels
    that ``imageio.v2.imread`` gives, which the port must reproduce
    (``tests/test_torch_port_jpeg.py``, ``chip_smoke.py`` phase 34);
  * ``llff/``: a JPEG LLFF capture, ``chip_smoke.py``'s phase-31 synthetic
    forward-facing scene rendered at 1008 x 756 (``fern_views``) as 20
    ``images/img_*.jpg`` (4:2:0, quality 90) and ``poses_bounds.npy`` (hwf
    756, 1008, 815.13), which configs/fern.txt loads with llff_factor 2.

Needs numpy, PIL, imageio and OpenCV; the port needs none of them.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
LLFF_HW = (756, 1008)
LLFF_HWF = (756.0, 1008.0, 3260.526 / 4.0)


def pattern(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour ramps, stripes and seeded noise: every frequency band
    carries coefficients."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / 5.0 + y / 7.0), np.cos(x / 3.0) * np.sin(y / 4.0),
                     ((x * y) % 17) / 8.5 - 1.0], -1)
    img = (base * 0.5 + 0.5) * 200.0 + rng.integers(0, 56, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# name -> (h, w, PIL save options; "gray" saves the first channel)
FIXTURES = {
    "q50_444_37x53": (37, 53, dict(quality=50, subsampling=0)),
    "q75_422_37x53": (37, 53, dict(quality=75, subsampling=1)),
    "q95_420_37x53": (37, 53, dict(quality=95, subsampling=2)),
    "q75_420_8x8": (8, 8, dict(quality=75, subsampling=2)),
    "q95_422_17x250": (17, 250, dict(quality=95, subsampling=1)),
    "gray_q75_37x53": (37, 53, dict(quality=75, gray=True)),
    "gray_q50_17x250": (17, 250, dict(quality=50, gray=True)),
    "restart4_420_37x53": (37, 53, dict(quality=75, subsampling=2, restart_marker_blocks=4)),
    "restart4_444_17x250": (17, 250, dict(quality=90, subsampling=0, restart_marker_blocks=4)),
    "optimize_420_37x53": (37, 53, dict(quality=75, subsampling=2, optimize=True)),
    "exif6_420_37x53": (37, 53, dict(quality=75, subsampling=2, exif_orientation=6)),
    "progressive_420_37x53": (37, 53, dict(quality=80, subsampling=2, progressive=True)),
    "progressive_444_17x250": (17, 250, dict(quality=90, subsampling=0, progressive=True)),
    "progressive_gray_8x8": (8, 8, dict(quality=75, gray=True, progressive=True)),
}


def write_pil(img: np.ndarray, opts: dict) -> bytes:
    from PIL import Image

    opts = dict(opts)
    if opts.pop("gray", False):
        img = img[..., 0]
    orientation = opts.pop("exif_orientation", None)
    if orientation is not None:
        exif = Image.Exif()
        exif[0x0112] = orientation
        opts["exif"] = exif.tobytes()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def write_440(img: np.ndarray) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 85,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    if not ok:
        raise RuntimeError("OpenCV could not write the 4:4:0 JPEG")
    return enc.tobytes()


def pixel_hash(pixels: np.ndarray) -> dict:
    return {"shape": list(pixels.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()}


def main() -> None:
    import imageio.v2 as imageio

    files = {f"{name}.jpg": write_pil(pattern(h, w, i), opts)
             for i, (name, (h, w, opts)) in enumerate(FIXTURES.items())}
    files["q85_440_37x53.jpg"] = write_440(pattern(37, 53, len(FIXTURES)))
    hashes = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        hashes[name] = pixel_hash(imageio.imread(io.BytesIO(data)))
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")

    sys.path.insert(0, ROOT)
    from chip_smoke import fern_views      # noqa: E402  (the phase-31 scene)

    scene = os.path.join(HERE, "llff")
    os.makedirs(os.path.join(scene, "images"), exist_ok=True)
    rows = []
    for i, (img, row) in enumerate(fern_views(LLFF_HW, LLFF_HWF)):
        with open(os.path.join(scene, "images", f"img_{i:03d}.jpg"), "wb") as f:
            f.write(write_pil(img, dict(quality=90, subsampling=2)))
        rows.append(row)
    np.save(os.path.join(scene, "poses_bounds.npy"), np.stack(rows))


if __name__ == "__main__":
    main()
