"""The port's JPEG decoder (``nerf_tpu_torch/utils/jpeg.py``) against
``imageio.v2.imread`` (libjpeg-turbo through PIL), and the Blender and LLFF
loaders on JPEG frames against nerf_tpu's, on the CPU.

JPEGs that PIL writes here (three sizes, every kind the decoder covers),
the committed fixtures (``tests/data/jpeg/``, made by its
``make_fixtures.py``) against their committed pixel hashes, an
``images/``-only JPEG LLFF scene at factor 2 and a Blender scene of
``.jpg`` frames through both packages, and the forms that raise."""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerf_tpu.data.blender import load_blender as jax_load_blender
from nerf_tpu.data.llff import load_llff as jax_load_llff
from tests.synthetic import make_synthetic_blender_scene, make_synthetic_llff_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.data.blender import load_blender
from nerf_tpu_torch.data.frames import read_frame
from nerf_tpu_torch.data.llff import load_llff
from nerf_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")


def _pattern(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / 5.0 + y / 7.0), np.cos(x / 3.0) * np.sin(y / 4.0),
                     ((x * y) % 17) / 8.5 - 1.0], -1)
    return np.clip((base * 0.5 + 0.5) * 200.0 + rng.integers(0, 56, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _exif(orientation: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


KINDS = {
    "q50_444": dict(quality=50, subsampling=0),
    "q75_422": dict(quality=75, subsampling=1),
    "q95_420": dict(quality=95, subsampling=2),
    "gray": dict(quality=75),
    "restart4": dict(quality=75, subsampling=2, restart_marker_blocks=4),
    "optimize": dict(quality=75, subsampling=2, optimize=True),
    "exif6": dict(quality=75, subsampling=2, exif=_exif(6)),
    "progressive_420": dict(quality=80, subsampling=2, progressive=True),
    "progressive_444": dict(quality=95, subsampling=0, progressive=True),
    "progressive_gray": dict(quality=75, progressive=True),
}


def _differ(got: np.ndarray, want: np.ndarray, label: str) -> int:
    """Max abs difference; prints the count of unequal pixels."""
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{label}: max abs {d.max()}, {int((d > 0).sum())} of {d.size} values unequal")
    return int(d.max())


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("hw", [(37, 53), (8, 8), (17, 250)])
def test_decode_matches_imageio(kind, hw):
    img = _pattern(*hw, seed=hw[0] * 1000 + hw[1])
    if kind.endswith("gray"):
        img = img[..., 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **KINDS[kind])
    data = buf.getvalue()
    want = imageio.imread(io.BytesIO(data))
    assert _differ(decode_jpeg(data), np.asarray(want), f"{kind} {hw}") <= 1


def _fixture_hashes() -> dict:
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_fixture_hashes()))
def test_fixtures_decode_to_their_hashes(name):
    """Each committed fixture decodes to the pixels whose hash its
    generator took from imageio, and to imageio's pixels now."""
    want = _fixture_hashes()[name]
    path = os.path.join(FIXTURES, name)
    got = read_jpeg(path)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    assert _differ(got, np.asarray(imageio.imread(path)), name) == 0


def _jpeg_llff_scene(root: str) -> str:
    """The synthetic LLFF scene with its images/ folder as JPEGs only."""
    scene = make_synthetic_llff_scene(root, h=36, w=44, num_images=9)
    img_dir = os.path.join(scene, "images")
    for i, name in enumerate(sorted(os.listdir(img_dir))):
        path = os.path.join(img_dir, name)
        img = imageio.imread(path)[..., :3]
        os.remove(path)
        ext = (".jpg", ".JPG", ".jpeg")[i % 3]
        Image.fromarray(img).save(path[:-4] + ext, format="JPEG", quality=90,
                                  subsampling=2 if i % 2 else 0)
    return scene


def test_load_llff_jpeg_scene_matches_nerf_tpu(tmp_path):
    """images/ of JPEGs only, factor 2 (downsampled on load): images within
    1/255 of nerf_tpu's, everything else bit for bit."""
    scene = _jpeg_llff_scene(str(tmp_path / "llff"))
    got = load_llff(scene, factor=2)
    want = jax_load_llff(scene, factor=2)
    assert got.keys() == want.keys()
    assert got["images"].shape == want["images"].shape == (9, 18, 22, 3)
    err = float(np.abs(got["images"] - want["images"]).max())
    print(f"load_llff images: max abs {err:.3e}")
    assert err <= 1.0 / 255.0
    for k in got:
        if k == "images":
            continue
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_blender_jpeg_frames_match_nerf_tpu(tmp_path):
    """transforms_*.json naming .jpg frames, as capture tools write them."""
    root = str(tmp_path / "blender")
    make_synthetic_blender_scene(root, h=24, w=20, num_train=3, num_val=1, num_test=1)
    with open(os.path.join(root, "transforms_train.json")) as f:
        meta = json.load(f)
    for frame in meta["frames"]:
        png = os.path.join(root, frame["file_path"].lstrip("./") + ".png")
        img = imageio.imread(png)
        rgb = (img[..., :3].astype(np.float32) * (img[..., 3:4] / 255.0)
               + 255.0 * (1.0 - img[..., 3:4] / 255.0)).astype(np.uint8)
        Image.fromarray(rgb).save(png[:-4] + ".jpg", format="JPEG", quality=85)
        os.remove(png)
        frame["file_path"] += ".jpg"
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(meta, f)
    for half_res in (False, True):
        images, c2w, focal = load_blender(root, "train", half_res=half_res)
        want_images, want_c2w, want_focal = jax_load_blender(root, "train", half_res=half_res)
        assert images.shape == want_images.shape == (3, 24 // (1 + half_res),
                                                     20 // (1 + half_res), 3)
        assert np.abs(images - want_images).max() <= 1.0 / 255.0
        np.testing.assert_array_equal(c2w, want_c2w)
        assert focal == want_focal


def _sof(marker: int, precision: int = 8, comps: tuple = ((1, 0x11, 0),)) -> bytes:
    body = struct.pack(">BHHB", precision, 8, 8, len(comps)) + b"".join(
        bytes(c) for c in comps)
    return (b"\xff\xd8" + struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body
            + b"\xff\xd9")


@pytest.mark.parametrize("data, match", [
    (_sof(0xC9), "SOF9"),
    (_sof(0xCA), "SOF10"),
    (_sof(0xC3), "SOF3"),
    (_sof(0xC0, precision=12), "12-bit"),
    (_sof(0xC1, comps=((1, 0x11, 0), (2, 0x11, 1), (3, 0x11, 1), (4, 0x11, 0))),
     "4 components"),
    (_sof(0xC0, comps=((1, 0x31, 0), (2, 0x11, 1), (3, 0x11, 1))), "sampling factors 3x1"),
])
def test_unsupported_forms_raise(data, match):
    with pytest.raises(NotImplementedError, match=match):
        decode_jpeg(data)


def test_read_frame_by_extension(tmp_path):
    img = _pattern(9, 11, seed=5)
    path = str(tmp_path / "frame.JPEG")
    Image.fromarray(img).save(path, format="JPEG")
    np.testing.assert_array_equal(read_frame(path), imageio.imread(path))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(NotImplementedError, match=r"\.bmp"):
        read_frame(str(tmp_path / "frame.bmp"))
