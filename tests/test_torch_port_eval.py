"""The port's eval CLI (``nerf_tpu_torch.cli.eval_cli``) against nerf_tpu's
(``nerf_tpu.cli.eval_cli``, the pure-JAX path) on the CPU: orbit frames,
``--metrics``, ``--video`` and ``--bake`` from checkpoints of the same
parameters, ``ssim`` against nerf_tpu's, and the refusals (an LLFF JPEG
frame, a card that is not there)."""

from __future__ import annotations

import io
import json
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from nerf_tpu.cli.eval_cli import main as jax_eval_main
from nerf_tpu.config import parse_config_file as jax_parse_config_file
from nerf_tpu.train.state import create_train_state
from nerf_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_tpu.utils.metrics import ssim as jax_ssim
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.cli.eval_cli import main as eval_main
from nerf_tpu_torch.config import parse_config_file
from nerf_tpu_torch.models.convert import load_jax_params
from nerf_tpu_torch.models.registry import model_from_config
from nerf_tpu_torch.utils.checkpoint import save_checkpoint
from nerf_tpu_torch.utils.metrics import ssim
from nerf_tpu_torch.utils.png import read_png

FIELDS = """hidden_dim = 32
num_samples = 8
num_fine_samples = 16
perturb = false
chunk_size = 100
num_render_poses = 4
"""
QUIET = dict(log=lambda *a: None)


def _checkpoints(root: str, model_type: str, extra: str = "") -> dict:
    """One JAX state of ``model_type`` from the config's seed, saved with
    nerf_tpu's checkpoint (its eval reads it with use_pallas = false) and
    carried into a port checkpoint with load_jax_params (the port reads
    the same file without use_pallas, its default route)."""
    text = (f"dataset_path = {os.path.join(root, 'scene')}\nmodel_type = {model_type}\n"
            + FIELDS + extra)
    paths = {}
    for side, more in (("jax", "use_pallas = false\n"), ("port", "")):
        paths[f"{side}_cfg"] = os.path.join(root, f"{model_type}_{side}.txt")
        with open(paths[f"{side}_cfg"], "w") as f:
            f.write(text + more)
    jcfg = jax_parse_config_file(paths["jax_cfg"])
    _, _, state = create_train_state(jcfg, jax.random.key(jcfg.seed))
    paths["jax_ckpt"] = jax_save_checkpoint(state, os.path.join(root, "jax_models"),
                                            model_type, 5)
    cfg = parse_config_file(paths["port_cfg"])
    coarse, fine = model_from_config(cfg), model_from_config(cfg)
    load_jax_params(coarse, jax.tree.map(np.asarray, state.params))
    load_jax_params(fine, jax.tree.map(np.asarray, state.fine_params))
    paths["port_ckpt"] = save_checkpoint(coarse, fine, os.path.join(root, "port_models"),
                                         model_type, 5)
    return paths


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    make_synthetic_blender_scene(os.path.join(root, "scene"), h=16, w=16, num_train=1,
                                 num_val=1, num_test=1)
    return root


@pytest.fixture(scope="module")
def nerf(root):
    return _checkpoints(root, "nerf")


@pytest.fixture(scope="module")
def orbit(root, nerf):
    """Both CLIs' orbit frames; the port's with --video orbit.gif."""
    out = {side: os.path.join(root, f"orbit_{side}") for side in ("jax", "port")}
    jax_eval_main(["--config", nerf["jax_cfg"], "--checkpoint", nerf["jax_ckpt"],
                   "--output", out["jax"]])
    eval_main(["--config", nerf["port_cfg"], "--checkpoint", nerf["port_ckpt"],
               "--output", out["port"], "--video", os.path.join(out["port"], "orbit.gif"),
               "--fps", "10", "--device", "cpu"], **QUIET)
    return out


def _metrics(d: str) -> dict:
    with open(os.path.join(d, "metrics.json")) as f:
        return json.load(f)


def _frames(d: str, prefix: str) -> list:
    return sorted(n for n in os.listdir(d) if n.startswith(prefix) and n.endswith(".png"))


def test_orbit_frames_match_nerf_tpu(orbit):
    """(a) The same four frame_*.png, within 1 uint8 step of nerf_tpu's."""
    names = _frames(orbit["port"], "frame_")
    assert names == _frames(orbit["jax"], "frame_") == [f"frame_{i:04d}.png" for i in range(4)]
    for n in names:
        got = read_png(os.path.join(orbit["port"], n)).astype(int)
        want = imageio.imread(os.path.join(orbit["jax"], n)).astype(int)
        assert got.shape == want.shape == (16, 16, 3)
        assert np.abs(got - want).max() <= 1, n


def test_metrics_match_nerf_tpu(root, nerf):
    """(b) --metrics: metrics.json with nerf_tpu's keys, PSNR within 1e-3 dB
    and SSIM within 1e-4 of nerf_tpu's, one pred_*.png a view."""
    out = {side: os.path.join(root, f"metrics_{side}") for side in ("jax", "port")}
    jax_eval_main(["--config", nerf["jax_cfg"], "--checkpoint", nerf["jax_ckpt"],
                   "--output", out["jax"], "--metrics"])
    lines: list = []
    eval_main(["--config", nerf["port_cfg"], "--checkpoint", nerf["port_ckpt"],
               "--output", out["port"], "--metrics", "--device", "cpu"], log=lines.append)
    got, want = (_metrics(out[s]) for s in ("port", "jax"))
    assert set(got) == set(want) == {"num_views", "mean_psnr", "mean_ssim", "views"}
    assert got["num_views"] == want["num_views"] == len(got["views"]) == 1
    for g, w in zip(got["views"], want["views"]):
        assert set(g) == set(w) == {"view", "mse", "psnr", "ssim"} and g["view"] == w["view"]
        assert abs(g["psnr"] - w["psnr"]) < 1e-3 and abs(g["ssim"] - w["ssim"]) < 1e-4
    assert abs(got["mean_psnr"] - want["mean_psnr"]) < 1e-3
    assert abs(got["mean_ssim"] - want["mean_ssim"]) < 1e-4
    assert _frames(out["port"], "pred_") == _frames(out["jax"], "pred_") == ["pred_000.png"]
    assert any(line.startswith("Test split (1 views): PSNR") for line in lines)


@pytest.mark.parametrize("shape", [(16, 16, 3), (23, 40, 3), (19, 12), (11, 11)])
def test_ssim_matches_nerf_tpu(shape):
    """(c) The vectorised SSIM against nerf_tpu's np.convolve one."""
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0.0, 1.0)
    assert abs(ssim(a, b) - jax_ssim(a, b)) < 1e-10
    assert abs(ssim(a, a) - 1.0) < 1e-12


def test_video_gif_holds_the_frames(orbit):
    """(d) --video orbit.gif decodes (imageio) to exactly the written frames
    (16 x 16: at most 256 colours a frame, so the palette is exact), at the
    delay of --fps 10."""
    gif = os.path.join(orbit["port"], "orbit.gif")
    frames = imageio.mimread(gif, format="GIF")
    want = [read_png(os.path.join(orbit["port"], n))
            for n in _frames(orbit["port"], "frame_")]
    assert len(frames) == len(want) == 4
    for f, w in zip(frames, want):
        f = np.asarray(f)
        f = np.repeat(f[..., None], 3, -1) if f.ndim == 2 else f[..., :3]
        np.testing.assert_array_equal(f, w)
    with open(gif, "rb") as fh:
        data = fh.read()
    assert data[:6] == b"GIF89a" and b"NETSCAPE2.0" in data
    assert data.count(b"\x21\xf9\x04\x04\x0a\x00") == 4      # 10 hundredths a frame


def test_bake_matches_nerf_tpu_and_nerf_refuses(root, nerf):
    """(e) --bake 16 of a small FastNeRF checkpoint: the same frames as
    nerf_tpu's eval with --bake 16 within 1 uint8 step (both through the
    cache's float32 interpolation); --bake on a NeRF exits with nerf_tpu's
    message."""
    fast = _checkpoints(root, "fastnerf",
                        "pos_encoding_dim = 4\ndir_encoding_dim = 2\nnum_render_poses = 2\n"
                        "use_pallas = false\n")
    out = {side: os.path.join(root, f"bake_{side}") for side in ("jax", "port")}
    jax_eval_main(["--config", fast["jax_cfg"], "--checkpoint", fast["jax_ckpt"],
                   "--output", out["jax"], "--bake", "16"])
    eval_main(["--config", fast["port_cfg"], "--checkpoint", fast["port_ckpt"],
               "--output", out["port"], "--bake", "16", "--device", "cpu"], **QUIET)
    names = _frames(out["port"], "frame_")
    assert names == _frames(out["jax"], "frame_") == ["frame_0000.png", "frame_0001.png"]
    for n in names:
        got = read_png(os.path.join(out["port"], n)).astype(int)
        want = imageio.imread(os.path.join(out["jax"], n)).astype(int)
        assert np.abs(got - want).max() <= 1, n
    msgs = []
    for fn, side in ((jax_eval_main, "jax"), (eval_main, "port")):
        argv = ["--config", nerf[f"{side}_cfg"], "--checkpoint", nerf[f"{side}_ckpt"],
                "--output", os.path.join(root, "refused"), "--bake", "8"]
        with pytest.raises(SystemExit) as e:
            fn(argv + (["--device", "cpu"] if side == "port" else []),
               **(QUIET if side == "port" else {}))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[1].startswith("--bake: model 'nerf' has no baked cache")


def test_llff_and_missing_card_raise(root, nerf):
    """(f) An LLFF scene with a JPEG frame the port does not decode (an
    arithmetic-coded SOF9 frame) raises NotImplementedError naming the
    marker; the default device (cuda) without a card raises RuntimeError."""
    from tests.synthetic import make_synthetic_llff_scene

    scene = make_synthetic_llff_scene(os.path.join(root, "llff_jpeg"), h=8, w=8,
                                      num_images=2)
    first = os.path.join(scene, "images", "img_000.png")
    buf = io.BytesIO()
    imageio.imwrite(buf, imageio.imread(first)[..., :3], format="jpeg")
    os.remove(first)
    with open(first[:-4] + ".jpg", "wb") as f:      # SOF0 -> SOF9
        f.write(buf.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1))
    llff = os.path.join(root, "llff.txt")
    with open(nerf["port_cfg"]) as f, open(llff, "w") as g:
        g.write(f.read() + f"dataset_type = llff\ndataset_path = {scene}\nllff_factor = 1\n")
    base = ["--checkpoint", nerf["port_ckpt"], "--output", os.path.join(root, "raised")]
    with pytest.raises(NotImplementedError, match="SOF9"):
        eval_main(["--config", llff, "--device", "cpu"] + base, **QUIET)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_main(["--config", nerf["port_cfg"]] + base, **QUIET)
