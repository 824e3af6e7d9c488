"""The LLFF slice of nerf_tpu_torch against nerf_tpu on the CPU: ``load_llff``
(with and without a pre-downsampled folder), ``ndc_rays``, ``load_scene``'s
NDC and world pools, one NDC frame through the port's service against
nerf_tpu's eval render, one NDC train step against nerf_tpu's plain step,
and ``fit``, ``RenderService`` and the eval CLI on an LLFF scene (the
spiral frames, ``--metrics`` over the test views, a JPEG frame refused).

The scene is ``tests/synthetic.py::make_synthetic_llff_scene`` at 32 x 40,
12 views (test views 0 and 8). Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.data.llff import load_llff as jax_load_llff
from nerf_tpu.data.pipeline import load_scene as jax_load_scene
from nerf_tpu.data.rays import compute_rays_single as jax_rays_single
from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.ops.ndc import ndc_rays as jax_ndc_rays
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.train.loop import render_settings_from_config as jax_settings_from_config
from nerf_tpu.train.step import make_eval_render as jax_eval_render
from tests.synthetic import make_synthetic_llff_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.cli.eval_cli import main as eval_main
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.llff import load_llff
from nerf_tpu_torch.data.pipeline import RayBatch, load_scene
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.ndc import ndc_rays
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import fit, render_settings_from_config
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.train.step import _make_step_body
from nerf_tpu_torch.utils.checkpoint import save_checkpoint
from nerf_tpu_torch.utils.metrics import mse_to_psnr
from nerf_tpu_torch.utils.png import read_png, write_png

H, W, VIEWS = 32, 40, 12
QUIET = dict(log=lambda *a: None)
# ndc_rays against nerf_tpu's: the same float32 operations in the same
# order (measured bit for bit on the scene's rays and on 100,000 random
# ones), with room for a compiler that contracts a product and a sum into
# one rounding: within 1e-6 of each component's largest magnitude
NDC_RTOL = 1e-6


def _ndc_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| over each component's largest |want|."""
    return float((np.abs(got - want) / np.abs(want).max(axis=0)).max())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene (``images/`` only) and a copy with a
    pre-downsampled ``images_2/`` folder of PNGs."""
    root = str(tmp_path_factory.mktemp("llff"))
    base = make_synthetic_llff_scene(os.path.join(root, "scene"), h=H, w=W,
                                     num_images=VIEWS)
    pre = os.path.join(root, "pre")
    shutil.copytree(base, pre)
    os.makedirs(os.path.join(pre, "images_2"))
    for name in sorted(os.listdir(os.path.join(base, "images"))):
        img = read_png(os.path.join(base, "images", name)).astype(np.float32)
        small = img.reshape(H // 2, 2, W // 2, 2, 3).mean(axis=(1, 3))
        write_png(os.path.join(pre, "images_2", name), small.astype(np.uint8))
    return {"root": root, "base": base, "pre": pre}


def _cfg(path: str, **kw) -> Config:
    base = dict(dataset_path=path, dataset_type="llff", llff_factor=1, ndc=True,
                white_background=False, hidden_dim=32, num_samples=8,
                num_fine_samples=16, perturb=False, chunk_size=512)
    base.update(kw)
    return Config(**base)


def _jax_cfg(cfg: Config) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------- loader


@pytest.mark.parametrize("which,factor", [("base", 1), ("base", 2), ("pre", 2)])
def test_load_llff_matches_nerf_tpu(scene, which, factor):
    """Every output of load_llff bit for bit nerf_tpu's: images (read by the
    port's PNG decoder; at factor 2 downsampled here, or read from
    images_2/), poses, bounds, focal, size, splits, spiral poses and the
    near/far suggestions."""
    got = load_llff(scene[which], factor=factor)
    want = jax_load_llff(scene[which], factor=factor)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k
    assert got["images"].shape == (VIEWS, H // factor, W // factor, 3)
    assert list(got["i_test"]) == [0, 8] and got["render_poses"].shape == (120, 3, 4)


def test_ndc_rays_matches_nerf_tpu(scene):
    """The NDC warp of every world ray of the scene (and of rays with
    arbitrary directions) against nerf_tpu's, within NDC_RTOL of each
    component's largest magnitude."""
    data = load_llff(scene["base"], factor=1)
    rng = np.random.default_rng(3)
    os_, ds = [], []
    for pose in data["poses"]:
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = pose
        o, d = jax_rays_single(H, W, data["focal"], c2w)
        os_.append(o)
        ds.append(d)
    o = np.concatenate(os_ + [rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32)])
    d = rng.normal(size=(500, 3)) * 0.3 + [0.0, 0.0, -1.0]
    d = np.concatenate(ds + [d.astype(np.float32)])
    got = ndc_rays(H, W, data["focal"], 1.0, torch.from_numpy(o), torch.from_numpy(d))
    want = jax_ndc_rays(H, W, data["focal"], 1.0, jnp.asarray(o), jnp.asarray(d))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _ndc_err(g.numpy(), w) <= NDC_RTOL


@pytest.mark.parametrize("ndc", [True, False])
def test_load_scene_matches_nerf_tpu(scene, ndc):
    """load_scene's pool and validation split against nerf_tpu's: with NDC
    the rays and the (world) view directions within NDC_RTOL of each
    component's largest magnitude, the target rgb exact; world rays exact;
    near/far, validation images and poses, focal, size and spiral poses
    exact; a white background never."""
    cfg = _cfg(scene["base"], ndc=ndc, white_background=True)
    got = load_scene(cfg)
    want = jax_load_scene(_jax_cfg(cfg))
    assert (got.ndc, got.white_background) == (ndc, False) == (want.ndc, want.white_background)
    assert (got.near, got.far, got.focal, got.hw) == (want.near, want.far, want.focal, want.hw)
    assert got.pool.size == want.pool.size == (VIEWS - 2) * H * W
    for k in ("val_images", "val_c2w", "render_poses"):
        assert np.array_equal(getattr(got, k), np.asarray(getattr(want, k))), k
    for k in ("rays_o", "rays_d", "rgb", "viewdirs"):
        g, w = getattr(got.pool, k).numpy(), np.asarray(getattr(want.pool, k))
        if ndc and k != "rgb":
            assert _ndc_err(g, w) <= NDC_RTOL, k
        else:
            assert np.array_equal(g, w), k
    if ndc:
        np.testing.assert_allclose(got.pool.rays_o[:, 2] + got.pool.rays_d[:, 2], 1.0,
                                   atol=1e-5)


# ---------------------------------------------------------------- frame and step


@pytest.fixture(scope="module")
def pair():
    """A JAX NeRF at hidden 256 (the fused route's width) and the port's
    models with the same coarse and fine weights."""
    jm = JaxNeRF(hidden_dim=256)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(4)))
    fine = jax.tree.map(np.asarray, jm.init(jax.random.key(5)))
    tm, tf = NeRFModel(hidden_dim=256), NeRFModel(hidden_dim=256)
    load_jax_params(tm, params)
    load_jax_params(tf, fine)
    return jm, params, fine, tm, tf


def test_ndc_frame_matches_nerf_tpu(scene, pair, tmp_path):
    """Test view 8 served by the port's RenderService from a checkpoint of
    the pair (the fused render's plain version with normalize off, the NDC
    warp in render_pose, world view directions) against nerf_tpu's eval
    render (its pure path) of nerf_tpu's NDC rays at nerf_tpu's settings,
    perturb off: within 1e-5, as tests/test_torch_port_render.py holds the
    fused plain version against the pure path in float32."""
    jm, params, fine, tm, tf = pair
    cfg = _cfg(scene["base"], hidden_dim=256)
    ckpt = save_checkpoint(tm, tf, str(tmp_path), "nerf", 1)
    svc = RenderService.from_checkpoint(cfg, ckpt, device="cpu", **QUIET)
    assert svc.ndc and (svc.cfg.near, svc.cfg.far) == (0.0, 1.0) and svc.hw == (H, W)
    data = load_llff(scene["base"], factor=1)
    got = svc.render_pose(data["poses"][8])

    jcfg = _jax_cfg(cfg)
    jcfg.near, jcfg.far = 0.0, 1.0
    settings = jax_settings_from_config(jcfg, ndc=True)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3] = data["poses"][8]
    o, d = jax_rays_single(H, W, data["focal"], c2w)
    o_n, d_n = jax_ndc_rays(H, W, data["focal"], 1.0, jnp.asarray(o), jnp.asarray(d))
    ref = jax_eval_render(jm, settings, use_pallas=False)(
        params, fine, o_n, d_n, jax.random.key(0), viewdirs=jnp.asarray(d))
    want = np.clip(np.asarray(ref.rgb).reshape(H, W, 3), 0.0, 1.0)
    assert np.isfinite(got).all() and got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ndc_train_step_matches_nerf_tpu(scene, pair):
    """One hierarchical train step on 64 rays of the NDC pool (the same
    indices of both pools; perturb off): the port's step through the fused
    train pass's plain version (normalize off, black background) against
    nerf_tpu's plain step (its pure path under value_and_grad). Loss and mse
    within 1e-5 relative; each gradient tensor within 1e-3 of its largest
    magnitude, floored at 1e-2 of the model's largest gradient element (as
    chip_smoke.py's grad_errors: a bias whose terms cancel has no scale of
    its own), since the fused cos columns round otherwise than the unfused
    ones by an ulp, which the sums of 64 x 24 samples carry."""
    jm, params, fine, _, _ = pair
    cfg = _cfg(scene["base"], hidden_dim=256)
    pool = load_scene(cfg).pool
    jpool = jax_load_scene(_jax_cfg(cfg)).pool
    idx = np.random.default_rng(6).choice(pool.size, 64, replace=False)
    jcfg = _jax_cfg(cfg)
    jcfg.near, jcfg.far = 0.0, 1.0
    settings_j = jax_settings_from_config(jcfg, ndc=True)
    jb = [jnp.asarray(np.asarray(x)[idx]) for x in jpool]

    def loss_fn(pair):
        out = jax_render_rays(jm.apply, pair[0], jb[0], jb[1], jax.random.key(0),
                              settings_j, fine_params=pair[1], viewdirs=jb[3])
        mse = jnp.mean((out.rgb - jb[2]) ** 2)
        return mse + jnp.mean((out.rgb_coarse - jb[2]) ** 2), mse

    (loss_j, mse_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        (params, fine))

    tcfg = dataclasses.replace(cfg, near=0.0, far=1.0)
    state = create_train_state(tcfg, device="cpu")
    load_jax_params(state.params, params)
    load_jax_params(state.fine_params, fine)
    settings = render_settings_from_config(tcfg, ndc=True)
    assert not settings.normalize_positions and not settings.white_background
    _, train_on_batch = _make_step_body(state.params, settings, 64, seed=0)
    batch = RayBatch(*(x[torch.from_numpy(idx)] for x in pool))
    m = train_on_batch(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=1e-5)
    for model, g_j in ((state.params, grads_j[0]), (state.fine_params, grads_j[1])):
        got = jax.tree_util.tree_leaves(export_jax_grads(model))
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, g_j))
        assert len(got) == len(want)
        floor = 1e-2 * max(np.abs(b).max() for b in want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * max(np.abs(b).max(), floor))


# ---------------------------------------------------------------- fit, service, eval


def test_fit_serve_and_eval_cli_on_llff(scene, tmp_path):
    """fit() 2 iterations on the NDC scene with validation (the NDC warp of
    the test view), then the eval CLI from its checkpoint: 3 spiral frames,
    each the service's image of that spiral pose and key as quantised, and
    --metrics over the 2 test views, each view's PSNR that of the service's
    image of its pose against the test image."""
    cfg = _cfg(scene["base"], num_iters=2, val_interval=1, log_interval=1,
               save_interval=100, save_path=str(tmp_path / "models"),
               log_dir=str(tmp_path / "logs"), num_render_poses=3)
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    assert state.step == 2
    run = os.listdir(cfg.log_dir)[0]
    assert os.path.exists(os.path.join(cfg.log_dir, run, "val_0000001.png"))
    ckpt = os.path.join(cfg.save_path, "nerf_model_000002")
    cfg_path = str(tmp_path / "llff.txt")
    with open(cfg_path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in dataclasses.asdict(cfg).items()))

    out = str(tmp_path / "frames")
    eval_main(["--config", cfg_path, "--checkpoint", ckpt, "--output", out,
               "--device", "cpu"], **QUIET)
    svc = RenderService.from_checkpoint(cfg_path, ckpt, device="cpu", **QUIET)
    data = load_llff(scene["base"], factor=1)
    assert np.array_equal(svc.orbit_pose(4), data["render_poses"][4])
    assert sorted(os.listdir(out)) == [f"frame_{i:04d}.png" for i in range(3)]
    for i in range(3):
        want = (svc.render_pose(data["render_poses"][i], key_idx=i) * 255).astype(np.uint8)
        assert np.array_equal(read_png(os.path.join(out, f"frame_{i:04d}.png")), want)

    out = str(tmp_path / "scores")
    eval_main(["--config", cfg_path, "--checkpoint", ckpt, "--output", out, "--metrics",
               "--device", "cpu"], **QUIET)
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    assert m["num_views"] == 2 and [v["view"] for v in m["views"]] == [0, 1]
    for v, i in zip(m["views"], data["i_test"]):
        pred = svc.render_pose(data["poses"][i], key_idx=v["view"])
        mse = float(np.mean((pred - data["images"][i]) ** 2))
        assert v["mse"] == mse and v["psnr"] == float(mse_to_psnr(mse))
        assert np.isfinite(v["ssim"])


def test_world_rays_service_takes_the_depth_bounds(scene, tmp_path):
    """Without NDC the service samples world rays over the scene's depth
    bounds (nerf_tpu's near_world / far_world), normalised, and renders a
    finite image of the spiral's first pose."""
    cfg = _cfg(scene["base"], ndc=False)
    ckpt = save_checkpoint(NeRFModel(hidden_dim=32), None, str(tmp_path), "nerf", 1)
    svc = RenderService.from_checkpoint(cfg, ckpt, device="cpu", **QUIET)
    want = jax_load_llff(scene["base"], factor=1)
    assert not svc.ndc
    assert (svc.cfg.near, svc.cfg.far) == (want["near_world"], want["far_world"])
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
