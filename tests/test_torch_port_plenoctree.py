"""The PlenOctrees slice of nerf_tpu_torch against nerf_tpu on the CPU:
``PlenOctreeModel`` (sigma, SH coefficients, rgb) in float32 and bfloat16,
the converter, the bake into a Plenoxels grid (its raw density channel
included), ``to_octree`` / ``from_octree``, the routes, three Adam steps
against the JAX step, ``build_renderer(bake=8)`` against nerf_tpu's, and
``fit`` with a resume and a baked service.

Inputs come from numpy seeds and go through both packages, at hidden 32,
L = 4, SH degree 2 (28 channels) and a 16^3 grid. Each test states its
tolerance.
"""

from __future__ import annotations

import dataclasses
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.models.plenoctree import PlenOctreeModel as JaxPlenOctree
from nerf_tpu.models.plenoctree import from_octree as jax_from_octree
from nerf_tpu.models.plenoctree import to_octree as jax_to_octree
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.serve import build_renderer as jax_build_renderer
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.convert import export_jax_params, load_jax_params
from nerf_tpu_torch.models.plenoctree import PlenOctreeModel, from_octree, to_octree
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, PlenoxelsPack, softplus
from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.serve import RenderService, build_renderer
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState
from nerf_tpu_torch.train.step import _kernel_route, _make_step_body, fused_field_for
from nerf_tpu_torch.utils.checkpoint import read_metadata

NEAR, FAR = 2.0, 6.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = (-2.75, -1.25)     # grid_domain of the default config
SMALL = dict(hidden_dim=32, pos_encoding_dim=4)
# float32: the same products summed in another order; bfloat16: an
# activation can round to the other bf16 neighbour (tests/
# test_torch_port_model.py's _TOL)
_TOL = {"float32": 2e-5, "bfloat16": 5e-3}


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cdt="float32", seed=0, use_grid_kernel=True):
    jm = JaxPlenOctree(compute_dtype=cdt, use_grid_kernel=use_grid_kernel, domain=DOMAIN,
                       **SMALL)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tm = PlenOctreeModel(compute_dtype=cdt, use_grid_kernel=use_grid_kernel, domain=DOMAIN,
                         **SMALL)
    load_jax_params(tm, params)
    return jm, params, tm


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_plenoctree_module_matches_jax(cdt):
    """sh_field (sigma, sh (N, 3, 9)) and the module's rgb and sigma on 200
    points in [-1, 1]^3 with unit directions, against nerf_tpu with the same
    weights: within _TOL[cdt], absolute (measured 6e-8 in float32, 0 in
    bfloat16)."""
    jm, params, tm = _pair(cdt, seed=1)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    dirs = _unit(rng, 200)
    sj, shj = jm.sh_field(params, jnp.asarray(pts))
    rj, sj2 = jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        st, sht = tm.sh_field(_t(pts))
        rt, st2 = tm(_t(pts), _t(dirs))
    assert sht.shape == (200, 3, 9)
    for got, want in ((st, sj), (sht, shj), (rt, rj), (st2, sj2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_TOL[cdt])


def test_init_and_converter():
    """nerf_tpu's tree (leaves and shapes), the density-bias guard, seeded
    init, and an exact round trip through the converter."""
    want = jax.tree.map(np.shape, JaxPlenOctree(**SMALL).init(jax.random.key(0)))
    a = PlenOctreeModel(**SMALL, generator=torch.Generator().manual_seed(4))
    assert jax.tree.map(np.shape, export_jax_params(a)) == want
    assert float(a.head.bias.detach()[0]) == 0.5
    ref = PlenOctreeModel(**SMALL, reference_init=True, generator=torch.Generator().manual_seed(4))
    assert float(ref.head.bias.detach()[0]) != 0.5
    _, params, tm = _pair(seed=2)
    for x, y in zip(jax.tree.leaves(export_jax_params(tm)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_bake_matches_jax(cdt):
    """bake(grid_res=16) over DOMAIN^3 into a port PlenoxelsModel of the
    same layout as nerf_tpu's (grid (16, 16, 16, 28), sh_degree, domain,
    use_grid_kernel; its grid requires no grad): the raw density
    log(expm1(clip(sigma, 1e-8, 1e8))) and the SH channels within
    _TOL[cdt] of nerf_tpu's (measured 2.7e-7 / 1.2e-7 in float32 /
    bfloat16; the density bias
    keeps sigma above 0.5 here). A field of no density (head bias -100)
    bakes to the clip's floor on both sides, log(expm1(1e-8)) ~ -18.42,
    within 1e-5 (measured 0). A field of density ~100 (head bias +100) is
    where the two part: nerf_tpu's float32 expm1 overflows and it stores
    inf, the port stores the limit softplus^-1(sigma) = sigma (within 1e-3
    relative of nerf_tpu's sigma), so that softplus gives sigma back."""
    jm, params, tm = _pair(cdt, seed=3)
    jmodel, jparams = jm.bake(params, grid_res=16)
    baked = tm.bake(grid_res=16)
    assert isinstance(baked, PlenoxelsModel) and not baked.grid.requires_grad
    assert (baked.grid_res, baked.sh_degree, baked.domain, baked.use_grid_kernel) == (
        jmodel.grid_res, jmodel.sh_degree, jmodel.domain, jmodel.use_grid_kernel)
    got, want = baked.grid.detach().numpy(), np.asarray(jparams["grid"])
    assert got.shape == want.shape == (16, 16, 16, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=_TOL[cdt])
    params["head"]["b"] = np.concatenate([[-100.0], params["head"]["b"][1:]]).astype(np.float32)
    load_jax_params(tm, params)
    got = tm.bake(grid_res=4).grid.detach().numpy()[..., 0]
    want = np.asarray(jm.bake(params, grid_res=4)[1]["grid"])[..., 0]
    assert np.allclose(want, -18.42, atol=1e-2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    params["head"]["b"] = np.concatenate([[100.0], params["head"]["b"][1:]]).astype(np.float32)
    load_jax_params(tm, params)
    pts = np.asarray(jm.bake(params, grid_res=4)[1]["grid"])[..., 0]
    got = tm.bake(grid_res=4).grid.detach()[..., 0]
    sigma = np.asarray(jm.sh_field(params, jnp.asarray(np.stack(np.meshgrid(
        *[np.linspace(*DOMAIN, 4, dtype=np.float32)] * 3, indexing="ij"), -1).reshape(-1, 3)))[0])
    assert np.isinf(pts).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(softplus(got).numpy().reshape(-1), sigma, rtol=1e-3, atol=0)


def test_octree_round_trip_matches_jax():
    """to_octree of a 16^3 x 28 grid (half its cells above the threshold)
    equals nerf_tpu's leaf set exactly; from_octree restores the kept
    cells and zeros the pruned ones, as nerf_tpu's; a grid of 12 a side
    is refused."""
    g = np.random.default_rng(5).normal(size=(16, 16, 16, 28)).astype(np.float32)
    mine, ref = to_octree(g, 0.0), jax_to_octree(g, 0.0)
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k])
    back = from_octree(mine)
    np.testing.assert_array_equal(back, np.asarray(jax_from_octree(ref)))
    kept = g[..., 0] > 0.0
    np.testing.assert_array_equal(back[kept], g[kept])
    assert (back[~kept] == 0).all()
    with pytest.raises(AssertionError):
        to_octree(np.zeros((12, 12, 12, 4), np.float32))


def test_routes_follow_nerf_tpu():
    """The live model trains and renders through its module; its bake
    renders through row 18's SH form (FusedGridRender) and trains through
    its module."""
    s = RenderSettings(near=NEAR, far=FAR, num_samples=8)
    m = PlenOctreeModel(**SMALL)
    for for_train in (True, False):
        assert _kernel_route(m, s, True, for_train=for_train) == (None, fused_field_for)
    assert fused_field_for(m) is m
    baked = m.bake(grid_res=4)
    fr, field = _kernel_route(baked, s, True, for_train=False)
    assert type(fr) is FusedGridRender and field is None
    assert _kernel_route(baked, s, True) == (None, fused_field_for)


def test_plenoctree_train_steps_match_jax():
    """Three Adam steps (lr 5e-4) on 32 rays x 16 samples, perturb off,
    coarse only, against nerf_tpu's render_rays + value_and_grad + optax:
    loss and mse within 1e-5 relative (measured 0); fewer than 0.1% of the
    weights further than 0.01 lr from nerf_tpu's and a mean difference
    under 1e-3 lr (measured: max 3.3e-4 lr, mean 6.4e-7 lr in one run, one
    weight at 0.9 lr and mean 2e-4 lr in another: Adam's near-zero
    gradients, as the FastNeRF test says)."""
    jm, params, tm = _pair(seed=6)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, white_background=True)
    lr = 5e-4
    tx = jax_make_optimizer(JaxConfig(learning_rate=lr))
    opt = tx.init((params, {}))
    rng = np.random.default_rng(6)
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (32, 1))
    d = _unit(rng, 32) * 0.3 + np.array([0.0, 0.0, -1.0], np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tgt = rng.uniform(0, 1, (32, 3)).astype(np.float32)

    @jax.jit
    def jax_step(pair, opt):
        def loss_fn(pair):
            out = jax_render_rays(jm.apply, pair[0], jnp.asarray(o), jnp.asarray(d),
                                  jax.random.key(0), JaxSettings(**kw), viewdirs=jnp.asarray(d))
            mse = jnp.mean((out.rgb - jnp.asarray(tgt)) ** 2)
            return mse, mse
        (loss, mse), g = jax.value_and_grad(loss_fn, has_aux=True)(pair)
        upd, opt = tx.update(g, opt, pair)
        return optax.apply_updates(pair, upd), opt, loss, mse

    state = TrainState(step=0, params=tm, fine_params=None,
                       optimizer=make_optimizer(Config(learning_rate=lr), list(tm.parameters())))
    _, train_on_batch = _make_step_body(tm, RenderSettings(**kw), 32, seed=0)
    batch = RayBatch(*(_t(x) for x in (o, d, tgt, d)))
    pair = (jax.tree.map(jnp.asarray, params), {})
    for _ in range(3):
        pair, opt, loss_j, mse_j = jax_step(pair, opt)
        m = train_on_batch(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=1e-5)
    got = jax.tree.leaves(export_jax_params(tm))
    want = jax.tree.leaves(jax.tree.map(np.asarray, pair[0]))
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    far = float(np.mean(diff > 0.01 * lr))
    assert far < 1e-3 and diff.mean() < 1e-3 * lr, (far, diff.max() / lr, diff.mean() / lr)


def _service_cfg(root, **kw):
    return dict(model_type="plenoctree", hidden_dim=32, pos_encoding_dim=4, num_samples=8,
                num_fine_samples=8, perturb=False, chunk_size=64,
                dataset_path=os.path.join(root, "scene"), **kw)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plenoctree"))
    make_synthetic_blender_scene(os.path.join(root, "scene"), h=16, w=16,
                                 num_train=4, num_val=1, num_test=1)
    return root


def test_build_renderer_bake_matches_jax(scene_root):
    """build_renderer(bake=8) of a hierarchical PlenOctree config (8 + 8
    samples, perturb off, a separate fine model, which is baked): the
    render params are the baked grid with its render-time copy made once
    (a PlenoxelsPack), for both passes. Without the kernels (use_pallas =
    false, float32) a 16 x 16 image matches nerf_tpu's within 1e-5 (rgb;
    measured 3.6e-7); with them (tile order, the plain SH form over the
    bfloat16 copy) within mean abs 1e-2 of that."""
    cfg_kw = _service_cfg(scene_root)
    jm = JaxPlenOctree(domain=DOMAIN, use_grid_kernel=False, **SMALL)
    coarse, fine = (jax.tree.map(np.asarray, jm.init(jax.random.key(k))) for k in (7, 8))
    jsettings = JaxSettings(near=NEAR, far=FAR, num_samples=8, num_fine_samples=8,
                            perturb=False, chunk_size=64)
    jr, jp = jax_build_renderer(jm, SimpleNamespace(params=coarse, fine_params=fine),
                                JaxConfig(**cfg_kw, use_pallas=False), jsettings, bake=8,
                                log=lambda *_: None)
    h = w = 16
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    d = np.stack([(jj - w / 2) / 20.0, -(ii - h / 2) / 20.0, -np.ones_like(ii)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(-1, 3).astype(np.float32)
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (h * w, 1))
    ref = jr(jp[0], jp[1], jnp.asarray(o), jnp.asarray(d), jax.random.key(0), hw=(h, w))
    settings = RenderSettings(near=NEAR, far=FAR, num_samples=8, num_fine_samples=8,
                              perturb=False, chunk_size=64)
    rgbs = {}
    for use_pallas in (False, True):
        models = []
        for tree in (coarse, fine):
            m = PlenOctreeModel(domain=DOMAIN, use_grid_kernel=use_pallas, **SMALL)
            load_jax_params(m, tree)
            models.append(m)
        renderer, rp = build_renderer(models[0], models[1], Config(**cfg_kw, use_pallas=use_pallas),
                                      settings, bake=8, log=lambda *_: None)
        assert isinstance(rp[0], PlenoxelsPack) and rp[1] is None
        assert rp[0].model.grid_res == 8 and (rp[0].packed is not None) == use_pallas
        before = FusedGridRender.launches
        rgbs[use_pallas] = renderer(*rp, _t(o), _t(d), hw=(h, w)).rgb.numpy()
        assert FusedGridRender.launches == before
    np.testing.assert_allclose(rgbs[False], np.asarray(ref.rgb), rtol=0, atol=1e-5)
    assert np.abs(rgbs[True] - rgbs[False]).mean() < 1e-2


def _mses(lines) -> dict:
    out = {}
    for line in lines:
        m = re.search(r"\[Iter (\d+)\] LR: \S+ MSE: (\S+)", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def test_fit_resume_and_serve_baked(scene_root):
    """configs/lego.txt with model_type = plenoctree at hidden 32 on a 16x16
    scene: fit logs 8 finite iterations and saves at step 4; a resume from
    step 4 repeats the first run bit for bit; the final checkpoint serves a
    16x16 request on the CPU with bake = 8 (the plain SH form: no launch)."""
    base = parse_config_file(os.path.join(REPO, "configs", "lego.txt"))
    cfg = dataclasses.replace(
        base, **_service_cfg(scene_root), num_random_rays=64, num_iters=8, log_interval=1,
        val_interval=4, save_interval=4, save_path=os.path.join(scene_root, "a"),
        log_dir=os.path.join(scene_root, "logs"))
    lines_a: list = []
    fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(8)) and all(np.isfinite(list(a.values())))
    ckpt = os.path.join(cfg.save_path, "plenoctree_model_000004")
    assert read_metadata(ckpt) == {"step": 4, "model_type": "plenoctree"}
    lines_b: list = []
    fit(dataclasses.replace(cfg, num_iters=7, save_path=os.path.join(scene_root, "b")),
        resume_path=ckpt, device="cpu", log=lines_b.append)
    b = _mses(lines_b)
    assert sorted(b) == [4, 5, 6] and all(b[i] == a[i + 1] for i in b)
    svc = RenderService.from_checkpoint(cfg, os.path.join(cfg.save_path, "plenoctree_model_000008"),
                                        bake=8, device="cpu", log=lambda *_: None)
    assert isinstance(svc.params[0], PlenoxelsPack) and svc.params[0].model.grid_res == 8
    before = FusedGridRender.launches
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert FusedGridRender.launches == before
