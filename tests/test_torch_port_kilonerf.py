"""The KiloNeRF family of nerf_tpu_torch against nerf_tpu: ``remap_domain``,
``grid_domain``, ``voxel_of``, the pointwise and grouped module paths, the
init law, the weight converter (parameters, gradients, Adam moments), train
steps against the JAX step, ``make_eval_render``, ``fit`` (with resume and
``grid_res`` from the checkpoint's metadata) and serving on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX side
runs on the CPU (its Pallas kernels in interpret mode, or its module path);
perturb is off where both sides sample. Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.models.common import remap_domain as jax_remap_domain
from nerf_tpu.models.kilonerf import KiloNeRFModel as JaxKilo
from nerf_tpu.models.registry import grid_domain as jax_grid_domain
from nerf_tpu.ops.pallas.fused_kilonerf import make_fused_kilonerf_apply
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from nerf_tpu.train.step import make_eval_render as jax_eval_render
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.common import remap_domain
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_grads,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.registry import grid_domain, model_from_config
from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import check_ported, fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState, create_train_state
from nerf_tpu_torch.train.step import (
    _make_step_body,
    fused_field_for,
    fused_render_for,
    make_eval_render,
)
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, read_metadata

NEAR, FAR = 2.0, 6.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = (-2.75, -1.25)     # grid_domain of the default config


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cdt="float32", grid=3, hidden=16, lp=4, ld=2, seed=0, domain=(-1.0, 1.0)):
    kw = dict(grid_res=grid, hidden_dim=hidden, pos_encoding_dim=lp,
              dir_encoding_dim=ld, compute_dtype=cdt, domain=domain)
    jm = JaxKilo(**kw)
    params = jm.init(jax.random.key(seed))
    tm = KiloNeRFModel(**kw)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _interior_points(rng, n, grid, domain=(-1.0, 1.0)):
    """Points at least 5% of a voxel away from every face, in ``domain``."""
    cell = rng.integers(0, grid, (n, 3))
    frac = rng.uniform(0.05, 0.95, (n, 3))
    unit = (cell + frac) * (2.0 / grid) - 1.0
    lo, hi = domain
    return ((unit + 1.0) * 0.5 * (hi - lo) + lo).astype(np.float32)


def _dirs(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- domain


@pytest.mark.parametrize("domain", [(-1.0, 1.0), DOMAIN, (0.0, 3.0)])
def test_remap_domain_matches_jax(domain):
    """The same float32 affine map on both sides: bit for bit."""
    p = np.random.default_rng(0).uniform(-4, 4, (64, 3)).astype(np.float32)
    want = np.asarray(jax_remap_domain(jnp.asarray(p), domain))
    np.testing.assert_array_equal(remap_domain(_t(p), domain).numpy(), want)


@pytest.mark.parametrize("kw", [{}, {"scene_bound": 2.5, "near": 1.0, "far": 5.0},
                                {"dataset_type": "llff"},
                                {"dataset_type": "llff", "ndc": False}])
def test_grid_domain_matches_jax(kw):
    assert grid_domain(Config(**kw)) == jax_grid_domain(JaxConfig(**kw))


@pytest.mark.parametrize("grid,domain", [(3, (-1.0, 1.0)), (8, DOMAIN)])
def test_voxel_of_matches_jax(grid, domain):
    """Network ids exactly on 400 points drawn away from the voxel faces;
    the local coordinates within 1e-6 (values in [-1, 1]; the same float32
    arithmetic, in XLA's and torch's order). On 400 points uniform over a
    cube 10% wider than the domain (border voxels, local past [-1, 1]) the
    ids agree on every point of this seed (400 of 400): a point within an
    ulp of a face could land in the neighbour in the other framework."""
    jm = JaxKilo(grid_res=grid, domain=domain)
    tm = KiloNeRFModel(grid_res=grid, hidden_dim=8, pos_encoding_dim=1,
                       dir_encoding_dim=1, domain=domain)
    rng = np.random.default_rng(grid)
    lo, hi = domain
    wide = rng.uniform(lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo), (400, 3))
    for pts, exact in ((_interior_points(rng, 400, grid, domain), True),
                       (wide.astype(np.float32), False)):
        vid_j, loc_j = jm.voxel_of(jnp.asarray(pts))
        vid_t, loc_t = tm.voxel_of(_t(pts))
        np.testing.assert_array_equal(vid_t.numpy(), np.asarray(vid_j))
        np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_j), atol=1e-6)
        assert exact or float(np.abs(np.asarray(loc_j)).max()) > 1.0


# ---------------------------------------------------------------- module


# float32: the same products on both sides up to the order of XLA's and
# torch's sums and an ulp of sin/cos (arguments up to 2^9 at L = 10):
# measured 6e-8 (rgb) / 6e-8 (sigma): 1e-5 / 1e-4. bfloat16: the same
# roundings of the matmul inputs; an ulp of a sine can flip one of them:
# measured 6e-8 / 0: 1e-4 / 1e-3.
_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 1e-3)}
_SHAPES = [(3, 16, 4, 2), (8, 32, 10, 4)]


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["apply_pointwise", "forward"])
def test_kilonerf_module_matches_jax(path, cdt, shape):
    """``apply_pointwise`` against ``KiloNeRFModel.apply_pointwise`` and the
    grouped ``forward`` against ``.apply`` (tile 128 on both sides), on 300
    points (60 of them outside the domain, in border voxels)."""
    grid, hidden, lp, ld = shape
    jm, params, tm = _pair(cdt, grid, hidden, lp, ld, seed=1)
    rng = np.random.default_rng(2)
    pts = np.concatenate([_interior_points(rng, 240, grid),
                          rng.uniform(-1.3, 1.3, (60, 3)).astype(np.float32)])
    dirs = _dirs(rng, 300)
    jfn = jm.apply_pointwise if path == "apply_pointwise" else jm.apply
    rgb_j, sig_j = jfn(params, jnp.asarray(pts), jnp.asarray(dirs))
    tfn = tm.apply_pointwise if path == "apply_pointwise" else tm
    with torch.no_grad():
        rgb_t, sig_t = tfn(_t(pts), _t(dirs))
    tol_rgb, tol_sigma = _TOL[cdt]
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=tol_rgb)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=tol_sigma)


def test_forward_keeps_shape_and_matches_pointwise():
    """(R, S, 3) in, (R, S, 3) / (R, S) out; the grouped path equals the
    pointwise one (float32 sums in another order: 1e-6)."""
    _, _, tm = _pair(seed=3)
    rng = np.random.default_rng(3)
    pts = _t(rng.uniform(-1, 1, (6, 11, 3)).astype(np.float32))
    dirs = _t(_dirs(rng, 66).reshape(6, 11, 3))
    with torch.no_grad():
        rgb, sigma = tm(pts, dirs)
        rgb_p, sigma_p = tm.apply_pointwise(pts, dirs)
    assert rgb.shape == (6, 11, 3) and sigma.shape == (6, 11)
    torch.testing.assert_close(rgb, rgb_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(sigma, sigma_p, atol=1e-6, rtol=0)


def test_init_law_and_density_guard():
    """Each layer's weights and biases of every network lie in
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and fill it (both ends reached,
    mean near 0, variance near bound^2/3 within 5%), as the JAX init's;
    the networks differ; the density bias starts at 0.5 unless
    reference_init; the same generator seed gives the same model."""
    tm = KiloNeRFModel(generator=torch.Generator().manual_seed(3))
    ref = JaxKilo().init(jax.random.key(3))
    for name, fan_in in (("l1", 63), ("l2", 32), ("trunk", 32), ("rgb1", 59), ("rgb2", 32)):
        bound = 1.0 / fan_in ** 0.5
        lyr = tm.layer(name)
        for x in (lyr.w.detach().numpy().ravel(), np.asarray(ref[name]["w"]).ravel()):
            assert np.abs(x).max() <= bound and x.min() < -0.99 * bound
            assert abs(x.mean()) < 0.01 * bound
            assert abs(x.var() / (bound * bound / 3.0) - 1.0) < 0.05
        assert tuple(lyr.w.shape) == np.asarray(ref[name]["w"]).shape
        assert not torch.equal(lyr.w[0], lyr.w[1])
    b = tm.trunk.b.detach()
    assert bool((b[:, -1] == 0.5).all()) and not bool((b[:, 0] == 0.5).any())
    r = KiloNeRFModel(grid_res=2, reference_init=True,
                      generator=torch.Generator().manual_seed(3))
    assert not bool((r.trunk.b.detach()[:, -1] == 0.5).any())
    a = KiloNeRFModel(grid_res=2, generator=torch.Generator().manual_seed(4))
    c = KiloNeRFModel(grid_res=2, generator=torch.Generator().manual_seed(4))
    for x, y in zip(a.parameters(), c.parameters()):
        assert torch.equal(x, y)


def test_convert_round_trip_and_layout():
    _, params, tm = _pair(seed=4)
    back = export_jax_params(tm)
    assert set(back) == {"l1", "l2", "trunk", "rgb1", "rgb2"}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(a, b)
    tm2 = KiloNeRFModel(grid_res=3, hidden_dim=16, pos_encoding_dim=4, dir_encoding_dim=2,
                        generator=torch.Generator().manual_seed(9))
    load_jax_params(tm2, back)
    for (k, v), (k2, v2) in zip(tm.state_dict().items(), tm2.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    assert list(tm.state_dict()) == [f"{k}.{leaf}" for k in ("l1", "l2", "trunk", "rgb1", "rgb2")
                                     for leaf in ("w", "b")]
    with pytest.raises(ValueError, match="l1/w"):
        load_jax_params(KiloNeRFModel(grid_res=2, hidden_dim=16, pos_encoding_dim=4,
                                      dir_encoding_dim=2), back)


def test_convert_grads_and_adam_state_by_name():
    """Gradients of one loss through jax.grad (pointwise path) and torch
    autograd, and one optax Adam step loaded into the port's Adam. JAX
    flattens in sorted-key order (l1, l2, rgb1, rgb2, trunk), the port in
    parameter order (l1, l2, trunk, rgb1, rgb2): the maps go by name.
    float32 gradients to 1e-5 of their max."""
    jm, params, tm = _pair(seed=5)
    rng = np.random.default_rng(5)
    pts, dirs = rng.uniform(-1, 1, (80, 3)).astype(np.float32), _dirs(rng, 80)

    def loss_j(p):
        rgb, sigma = jm.apply_pointwise(p, jnp.asarray(pts), jnp.asarray(dirs))
        return jnp.sum(rgb ** 2) + 0.1 * jnp.sum(sigma)

    g_j = jax.grad(loss_j)(params)
    rgb, sigma = tm.apply_pointwise(_t(pts), _t(dirs))
    (torch.sum(rgb ** 2) + 0.1 * torch.sum(sigma)).backward()
    got = export_jax_grads(tm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g_j)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, {}))
    _, opt = tx.update((g_j, {}), opt, (params, {}))
    adam = make_optimizer(Config(), list(tm.parameters()))
    load_jax_opt_state(adam, opt)
    mu_ref = _flat_in_param_order(jax.tree.map(np.asarray, opt[0].mu[0]))
    nu_ref = _flat_in_param_order(jax.tree.map(np.asarray, opt[0].nu[0]))
    assert adam.count == 1 and len(adam.mu) == len(mu_ref) == 10
    for p, m, n, rm, rn in zip(tm.parameters(), adam.mu, adam.nu, mu_ref, nu_ref):
        assert tuple(p.shape) == tuple(m.shape)
        np.testing.assert_array_equal(m.numpy(), rm)
        np.testing.assert_array_equal(n.numpy(), rn)


def test_model_from_the_kilonerf_config():
    """configs/lego_siren.txt with model_type = kilonerf, hidden_dim = 32,
    grid_res = 8 (bench.py's shape) builds 512 networks of width 32 at
    L = 10/4 over grid_domain = (-2.75, -1.25), bf16; its train state takes
    the field route (no fused render; the field kernels)."""
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt")),
        model_type="kilonerf", hidden_dim=32, grid_res=8)
    m = model_from_config(cfg)
    assert isinstance(m, KiloNeRFModel)
    assert (m.grid_res, m.num_networks, m.hidden_dim, m.pos_in, m.dir_in, m.cdt) == (
        8, 512, 32, 63, 27, torch.bfloat16)
    assert m.domain == DOMAIN == grid_domain(cfg)
    assert model_from_config(dataclasses.replace(cfg, grid_res=0)).grid_res == 8
    assert model_from_config(dataclasses.replace(cfg, grid_res=3)).num_networks == 27
    check_ported(cfg)
    state = create_train_state(dataclasses.replace(cfg, grid_res=2), device="cpu")
    assert isinstance(state.params, KiloNeRFModel) and state.fine_params is None
    with pytest.raises(NotImplementedError, match="no fused render"):
        fused_render_for(state.params, RenderSettings())
    assert type(fused_field_for(state.params)) is KiloNeRFField
    # its teacher, a hidden-32 NeRF, takes no field kernel in nerf_tpu: the module
    teacher = model_from_config(dataclasses.replace(cfg, model_type="nerf"))
    assert fused_field_for(teacher) is teacher


# ---------------------------------------------------------------- renderer


def _rays(rng, num_rays):
    """Camera-like rays from z = 4 toward the origin."""
    ro = (rng.uniform(-0.5, 0.5, (num_rays, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3)) * 0.2 + [0.0, 0.0, -1.0]
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_make_eval_render_matches_jax(cdt):
    """The serving path scaled down: 120 rays in tiles of 64 (the last one
    ragged), 16 samples, perturb off, grid 3, hidden 32, L = 10/4 over the
    default grid_domain; the JAX side through its Pallas field kernels in
    interpret mode, the port through its field route (the kernels' plain
    versions). float32 to 1e-5 (1e-4 on depth/disparity; measured over two
    seeds 4.2e-7 on rgb and 7.9e-6 on depth). bfloat16: the Pallas kernel's
    hi/lo slot sum (~2^-16) and rounding flips: 1e-4 (1e-3; measured 2.7e-5
    and 1.6e-4)."""
    jm, params, tm = _pair(cdt, 3, 32, 10, 4, seed=9, domain=DOMAIN)
    ro, rd = _rays(np.random.default_rng(9), 120)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, chunk_size=64)
    fused = make_fused_kilonerf_apply(jm, tile_fwd=64, tile_bwd=64, interpret=True)
    ref = jax_eval_render(jm, JaxSettings(**kw), apply_fn=fused)(
        params, {}, jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0))
    before = KiloNeRFField.launches
    got = make_eval_render(tm, RenderSettings(**kw))(tm, None, _t(ro), _t(rd))
    assert KiloNeRFField.launches == before                 # CPU: plain
    tol = 1e-5 if cdt == "float32" else 1e-4
    for name in ("rgb", "depth", "acc", "rgb_coarse", "disparity"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = 10.0 if name in ("depth", "disparity") else 1.0
        np.testing.assert_allclose(a, b, atol=tol * scale, err_msg=name)


def test_eval_render_module_route_matches_field_route():
    """use_pallas = false renders through the module's grouped forward:
    float32 within 1e-5 of the field route on rgb, 1e-4 on depth (the
    cosine as sin(x + pi/2) in the field's encoding; measured 1.2e-7 and
    4.8e-7)."""
    _, _, tm = _pair("float32", 3, 32, 10, 4, seed=10, domain=DOMAIN)
    ro, rd = _rays(np.random.default_rng(10), 50)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, chunk_size=64)
    a = make_eval_render(tm, RenderSettings(**kw))(tm, None, _t(ro), _t(rd))
    b = make_eval_render(tm, RenderSettings(**kw), fused=False)(tm, None, _t(ro), _t(rd))
    torch.testing.assert_close(a.rgb, b.rgb, atol=1e-5, rtol=0)
    torch.testing.assert_close(a.depth, b.depth, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- train


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_kilonerf_train_steps_match_jax(cdt):
    """Three coarse-only steps, 32 rays x 16 samples, perturb off, grid 3,
    hidden 32, L = 10/4: the JAX side is render_rays on the Pallas field
    kernels (interpret mode, the default experts per step) + value_and_grad
    + optax; the port's is its train step (the field route) on an injected
    batch. Loss and mse within 1e-5 (f32) / 1e-4 (bf16) relative (measured
    2.6e-7 / 4.4e-6). Parameters: Adam moves each by at most lr = 5e-4 per
    step whatever the gradient's size, so an element whose gradient is near
    zero and of another sign in the two frameworks moves by up to 2 lr per
    step: 6 lr after three steps (measured worst 0.15 lr f32, 2.0 lr bf16),
    and the mean difference of each tensor under 0.05 lr (measured 6e-5 lr
    and 3e-3 lr)."""
    jm, params, tm = _pair(cdt, 3, 32, 10, 4, seed=11, domain=DOMAIN)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, white_background=True)
    fused = make_fused_kilonerf_apply(jm, tile_fwd=64, tile_bwd=64, interpret=True)
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, {}))
    rng = np.random.default_rng(11)
    ro, rd = _rays(rng, 32)
    tgt = rng.uniform(0, 1, (32, 3)).astype(np.float32)

    @jax.jit
    def jax_step(pair, opt):
        def loss_fn(pair):
            out = jax_render_rays(fused, pair[0], jnp.asarray(ro), jnp.asarray(rd),
                                  jax.random.key(0), JaxSettings(**kw),
                                  viewdirs=jnp.asarray(rd))
            mse = jnp.mean((out.rgb - jnp.asarray(tgt)) ** 2)
            return mse, mse
        (loss, mse), g = jax.value_and_grad(loss_fn, has_aux=True)(pair)
        upd, opt = tx.update(g, opt, pair)
        return optax.apply_updates(pair, upd), opt, loss, mse

    state = TrainState(step=0, params=tm, fine_params=None,
                       optimizer=make_optimizer(Config(), list(tm.parameters())))
    _, train_on_batch = _make_step_body(state.params, RenderSettings(**kw), 32, seed=0)
    batch = RayBatch(*(_t(x) for x in (ro, rd, tgt, rd)))
    pair = (params, {})
    tol = 1e-5 if cdt == "float32" else 1e-4
    for _ in range(3):
        pair, opt, loss_j, mse_j = jax_step(pair, opt)
        m = train_on_batch(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=tol)
        np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=tol)
    assert state.step == 3 and state.optimizer.count == 3
    lr = 5e-4
    for a, b in zip(_flat_in_param_order(export_jax_params(state.params)),
                    _flat_in_param_order(jax.tree.map(np.asarray, pair[0]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=6 * lr)
        assert np.abs(a - b).mean() < 0.05 * lr, np.abs(a - b).mean() / lr


# ---------------------------------------------------------------- fit


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kilonerf_fit"))
    make_synthetic_blender_scene(os.path.join(root, "scene"), h=16, w=16,
                                 num_train=4, num_val=1, num_test=1)
    return root


def _mses(lines) -> dict:
    out = {}
    for line in lines:
        m = re.search(r"\[Iter (\d+)\] LR: \S+ MSE: (\S+)", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def _kilo_cfg(root, **kw):
    base = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    opts = dict(model_type="kilonerf", hidden_dim=32, grid_res=3,
                dataset_path=os.path.join(root, "scene"), num_random_rays=64,
                chunk_size=128, num_samples=8, learning_rate=5e-3, num_iters=21,
                log_interval=1, val_interval=10, save_interval=10,
                save_path=os.path.join(root, "a"), log_dir=os.path.join(root, "logs"))
    opts.update(kw)
    return dataclasses.replace(base, **opts)


def test_fit_resume_and_serve_kilonerf(scene_root):
    """The kilonerf config (lego_siren.txt with model_type = kilonerf,
    hidden 32) at grid 3 on a 16x16 scene, bf16, the field route: fit saves
    (grid_res in the metadata), validates and learns; a resume from the
    step-10 checkpoint under a config whose grid_res differs restores 3
    from the metadata and repeats the first run bit for bit; the final
    checkpoint serves a request through RenderService on the CPU."""
    cfg = _kilo_cfg(scene_root)
    lines_a: list = []
    state_a = fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(21)) and all(np.isfinite(list(a.values())))
    assert np.mean([a[i] for i in range(16, 21)]) < 0.9 * a[0]
    assert sum("[Validation Step]" in line for line in lines_a) == 2
    ckpt = os.path.join(cfg.save_path, "kilonerf_model_000010")
    meta = read_metadata(ckpt)
    assert meta == {"step": 10, "model_type": "kilonerf", "grid_res": 3}
    assert load_checkpoint(ckpt)["fine_params"] == {}
    lines_b: list = []
    cfg_b = dataclasses.replace(cfg, num_iters=20, model_type="nerf", grid_res=5,
                                save_path=os.path.join(scene_root, "b"))
    state_b = fit(cfg_b, resume_path=ckpt, device="cpu", log=lines_b.append)
    assert isinstance(state_b.params, KiloNeRFModel) and state_b.params.grid_res == 3
    b = _mses(lines_b)
    assert sorted(b) == list(range(10, 20))
    for i in b:
        assert b[i] == a[i + 1], i
    for (k, x), (_, y) in zip(state_b.params.state_dict().items(),
                              state_a.params.state_dict().items()):
        assert torch.equal(x, y), k
    with open(os.path.join(cfg_b.save_path, "kilonerf_model_000020.meta.json")) as f:
        assert json.load(f)["grid_res"] == 3
    final = os.path.join(cfg.save_path, "kilonerf_model_000021")
    svc = RenderService.from_checkpoint(dataclasses.replace(cfg, model_type="nerf", grid_res=6),
                                        final, device="cpu", log=lambda *_: None)
    assert svc.cfg.model_type == "kilonerf" and svc.params[0].grid_res == 3
    before = KiloNeRFField.launches
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert KiloNeRFField.launches == before
