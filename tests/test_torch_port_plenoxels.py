"""The Plenoxels slice of nerf_tpu_torch against nerf_tpu on the CPU: the SH
basis, ``trilinear`` (values, grid and point gradients), the plain
versions of the three grid kernels (``scatter_add_rows``,
``trilinear_rays``, the fused grid render) against the Pallas kernels in
interpret mode, ``PlenoxelsModel`` (``apply``, ``tv``, ``upsample``), the
weight converter, the routes, three Adam steps with the TV prior against
the JAX step, ``make_eval_render`` with tile order, and ``fit`` with an
upsample schedule, a resume and serving.

Inputs come from numpy seeds and go through both packages; grids are 8 or
16 cells a side. Each test states its tolerance.
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
from nerf_tpu.models.plenoxels import PlenoxelsModel as JaxPlenoxels
from nerf_tpu.models.plenoxels import sh_basis as jax_sh_basis
from nerf_tpu.ops.interp import trilinear as jax_trilinear
from nerf_tpu.ops.pallas.fused_grid import tile_ray_order as jax_tile_ray_order
from nerf_tpu.ops.pallas.fused_grid import trilinear_rays as jax_trilinear_rays
from nerf_tpu.ops.pallas.fused_grid_render import make_fused_grid_render as jax_grid_render
from nerf_tpu.ops.pallas.scatter_add import scatter_add_rows as jax_scatter_add_rows
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.train.loop import make_regularizer as jax_make_regularizer
from nerf_tpu.train.loop import parse_upsample_steps as jax_parse_upsample_steps
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from nerf_tpu.train.step import make_eval_render as jax_eval_render
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_grads,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, sh_basis
from nerf_tpu_torch.models.registry import model_from_config
from nerf_tpu_torch.ops.cuda.fused_grid import (
    GridKernel, cells_of, interp_cells_plain, tile_ray_order, trilinear_rays)
from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender, make_fused_grid_render
from nerf_tpu_torch.ops.cuda.scatter_add import ScatterKernel, scatter_add_rows
from nerf_tpu_torch.ops.interp import trilinear
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import fit, make_regularizer, parse_upsample_steps
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState
from nerf_tpu_torch.train.step import (
    _kernel_route,
    _make_step_body,
    fused_field_for,
    make_eval_render,
    train_field,
)
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, read_metadata

NEAR, FAR = 2.0, 6.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = (-2.75, -1.25)     # grid_domain of the default config


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(r, seed, interp_dtype="float32", domain=DOMAIN, use_grid_kernel=True):
    """A JAX and a port model of one random grid (raw values N(0, 0.5))."""
    jm = JaxPlenoxels(grid_res=r, interp_dtype=interp_dtype, domain=domain,
                      use_grid_kernel=use_grid_kernel)
    grid = np.random.default_rng(seed).normal(
        scale=0.5, size=(r, r, r, jm.channels)).astype(np.float32)
    tm = PlenoxelsModel(grid_res=r, interp_dtype=interp_dtype, domain=domain,
                        use_grid_kernel=use_grid_kernel)
    load_jax_params(tm, {"grid": grid})
    return jm, {"grid": jnp.asarray(grid)}, tm


def _bundle(rng, n, s, spread=0.01):
    """A tight bundle of camera rays from (0, 0, 4) towards the origin and
    sorted t in [2.5, 5.5]: spatially coherent, so the Pallas kernels' plan
    fits (their window) and the kernel path runs."""
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (n, 1))
    d = np.array([0.0, 0.0, -1.0]) + spread * rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = (np.linspace(2.5, 5.5, s, dtype=np.float32)[None].repeat(n, 0)
         + (1.5 / s) * rng.uniform(size=(n, s)).astype(np.float32))
    return o, d, t


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_sh_basis_matches_jax(degree):
    """The same constants and float32 products: to 1e-7."""
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jax_sh_basis(jnp.asarray(d), degree))
    got = sh_basis(_t(d), degree).numpy()
    assert got.shape == want.shape == (64, (degree + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("extent", [0.9, 1.3])
def test_trilinear_values_and_gradients_match_jax(extent):
    """500 points uniform over [-extent, extent]^3 of an 8^3 x 28 grid
    (1.3: a quarter of the points clamp to the border): values within 1e-6
    (measured 3.6e-7: the port sums the 8 corners with the weight
    (wx wy) wz, nerf_tpu a z-lerp of pairs); the grid gradient (the
    scatter-add of the 8 corner rows, summed in the sorted order) within
    1e-6 of its max, the point gradient within 1e-5 of its max (values to
    70; measured 1.1e-5 absolute), zero where the clamp is active, against
    jax.vjp."""
    rng = np.random.default_rng(int(extent * 10))
    g = rng.normal(size=(8, 8, 8, 28)).astype(np.float32)
    p = rng.uniform(-extent, extent, (500, 3)).astype(np.float32)
    cot = rng.normal(size=(500, 28)).astype(np.float32)
    ref, vjp = jax.vjp(jax_trilinear, jnp.asarray(g), jnp.asarray(p))
    gg, gp = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    tg, tp = _t(g).requires_grad_(), _t(p).requires_grad_()
    out = trilinear(tg, tp)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), gg, rtol=0, atol=1e-6 * np.abs(gg).max())
    np.testing.assert_allclose(tp.grad.numpy(), gp, rtol=0, atol=1e-5 * np.abs(gp).max())
    outside = (np.abs(p) >= 1.0)
    assert (tp.grad.numpy()[outside] == 0).all() and outside.any() == (extent > 1)


@pytest.mark.parametrize("c", [1, 25, 28, 32])
def test_interp_cells_plain_matches_jax_trilinear(c):
    """Row 17's plain version (the float32 arithmetic of
    csrc/grid_common.cuh, which the kernel holds bit for bit) at every
    channel count the kernel's dispatch has in use or at its ends (1, the
    baked FastNeRF cache's 25, Plenoxels' 28, 32): 600 points (not a whole
    number of the kernel's 128-point CTAs) over [-1.2, 1.2]^3 of a 6^3 x C
    grid against nerf_tpu's trilinear, within 1e-6 as the 28-channel test
    above (the port weights (wx wy) wz, nerf_tpu lerps pairs)."""
    rng = np.random.default_rng(c)
    g = rng.normal(size=(6, 6, 6, c)).astype(np.float32)
    p = rng.uniform(-1.2, 1.2, (600, 3)).astype(np.float32)
    want = np.asarray(jax_trilinear(jnp.asarray(g), jnp.asarray(p)))
    got = interp_cells_plain(_t(g), cells_of(_t(p), 6)).numpy()
    assert got.shape == want.shape == (600, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["uniform", "duplicates", "one_row"])
def test_scatter_add_plain_matches_pallas(case):
    """The plain scatter-add (stable sort, each run summed in order) against
    nerf_tpu's sorted-window Pallas kernel in interpret mode, 2,048 rows of
    28 floats into 300 rows: uniform ids, ids from 20 values, and one id
    (a single run of 2,048). Both sum in another order than the other:
    1e-5 of the largest row sum (measured 1.9e-6 absolute)."""
    rng = np.random.default_rng({"uniform": 0, "duplicates": 1, "one_row": 2}[case])
    m = 2048
    ids = {"uniform": rng.integers(0, 300, m),
           "duplicates": rng.choice(rng.integers(0, 300, 20), m),
           "one_row": np.full(m, 123)}[case].astype(np.int32)
    vals = rng.normal(size=(m, 28)).astype(np.float32)
    want = np.asarray(jax_scatter_add_rows(jnp.asarray(ids), jnp.asarray(vals), 300,
                                           interpret=True, force=True))
    got = scatter_add_rows(_t(ids), _t(vals), 300).numpy()
    assert got.shape == (300, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    untouched = np.setdiff1d(np.arange(300), ids)
    assert (got[untouched] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trilinear_rays_plain_matches_pallas(dtype):
    """64 coherent rays x 32 samples of a 16^3 x 28 grid: the plain version
    against nerf_tpu's trilinear_rays kernel in interpret mode. float32:
    1e-6 (measured 1.8e-7); bfloat16, the weights rounded after (wx wy) wz
    and the bfloat16 copy's rows: 1e-6 (measured 1.2e-7), while both sit
    2^-8-relative away from the float32 values (checked above 1e-3, so the
    comparison is not float32 against float32)."""
    rng = np.random.default_rng(4)
    g = rng.normal(scale=0.5, size=(16, 16, 16, 28)).astype(np.float32)
    o, d, t = _bundle(rng, 64, 32)
    pts = (o[:, None] + t[..., None] * d[:, None]) / 4.0 - np.array([0, 0, 0.2], np.float32)
    pts = pts.astype(np.float32)
    want = np.asarray(jax_trilinear_rays(jnp.asarray(g), jnp.asarray(pts), dtype=dtype,
                                         force=True, interpret=True))
    got = trilinear_rays(_t(g), _t(pts), dtype=dtype).numpy()
    assert got.shape == (64, 32, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = np.asarray(jax_trilinear(jnp.asarray(g), jnp.asarray(pts.reshape(-1, 3))))
    gap = np.abs(got.reshape(-1, 28) - exact).max()
    assert (gap > 1e-3) == (dtype == "bfloat16"), gap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_grid_render_plain_matches_pallas(dtype):
    """100 coherent rays x 24 samples (ragged against the TPU kernel's 64-ray
    tiles and 8-sample segments) of a 16^3 x 28 grid over the default
    grid_domain: the plain version against make_fused_grid_render in
    interpret mode. float32 within 2e-5 (depth 4e-4, as
    tests/test_grid_render_kernel.py; measured 2.4e-7 / 1.2e-6); bfloat16
    within 2e-5 (depth 4e-4; measured 4.3e-6 / 2.9e-6)."""
    jm, params, tm = _pair(16, 3, dtype)
    rng = np.random.default_rng(5)
    o, d, t = _bundle(rng, 100, 24)
    fr = jax_grid_render(jm, NEAR, FAR, normalize=True, interpret=True, force=True)
    ref = jax.jit(fr)(params, *(jnp.asarray(x) for x in (o, d, d, t)))
    tfr = make_fused_grid_render(tm, NEAR, FAR)
    before = FusedGridRender.launches
    with torch.no_grad():
        got = tfr(tfr.pack(tm), _t(o), _t(d), _t(d), _t(t))
    assert FusedGridRender.launches == before                   # CPU: plain
    for k in ("rgb", "acc", "depth", "weights"):
        assert got[k].shape == ref[k].shape, k
        atol = 4e-4 if k == "depth" else 2e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    with pytest.raises(NotImplementedError, match="eval-only"):
        tfr(tm, _t(o), _t(d), _t(d), _t(t))


def test_tile_ray_order_matches_jax():
    for h, w in ((16, 16), (13, 21)):
        np.testing.assert_array_equal(tile_ray_order(h, w), jax_tile_ray_order(h, w))


# ---------------------------------------------------------------- model


def test_plenoxels_apply_tv_and_upsample_match_jax():
    """A 8^3 grid over the default grid_domain. apply on (R, S, 3) points
    (the row-17 path) and on flat points (trilinear): float32 within 1e-6
    (rgb) and 1e-5 (sigma; measured 6e-8 / 2.4e-7); in bfloat16 eval mode
    (no gradient) within 5e-3 of nerf_tpu's float32 (its CPU path; the
    bfloat16 rows and weights, 2^-8 relative of values to 2). tv within
    1e-4 relative (means of 10^4 squares summed in another order; measured
    1.5e-5); upsample to 12^3 within 5e-6 (torch and XLA linspace differ in
    the last bit, ~6e-8, which the grid's slopes of up to ~10 a unit carry
    into the values; measured 1.5e-6)."""
    jm, params, tm = _pair(8, 6)
    rng = np.random.default_rng(6)
    o, d, t = _bundle(rng, 20, 16, spread=0.2)
    pts = (2.0 * ((o[:, None] + t[..., None] * d[:, None]) - NEAR) / (FAR - NEAR) - 1.0)
    pts = pts.astype(np.float32)
    dirs = np.broadcast_to(d[:, None], pts.shape).copy()
    jr, js = jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    for shape in (pts.shape, (-1, 3)):
        with torch.no_grad():
            r32, s32 = PlenoxelsModel.apply(tm, _t(pts).reshape(shape), _t(dirs).reshape(shape))
        np.testing.assert_allclose(r32.numpy().reshape(jr.shape), np.asarray(jr), atol=1e-6)
        np.testing.assert_allclose(s32.numpy().reshape(js.shape), np.asarray(js), atol=1e-5)
    tm.interp_dtype = "bfloat16"
    with torch.no_grad():
        rb, sb = tm(_t(pts), _t(dirs))
    rg, sg = tm(_t(pts), _t(dirs))                   # gradients flow: float32
    np.testing.assert_allclose(rb.numpy(), np.asarray(jr), atol=5e-3)
    np.testing.assert_allclose(sb.numpy(), np.asarray(js), atol=5e-3)
    assert np.abs(rb.numpy() - np.asarray(jr)).max() > 1e-6
    np.testing.assert_allclose(rg.detach().numpy(), np.asarray(jr), atol=1e-6)
    for a, b in zip(tm.tv(), jm.tv(params)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    up = tm.upsample(12)
    want = np.asarray(jm.upsample(params, 12)["grid"])
    assert up.shape == (12, 12, 12, 28)
    np.testing.assert_allclose(up.numpy(), want, rtol=0, atol=5e-6)


def test_init_convert_and_adam_state():
    """The init (softplus^-1(0.1) in the density channel, zeros elsewhere;
    all zeros with reference_init) equals nerf_tpu's; the converter carries
    the grid both ways, its gradient (a TV loss) and optax's Adam moments
    exactly (the same float32 arithmetic: 1e-7)."""
    for ref_init in (False, True):
        want = np.asarray(JaxPlenoxels(grid_res=4, reference_init=ref_init)
                          .init(jax.random.key(0))["grid"])
        got = PlenoxelsModel(grid_res=4, reference_init=ref_init).grid.detach().numpy()
        np.testing.assert_array_equal(got, want)
    jm, params, tm = _pair(4, 7)
    np.testing.assert_array_equal(export_jax_params(tm)["grid"], np.asarray(params["grid"]))

    def loss_j(p):
        a, b = jm.tv(p)
        return 2.0 * a + b

    g_j = jax.grad(loss_j)(params)
    a, b = tm.tv()
    (2.0 * a + b).backward()
    np.testing.assert_allclose(export_jax_grads(tm)["grid"], np.asarray(g_j["grid"]),
                               rtol=0, atol=1e-7)
    tx = jax_make_optimizer(JaxConfig(learning_rate=0.01))
    opt = tx.init((params, {}))
    _, opt = tx.update((g_j, {}), opt, (params, {}))
    adam = make_optimizer(Config(learning_rate=0.01), list(tm.parameters()))
    load_jax_opt_state(adam, opt)
    assert adam.count == 1 and len(adam.mu) == 1
    np.testing.assert_array_equal(adam.mu[0].numpy(),
                                  _flat_in_param_order({"grid": opt[0].mu[0]["grid"]})[0])


def test_routes_follow_nerf_tpu():
    """Eval takes the fused grid render (eval-only), training the module
    through its grid kernel; fused_field_for gives the module (no field
    kernel, no raise); use_pallas = false (use_grid_kernel false) takes the
    module everywhere; a config builds the model with the config's grid_res
    (0: the default 128) and use_pallas; a model that is no grid cache gets
    no fused grid render (None, as from nerf_tpu's factory)."""
    s = RenderSettings(near=NEAR, far=FAR, num_samples=8)
    m = PlenoxelsModel(grid_res=4)
    fr, field = _kernel_route(m, s, True, for_train=False)
    assert isinstance(fr, FusedGridRender) and field is None
    assert _kernel_route(m, s, True) == (None, fused_field_for)
    assert fused_field_for(m) is m and train_field(m, s, True) is m
    off = PlenoxelsModel(grid_res=4, use_grid_kernel=False)
    assert _kernel_route(off, s, True, for_train=False) == (None, fused_field_for)
    assert _kernel_route(m, s, False, for_train=False) == (None, None)
    cfg = Config(model_type="plenoxels", grid_res=6, use_pallas=False)
    built = model_from_config(cfg)
    assert (built.grid_res, built.use_grid_kernel, built.domain) == (6, False, DOMAIN)
    assert model_from_config(Config(model_type="plenoxels", grid_res=0)).grid_res == 128
    assert make_fused_grid_render(object(), NEAR, FAR) is None


def test_regularizer_and_upsample_schedule_match_jax():
    """make_regularizer's value over the (coarse, fine) models and
    parse_upsample_steps' schedules and refusals, as nerf_tpu's (TV to 1e-5
    relative)."""
    jm, params, tm = _pair(6, 8)
    for kw in ({}, {"tv_lambda": 0.5}, {"tv_lambda": 1e-3, "tv_sh_lambda": 0.2}):
        reg_j = jax_make_regularizer(JaxConfig(**kw), jm)
        reg = make_regularizer(Config(**kw), tm)
        assert (reg is None) == (reg_j is None)
        if reg is not None:
            state = TrainState(step=0, params=tm, fine_params=tm, optimizer=None)
            np.testing.assert_allclose(float(reg(state)), float(reg_j((params, params))),
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="TV"):
        make_regularizer(Config(tv_lambda=0.1), torch.nn.Linear(2, 2))
    for spec in ("", "50:128", "20:32, 100:64"):
        assert parse_upsample_steps(spec) == jax_parse_upsample_steps(spec)
    for bad in ("5", "0:16", "10:32,5:64", "10:32,20:16"):
        with pytest.raises(ValueError):
            parse_upsample_steps(bad)


# ---------------------------------------------------------------- train


def test_plenoxels_train_steps_with_tv_match_jax():
    """Three Adam steps (lr 0.01) with tv_lambda 1e-2 and tv_sh_lambda 1e-1
    on 32 rays x 16 samples (perturb off: the midpoint t on both sides), an
    8^3 grid: nerf_tpu's render_rays on the module (its exact float32 path)
    + the regularizer + value_and_grad + optax, against the port's train
    step (trilinear_rays in float32, the scatter-add backward). Loss and mse
    within 1e-5 relative; the grid within 0.05 lr of nerf_tpu's after three
    steps and the mean difference under 1e-5 lr (measured 5.0e-3 lr and
    8.8e-7 lr): Adam divides each gradient by its own root mean square, so
    an element whose gradient is a few ulps from zero (a corner touched by
    one sample at a tiny weight, TV's share near balance) moves by a
    visible part of lr when the two frameworks round it differently."""
    jm, params, tm = _pair(8, 9, use_grid_kernel=False)
    tm.use_grid_kernel = True
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, white_background=True)
    cfg_kw = dict(learning_rate=0.01, tv_lambda=1e-2, tv_sh_lambda=1e-1)
    tx = jax_make_optimizer(JaxConfig(**cfg_kw))
    reg_j = jax_make_regularizer(JaxConfig(**cfg_kw), jm)
    opt = tx.init((params, {}))
    rng = np.random.default_rng(9)
    o, d, _ = _bundle(rng, 32, 4, spread=0.3)
    tgt = rng.uniform(0, 1, (32, 3)).astype(np.float32)

    @jax.jit
    def jax_step(pair, opt):
        def loss_fn(pair):
            out = jax_render_rays(jm.apply, pair[0], jnp.asarray(o), jnp.asarray(d),
                                  jax.random.key(0), JaxSettings(**kw),
                                  viewdirs=jnp.asarray(d))
            mse = jnp.mean((out.rgb - jnp.asarray(tgt)) ** 2)
            return mse + reg_j(pair), mse
        (loss, mse), g = jax.value_and_grad(loss_fn, has_aux=True)(pair)
        upd, opt = tx.update(g, opt, pair)
        return optax.apply_updates(pair, upd), opt, loss, mse

    cfg = Config(**cfg_kw)
    state = TrainState(step=0, params=tm, fine_params=None,
                       optimizer=make_optimizer(cfg, list(tm.parameters())))
    _, train_on_batch = _make_step_body(tm, RenderSettings(**kw), 32, seed=0,
                                        regularizer=make_regularizer(cfg, tm))
    batch = RayBatch(*(_t(x) for x in (o, d, tgt, d)))
    pair = (params, {})
    launches = (GridKernel.launches, ScatterKernel.launches)
    for _ in range(3):
        pair, opt, loss_j, mse_j = jax_step(pair, opt)
        m = train_on_batch(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=1e-5)
    assert (GridKernel.launches, ScatterKernel.launches) == launches      # CPU: plain
    lr = 0.01
    diff = np.abs(tm.grid.detach().numpy() - np.asarray(pair[0]["grid"]))
    assert diff.max() < 0.05 * lr and diff.mean() < 1e-5 * lr, (diff.max() / lr,
                                                                diff.mean() / lr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_eval_render_with_tile_order_matches_jax(dtype):
    """A 16 x 8 image of rays from (0, 0, 4) (128 rays in tiles of 64, 16
    samples, perturb off) over a 16^3 grid: nerf_tpu's make_eval_render
    with its fused grid render in interpret mode and hw (tile order), the
    port's with hw (tile order, the plain render). rgb, acc within 2e-5 in
    float32 (depth 4e-4; measured 3.6e-7); bfloat16 within 5e-3 (a chunk
    whose samples outgrow the TPU kernel's window takes its float32 path;
    depth 5e-2). The port's render with and without hw agree to 1e-6:
    tile order is neutral to each ray."""
    jm, params, tm = _pair(16, 10, dtype)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, chunk_size=64)
    h, w = 16, 8
    focal = 20.0
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    d = np.stack([(jj - w / 2) / focal, -(ii - h / 2) / focal, -np.ones_like(ii)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(-1, 3).astype(np.float32)
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (h * w, 1))
    fr = jax_grid_render(jm, NEAR, FAR, normalize=True, interpret=True, force=True)
    ref = jax_eval_render(jm, JaxSettings(**kw), apply_fn=jm.apply, fused_render=fr)(
        params, {}, jnp.asarray(o), jnp.asarray(d), jax.random.key(0), hw=(h, w))
    render = make_eval_render(tm, RenderSettings(**kw))
    got = render(tm, None, _t(o), _t(d), hw=(h, w))
    flat = render(tm, None, _t(o), _t(d))
    tol = 2e-5 if dtype == "float32" else 5e-3
    for name in ("rgb", "acc", "depth"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = 20.0 if name == "depth" else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)
        np.testing.assert_allclose(a, getattr(flat, name).numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plenoxels_fit"))
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


def test_fit_upsample_resume_and_serve(scene_root):
    """The plenoxels config (lego_siren.txt with model_type = plenoxels,
    learning_rate = 0.01) at grid_res 8 with tv_lambda 1e-4, tv_sh_lambda
    1e-3 and upsample_steps = "6:12" on a 16x16 scene: fit logs 14 finite
    iterations and learns, upsamples before iteration 6 (the log says so),
    saves grid_res 12 at step 10 and at the end; a resume from the step-10
    checkpoint under a config of grid_res 8 restores the 12^3 grid (the
    schedule's entry drops out) and repeats the first run bit for bit; the
    final checkpoint serves a 16x16 request on the CPU (tile order, the
    plain fused grid render), also with a 6^3 occupancy prior baked
    through the module."""
    base = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    cfg = dataclasses.replace(
        base, model_type="plenoxels", learning_rate=0.01, grid_res=8, tv_lambda=1e-4,
        tv_sh_lambda=1e-3, upsample_steps="6:12",
        dataset_path=os.path.join(scene_root, "scene"), num_random_rays=64, chunk_size=128,
        num_samples=8, num_iters=14, log_interval=1, val_interval=10, save_interval=10,
        save_path=os.path.join(scene_root, "a"), log_dir=os.path.join(scene_root, "logs"))
    lines_a: list = []
    state_a = fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(14)) and all(np.isfinite(list(a.values())))
    assert np.mean([a[i] for i in range(10, 14)]) < a[0]
    assert sum("Upsampled grid to 12^3 at iteration 6" in line for line in lines_a) == 1
    assert state_a.params.grid.shape == (12, 12, 12, 28)
    ckpt = os.path.join(cfg.save_path, "plenoxels_model_000010")
    assert read_metadata(ckpt) == {"step": 10, "model_type": "plenoxels", "grid_res": 12}
    assert load_checkpoint(ckpt)["optimizer"]["count"] == 11 - 6
    lines_b: list = []
    cfg_b = dataclasses.replace(cfg, num_iters=13, save_path=os.path.join(scene_root, "b"))
    state_b = fit(cfg_b, resume_path=ckpt, device="cpu", log=lines_b.append)
    assert state_b.params.grid_res == 12 and not any("Upsampled" in x for x in lines_b)
    b = _mses(lines_b)
    assert sorted(b) == list(range(10, 13))
    for i in b:
        assert b[i] == a[i + 1], i
    with open(os.path.join(cfg_b.save_path, "plenoxels_model_000013.meta.json")) as f:
        assert json.load(f)["grid_res"] == 12
    final = os.path.join(cfg.save_path, "plenoxels_model_000014")
    svc = RenderService.from_checkpoint(dataclasses.replace(cfg, grid_res=8), final,
                                        device="cpu", log=lambda *_: None)
    assert svc.params[0].grid_res == 12
    before = FusedGridRender.launches
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert FusedGridRender.launches == before
    occ = RenderService.from_checkpoint(cfg, final, occupancy=6, device="cpu",
                                        log=lambda *_: None)
    grid = occ._renderer.occupancy.grid                  # baked through the module
    assert grid.shape == (6, 6, 6, 1) and set(grid.unique().tolist()) <= {0.0, 1.0}
    assert np.isfinite(occ.render_pose(occ.orbit_pose(0))).all()
