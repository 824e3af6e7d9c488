"""The FastNeRF slice of nerf_tpu_torch against nerf_tpu on the CPU: the
skip trunk and ``FastNeRFModel`` (sigma, factors, beta, rgb) in float32
and bfloat16, ``bilinear``, the bake (``pos_grid``, ``beta_grid``),
``BakedFastNeRF.beta`` and ``apply``, the plain version of row 18's factor
form against the Pallas kernel in interpret mode, the routes, three Adam
steps against the JAX step, ``build_renderer(bake=8)`` against nerf_tpu's,
and ``fit`` with a resume and a baked service.

Inputs come from numpy seeds and go through both packages, at hidden 32,
L = 4/2, D = 8, a 16^3 grid and a direction grid of 8 x 16. Each test
states its tolerance.
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
from nerf_tpu.models.fastnerf import FastNeRFModel as JaxFastNeRF
from nerf_tpu.ops.interp import bilinear as jax_bilinear
from nerf_tpu.ops.pallas.fused_grid_render import make_fused_grid_render as jax_grid_render
from nerf_tpu.ops.sampling import deltas_from_t as jax_deltas_from_t
from nerf_tpu.ops.sampling import normalize_positions as jax_normalize_positions
from nerf_tpu.ops.volume import composite as jax_composite
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.serve import build_renderer as jax_build_renderer
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.convert import (
    export_jax_params,
    load_jax_baked,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.fastnerf import BakedFastNeRF, FastNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.fused_grid_render import (
    FusedFactorRender,
    FusedGridRender,
    _expand_basis,
    _factor_sel,
    make_fused_grid_render,
)
from nerf_tpu_torch.ops.interp import bilinear
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.serve import RenderService, build_renderer
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState
from nerf_tpu_torch.train.step import (
    _kernel_route,
    _make_step_body,
    fused_field_for,
    train_field,
)
from nerf_tpu_torch.utils.checkpoint import read_metadata

NEAR, FAR = 2.0, 6.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = (-2.75, -1.25)     # grid_domain of the default config
SMALL = dict(hidden_dim=32, pos_encoding_dim=4, dir_encoding_dim=2, num_factors=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cdt="float32", seed=0, use_grid_kernel=True):
    """A JAX FastNeRF (its init from ``seed``) and a port model holding the
    same weights."""
    jm = JaxFastNeRF(compute_dtype=cdt, use_grid_kernel=use_grid_kernel, domain=DOMAIN,
                     **SMALL)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tm = FastNeRFModel(compute_dtype=cdt, use_grid_kernel=use_grid_kernel, domain=DOMAIN,
                       **SMALL)
    load_jax_params(tm, params)
    return jm, params, tm


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _bundle(rng, n, s, spread=0.01):
    """Coherent camera rays from (0, 0, 4) towards the origin, sorted t in
    [2.5, 5.5] (their points lie in DOMAIN's cube after normalisation): the
    Pallas kernel's window fits and its kernel path runs."""
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (n, 1))
    d = np.array([0.0, 0.0, -1.0]) + spread * rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = (np.linspace(2.5, 5.5, s, dtype=np.float32)[None].repeat(n, 0)
         + (1.5 / s) * rng.uniform(size=(n, s)).astype(np.float32))
    return o, d, t


# ---------------------------------------------------------------- model


# float32: the same products summed in another order; bfloat16: a float32
# sum that differs in its last bit can round an activation to the other
# bf16 neighbour (2^-8 relative), as tests/test_torch_port_model.py states
# for the NeRF trunk (its _TOL).
_TOL = {"float32": 2e-5, "bfloat16": 5e-3}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_fastnerf_module_matches_jax(cdt):
    """pos_factors (sigma, factors), dir_weights (beta) and the module's rgb
    and sigma on 200 points in [-1, 1]^3 with unit directions, against
    nerf_tpu's apply with the same weights: within _TOL[cdt], absolute
    (measured 1.5e-7 in float32, 6e-8 in bfloat16)."""
    jm, params, tm = _pair(cdt, seed=1)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    dirs = _unit(rng, 200)
    sj, fj = jm.pos_factors(params, jnp.asarray(pts))
    bj = jm.dir_weights(params, jnp.asarray(dirs))
    rj, sj2 = jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        st, ft = tm.pos_factors(_t(pts))
        bt = tm.dir_weights(_t(dirs))
        rt, st2 = tm(_t(pts), _t(dirs))
    tol = _TOL[cdt]
    assert ft.shape == (200, 8, 3) and bt.shape == (200, 8)
    for got, want in ((st, sj), (ft, fj), (bt, bj), (rt, rj), (st2, sj2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_skip_trunk_init_and_converter():
    """The port's init has nerf_tpu's tree (the same leaves and shapes
    through export_jax_params), torch's Linear law, and the density-bias
    guard (head bias 0 = 0.5; not with reference_init); a generator gives
    the same weights twice; the converter round-trips exactly and refuses
    another width."""
    want = jax.tree.map(np.shape, JaxFastNeRF(**SMALL).init(jax.random.key(0)))
    a = FastNeRFModel(**SMALL, generator=torch.Generator().manual_seed(3))
    got = jax.tree.map(np.shape, export_jax_params(a))
    assert got == want
    assert float(a.head.bias.detach()[0]) == 0.5
    b = FastNeRFModel(**SMALL, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    ref = FastNeRFModel(**SMALL, reference_init=True, generator=torch.Generator().manual_seed(3))
    assert float(ref.head.bias.detach()[0]) != 0.5
    assert float(a.trunk1[0].weight.detach().abs().max()) <= 1 / np.sqrt(a.pos_in)
    _, params, tm = _pair()
    back = export_jax_params(tm)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        load_jax_params(FastNeRFModel(**dict(SMALL, hidden_dim=16)), params)


def test_bilinear_matches_jax():
    """A (8, 16, 5) grid at 300 coordinates over [-1.5, 8.5] x [-1.5,
    16.5] (some past the border, where the clipped base extrapolates):
    values within 1e-5 (measured 9.5e-7), and the gradient in the grid and
    the coordinates within 1e-5 of jax.vjp."""
    rng = np.random.default_rng(2)
    g = rng.normal(size=(8, 16, 5)).astype(np.float32)
    u = rng.uniform(-1.5, 8.5, 300).astype(np.float32)
    v = rng.uniform(-1.5, 16.5, 300).astype(np.float32)
    cot = rng.normal(size=(300, 5)).astype(np.float32)
    ref, vjp = jax.vjp(jax_bilinear, jnp.asarray(g), jnp.asarray(u), jnp.asarray(v))
    gg, gu, gv = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    tg, tu, tv = (_t(x).requires_grad_() for x in (g, u, v))
    out = bilinear(tg, tu, tv)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    for got, want in ((tg.grad, gg), (tu.grad, gu), (tv.grad, gv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_bake_matches_jax(cdt):
    """bake(grid_res=16, dir_res=8): pos_grid (16, 16, 16, 25) over DOMAIN^3
    and beta_grid (8, 16, 8), against nerf_tpu's bake of the same weights:
    within _TOL[cdt] (torch's and XLA's linspace differ in the last bit, as
    tests/test_torch_port_plenoxels.py finds for upsample; measured 1.8e-7
    in float32, 4.0e-4 in bfloat16, where one trunk activation rounds to
    the other bf16 neighbour); the bfloat16 copy is pos_grid rounded;
    without the grid kernels there is none."""
    jm, params, tm = _pair(cdt, seed=2)
    jb = jm.bake(params, grid_res=16, dir_res=8)
    tb = tm.bake(grid_res=16, dir_res=8)
    assert isinstance(tb, BakedFastNeRF) and not list(tb.parameters())
    assert tb.pos_grid.shape == (16, 16, 16, 25) and tb.beta_grid.shape == (8, 16, 8)
    for got, want in ((tb.pos_grid, jb.pos_grid), (tb.beta_grid, jb.beta_grid)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_TOL[cdt])
    assert torch.equal(tb.packed_pos, tb.pos_grid.bfloat16())
    assert tm.bake(grid_res=4, dir_res=2).packed_pos is not None
    tm.use_grid_kernel = False
    assert tm.bake(grid_res=4, dir_res=2).packed_pos is None


def test_baked_beta_and_apply_match_jax():
    """load_jax_baked of nerf_tpu's 16^3 cache: beta at 300 unit directions
    plus the poles z = +-1 and the seam phi = +-pi (within 2e-6: at z = +-1
    arccos and atan2 may differ between the frameworks in the last bit,
    which moves the bilinear coordinates; measured 8.9e-8, 0 at the poles);
    apply on flat points (float32 trilinear) within 2e-5 of nerf_tpu's
    (measured 9e-8); on (R, S, 3) points (the bfloat16 copy, row 17's
    bfloat16 mode, the eval default) within 5e-3 of nerf_tpu's float32
    values (its CPU path interpolates in float32; measured 4.3e-5 on rgb,
    1.6e-3 on sigma) and not equal to them."""
    jm, params, _ = _pair(seed=3)
    jb = jm.bake(params, grid_res=16, dir_res=8)
    tb = load_jax_baked(jb)
    assert tb.domain == DOMAIN and tb.packed_pos.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    dirs = np.concatenate([_unit(rng, 300), np.array(
        [[0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, -1e-7, 0]], np.float32)])
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(tb.beta(_t(dirs)).numpy(), np.asarray(jb.beta(jnp.asarray(dirs))),
                               rtol=0, atol=2e-6)
    o, d, t = _bundle(rng, 12, 10, spread=0.2)
    pts = (2.0 * (o[:, None] + t[..., None] * d[:, None] - NEAR) / (FAR - NEAR) - 1.0)
    pts = pts.astype(np.float32)
    vd = np.broadcast_to(d[:, None], pts.shape).copy()
    rj, sj = jb.apply(None, jnp.asarray(pts), jnp.asarray(vd))
    with torch.no_grad():
        rf, sf = tb(_t(pts).reshape(-1, 3), _t(vd).reshape(-1, 3))
        rb, sb = tb(_t(pts), _t(vd))
    np.testing.assert_allclose(rf.numpy().reshape(rj.shape), np.asarray(rj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(sf.numpy().reshape(sj.shape), np.asarray(sj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(rb.numpy(), np.asarray(rj), rtol=0, atol=5e-3)
    np.testing.assert_allclose(sb.numpy(), np.asarray(sj), rtol=0, atol=5e-3)
    assert np.abs(rb.numpy() - np.asarray(rj)).max() > 1e-6


# ---------------------------------------------------------------- row 18


def test_factor_layout_and_basis():
    """_factor_sel maps channel 1 + 3d + c to colour c, and the factor
    basis covers those channels with beta_d (nerf_tpu's _factor_sel and
    _expand_basis(repeat_block=False))."""
    from nerf_tpu.ops.pallas.fused_grid_render import _expand_basis as jax_expand
    from nerf_tpu.ops.pallas.fused_grid_render import _factor_sel as jax_sel

    sel = _factor_sel(8)
    want = np.asarray(jax_sel(25, 8))
    for ch in range(32):
        colour = int(np.argmax(want[ch])) if want[ch].any() else -1
        assert sel[ch] == colour, ch
    beta = np.random.default_rng(4).normal(size=(5, 8)).astype(np.float32)
    np.testing.assert_array_equal(_expand_basis(_t(beta), repeat_block=False).numpy(),
                                  np.asarray(jax_expand(jnp.asarray(beta), repeat_block=False)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factor_form_plain_matches_jax(dtype):
    """100 coherent rays x 24 samples over nerf_tpu's 16^3 cache of a
    random FastNeRF (D = 8, 25 channels). bfloat16 (the cache's copy, the
    eval default): the plain factor form against make_fused_grid_render in
    interpret mode with force=True, as tests/test_grid_render_kernel.py
    drives it: rgb, acc within 2e-5, weights within 1e-4, depth within
    1e-3 (measured 7.2e-7, 1.8e-7, 3.7e-5, 4.6e-5: the corner weights of
    the sample at fault round alike on both sides, yet its density moves by
    a bfloat16 step, so one weight of 2,400 and the T after it move by
    1e-3 relative). float32 (a cache without the copy; nerf_tpu's kernel
    reads bfloat16 only): against nerf_tpu's unfused render of the cache
    (apply, composite): rgb, acc, weights within 2e-5, depth within 4e-4
    (measured 3.6e-7, 9.5e-7 on depth).
    No launch on the CPU; a call under autograd whose grid requires grad
    raises."""
    jm, params, _ = _pair(seed=5, use_grid_kernel=dtype == "bfloat16")
    jb = jm.bake(params, grid_res=16, dir_res=8)
    tb = load_jax_baked(jb)
    rng = np.random.default_rng(5)
    o, d, t = _bundle(rng, 100, 24)
    if dtype == "bfloat16":
        fr = jax_grid_render(jb, NEAR, FAR, normalize=True, interpret=True, force=True)
        ref = jax.jit(fr)(None, *(jnp.asarray(x) for x in (o, d, d, t)))
        tfr = make_fused_grid_render(tb, NEAR, FAR)
    else:
        assert tb.packed_pos is None and make_fused_grid_render(tb, NEAR, FAR) is None
        pts = jax_normalize_positions(jnp.asarray(o[:, None] + t[..., None] * d[:, None]),
                                      NEAR, FAR)
        rgb_s, sigma = jb.apply(None, pts, jnp.broadcast_to(jnp.asarray(d)[:, None], pts.shape))
        out = jax_composite(rgb_s, sigma, jax_deltas_from_t(jnp.asarray(t)), t=jnp.asarray(t),
                            white_background=False)
        ref = {"rgb": out.rgb, "acc": out.acc, "depth": out.depth, "weights": out.weights}
        tfr = FusedFactorRender(tb, NEAR, FAR)
    assert isinstance(tfr, FusedFactorRender)
    before = (FusedGridRender.launches, FusedFactorRender.launches)
    with torch.no_grad():
        got = tfr(tfr.pack(tb), _t(o), _t(d), _t(d), _t(t))
    assert (FusedGridRender.launches, FusedFactorRender.launches) == before   # CPU: plain
    tol = {"rgb": 2e-5, "acc": 2e-5, "weights": 2e-5, "depth": 4e-4}
    if dtype == "bfloat16":
        tol.update(weights=1e-4, depth=1e-3)
    for k in ("rgb", "acc", "depth", "weights"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol[k],
                                   err_msg=k)
    tb.pos_grid.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="eval-only"):
        tfr(tb, _t(o), _t(d), _t(d), _t(t))


def test_routes_follow_nerf_tpu():
    """The live model trains and renders through its module (no fused
    render, no field kernel; nerf_tpu has none for it); the cache renders
    through the factor form and trains (were it trained) through its
    module; without the grid kernels, with 11 factors (34 channels) or for
    any other model, make_fused_grid_render gives None, as nerf_tpu's
    factory does; a NeRF is not a grid cache."""
    s = RenderSettings(near=NEAR, far=FAR, num_samples=8)
    m = FastNeRFModel(**SMALL)
    for for_train in (True, False):
        assert _kernel_route(m, s, True, for_train=for_train) == (None, fused_field_for)
    assert fused_field_for(m) is m and train_field(m, s, True) is m
    cache = m.bake(grid_res=4, dir_res=2)
    fr, field = _kernel_route(cache, s, True, for_train=False)
    assert isinstance(fr, FusedFactorRender) and field is None
    assert _kernel_route(cache, s, True) == (None, fused_field_for)
    assert fused_field_for(cache) is cache
    wide = FastNeRFModel(**dict(SMALL, num_factors=11)).bake(grid_res=4, dir_res=2)
    assert wide.packed_pos is None and make_fused_grid_render(wide, NEAR, FAR) is None
    m.use_grid_kernel = False
    assert make_fused_grid_render(m.bake(grid_res=4, dir_res=2), NEAR, FAR) is None
    assert make_fused_grid_render(NeRFModel(hidden_dim=32), NEAR, FAR) is None


# ---------------------------------------------------------------- train


def test_fastnerf_train_steps_match_jax():
    """Three Adam steps (lr 5e-4) on 32 rays x 16 samples (perturb off: the
    midpoint t on both sides), coarse only: nerf_tpu's render_rays on the
    module + value_and_grad + optax against the port's train step (the
    module under autograd). Loss and mse within 1e-5 relative (measured
    0); optax's Adam state loads into the port's; after three steps fewer
    than 0.1% of the weights lie further than 0.01 lr from nerf_tpu's and
    their mean difference is under 1e-3 lr (measured: none further, max
    5.2e-4 lr, mean 9e-7 lr). Adam divides each gradient by its own root
    mean square, so a weight whose gradient is a few ulps from zero moves
    by up to lr a step when the two frameworks round it differently (as the
    Plenoxels test finds); one run of the PlenOctree test saw one such
    weight at 0.9 lr."""
    jm, params, tm = _pair(seed=6)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, white_background=True)
    lr = 5e-4
    tx = jax_make_optimizer(JaxConfig(learning_rate=lr))
    opt = tx.init((params, {}))
    rng = np.random.default_rng(6)
    o, d, _ = _bundle(rng, 32, 4, spread=0.3)
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
    adam = make_optimizer(Config(learning_rate=lr), list(tm.parameters()))
    load_jax_opt_state(adam, opt)
    assert adam.count == 3 and len(adam.mu) == len(list(tm.parameters()))
    for p, mu in zip(tm.parameters(), adam.mu):
        assert mu.shape == p.shape


# ---------------------------------------------------------------- serve


def _service_cfg(root, **kw):
    return dict(model_type="fastnerf", hidden_dim=32, pos_encoding_dim=4, dir_encoding_dim=2,
                num_samples=8, num_fine_samples=8, perturb=False, chunk_size=64,
                dataset_path=os.path.join(root, "scene"), **kw)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fastnerf"))
    make_synthetic_blender_scene(os.path.join(root, "scene"), h=16, w=16,
                                 num_train=4, num_val=1, num_test=1)
    return root


def test_build_renderer_bake_matches_jax(scene_root):
    """build_renderer(bake=8) of a hierarchical FastNeRF config (8 + 8
    samples, perturb off) with a separate fine model: the fine model is
    baked on both sides and renders both passes. Without the kernels
    (use_pallas = false: float32 interpolation through the cache's apply)
    a 16 x 16 image matches nerf_tpu's within 1e-5 (rgb; measured 3e-7);
    with them (tile order, the plain factor form over the bfloat16 copy)
    within mean abs 1e-2 of that (the serving check of chip_smoke.py); a
    NeRF refuses to bake with ValueError."""
    cfg_kw = _service_cfg(scene_root)
    jcfg = JaxConfig(**cfg_kw, use_pallas=False)
    jm = JaxFastNeRF(domain=DOMAIN, use_grid_kernel=False, **SMALL)
    coarse, fine = (jax.tree.map(np.asarray, jm.init(jax.random.key(k))) for k in (7, 8))
    state = SimpleNamespace(params=coarse, fine_params=fine)
    jsettings = JaxSettings(near=NEAR, far=FAR, num_samples=8, num_fine_samples=8,
                            perturb=False, chunk_size=64)
    jr, jp = jax_build_renderer(jm, state, jcfg, jsettings, bake=8, log=lambda *_: None)
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
            m = FastNeRFModel(domain=DOMAIN, use_grid_kernel=use_pallas, **SMALL)
            load_jax_params(m, tree)
            models.append(m)
        cfg = Config(**cfg_kw, use_pallas=use_pallas)
        renderer, rp = build_renderer(models[0], models[1], cfg, settings, bake=8,
                                      log=lambda *_: None)
        assert isinstance(rp[0], BakedFastNeRF) and rp[1] is None
        assert rp[0].packed_pos is None if not use_pallas else rp[0].packed_pos is not None
        before = FusedFactorRender.launches
        rgbs[use_pallas] = renderer(*rp, _t(o), _t(d), hw=(h, w)).rgb.numpy()
        assert FusedFactorRender.launches == before
    np.testing.assert_allclose(rgbs[False], np.asarray(ref.rgb), rtol=0, atol=1e-5)
    assert np.abs(rgbs[True] - rgbs[False]).mean() < 1e-2
    with pytest.raises(ValueError, match="bake"):
        build_renderer(NeRFModel(hidden_dim=32), None, Config(model_type="nerf"), settings,
                       bake=8)


def _mses(lines) -> dict:
    out = {}
    for line in lines:
        m = re.search(r"\[Iter (\d+)\] LR: \S+ MSE: (\S+)", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def test_fit_resume_and_serve_baked(scene_root):
    """configs/lego.txt with model_type = fastnerf at hidden 32 on a 16x16
    scene: fit logs 8 finite iterations and saves at step 4 and at the end
    (no grid_res in the metadata: the live model has none); a resume from
    step 4 repeats the first run bit for bit; the final checkpoint serves a
    16x16 request on the CPU with bake = 8 (the plain factor form: no
    launch)."""
    base = parse_config_file(os.path.join(REPO, "configs", "lego.txt"))
    cfg = dataclasses.replace(
        base, **_service_cfg(scene_root), num_random_rays=64, num_iters=8, log_interval=1,
        val_interval=4, save_interval=4, save_path=os.path.join(scene_root, "a"),
        log_dir=os.path.join(scene_root, "logs"))
    lines_a: list = []
    fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(8)) and all(np.isfinite(list(a.values())))
    ckpt = os.path.join(cfg.save_path, "fastnerf_model_000004")
    assert read_metadata(ckpt) == {"step": 4, "model_type": "fastnerf"}
    lines_b: list = []
    fit(dataclasses.replace(cfg, num_iters=7, save_path=os.path.join(scene_root, "b")),
        resume_path=ckpt, device="cpu", log=lines_b.append)
    b = _mses(lines_b)
    assert sorted(b) == [4, 5, 6] and all(b[i] == a[i + 1] for i in b)
    final = os.path.join(cfg.save_path, "fastnerf_model_000008")
    svc = RenderService.from_checkpoint(cfg, final, bake=8, device="cpu", log=lambda *_: None)
    assert isinstance(svc.params[0], BakedFastNeRF) and svc.params[0].pos_grid.shape[0] == 8
    before = FusedFactorRender.launches
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert FusedFactorRender.launches == before
