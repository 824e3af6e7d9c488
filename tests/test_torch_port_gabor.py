"""The GaborNet family of nerf_tpu_torch against nerf_tpu: the model, the
init law, the weight converter (parameters, gradients, Adam moments),
``make_eval_render``, train steps against the JAX step, and ``fit`` /
checkpoints / serving of ``configs/lego_siren.txt`` with ``model_type =
gabor`` on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX side
runs on the CPU (the fused kernels in interpret mode or the pure path);
perturb is off where both sides sample, so that the random streams do not
matter. Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.models.gabor import GaborModel as JaxGabor
from nerf_tpu.models.gabor import _gabor_filter_init
from nerf_tpu.ops.pallas.fused_render_gabor import make_fused_gabor_render as jax_fused
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays_train as jax_render_rays_train
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from nerf_tpu.train.step import make_eval_render as jax_eval_render
from tests.synthetic import make_synthetic_blender_scene

from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_grads,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.gabor import GaborModel, sample_gamma
from nerf_tpu_torch.models.registry import create_model, model_from_config
from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import check_ported, fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState, create_train_state
from nerf_tpu_torch.train.step import _make_step_body, fused_render_for, make_eval_render
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state

NEAR, FAR = 2.0, 6.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cdt="float32", hidden=256, n=8, seed=0):
    jm = JaxGabor(hidden_dim=hidden, num_layers=n, compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = GaborModel(hidden_dim=hidden, num_layers=n, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _rays(rng, num_rays):
    """Camera-like rays from z = 4 toward the origin."""
    ro = (rng.uniform(-0.5, 0.5, (num_rays, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


# ---------------------------------------------------------------- model


# float32: the filters are the same arithmetic on both sides up to the
# order of XLA's and torch's 3-term dot and an ulp of sin/exp; measured over
# three seeds of each case 6.0e-8 on rgb and 4.8e-7 on sigma (values near
# 5.4): 1e-5 / 1e-4. bfloat16: the linear layers round their inputs as the
# JAX linear does; an ulp of a filter can flip one rounding and move a
# sample by 2^-8 relative at that stage, but at init the stages' product is
# small and no flip showed (measured as in float32): 1e-4 / 1e-3.
_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 1e-3)}


@pytest.mark.parametrize("hidden,n", [(32, 3), (64, 4)])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_gabor_forward_matches_jax(hidden, n, cdt):
    jm, params, tm = _pair(cdt, hidden, n, seed=1)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.5, 1.5, (96, 3)).astype(np.float32)
    dirs = rng.normal(size=(96, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb_j, sig_j = jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        rgb_t, sig_t = tm(_t(pts), _t(dirs))
    tol_rgb, tol_sigma = _TOL[cdt]
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=tol_rgb)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=tol_sigma)


def test_gamma_sampler_law():
    """sample_gamma against the Gamma(alpha, 1) moments (mean alpha,
    variance alpha) for a shape below 1 (the boosted path: alpha/n = 0.75 of
    the default model) and above it, over 40,000 draws: the mean within 4
    standard errors, the variance within 5%; every draw positive."""
    g = torch.Generator().manual_seed(0)
    for alpha in (0.75, 6.0):
        x = sample_gamma(40000, alpha, g).double()
        assert x.dtype == torch.float64 and bool((x > 0).all())
        assert abs(float(x.mean()) - alpha) < 4 * math.sqrt(alpha / 40000)
        assert abs(float(x.var()) / alpha - 1.0) < 0.05


def test_init_law_matches_jax():
    """The default model's filters (8 stages x 256 = 2,048 draws each)
    against the JAX init's: gamma ~ Gamma(0.75)/beta (mean and variance
    0.75, both within 15%, as the JAX draws are), omega / (fscale *
    sqrt(gamma)) ~ N(0, 1) with fscale = 64/sqrt(8), mu in [-1, 1] and phi
    in [-pi, pi] reaching near both ends; the density bias at 0.5."""
    tm = GaborModel(generator=torch.Generator().manual_seed(3))
    fscale = 64.0 / math.sqrt(8)
    ref = _gabor_filter_init(jax.random.key(3), 2048, fscale, 0.75, 1.0)
    gam = torch.cat([f.gamma.detach() for f in tm.filters]).double()
    for g in (gam.numpy(), np.asarray(ref["gamma"], np.float64)):
        assert abs(g.mean() / 0.75 - 1.0) < 0.15 and abs(g.var() / 0.75 - 1.0) < 0.15
        assert g.min() > 0
    z = torch.cat([(f.omega / (fscale * torch.sqrt(f.gamma))).detach().reshape(-1)
                   for f in tm.filters]).double()
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05
    for name, bound in (("mu", 1.0), ("phi", math.pi)):
        x = torch.cat([getattr(f, name).detach().reshape(-1) for f in tm.filters])
        r = np.asarray(ref[name])
        assert float(x.abs().max()) <= bound and float(np.abs(r).max()) <= bound
        assert float(x.min()) < -0.99 * bound and float(x.max()) > 0.99 * bound
    assert np.asarray(ref["omega"]).shape == (3, 2048) and np.asarray(ref["mu"]).shape == (2048, 3)
    assert tuple(tm.filters[0].omega.shape) == (3, 256)
    assert tuple(tm.filters[0].mu.shape) == (256, 3)
    assert float(tm.sigma.bias.detach()[0]) == 0.5
    b = GaborModel(hidden_dim=32, reference_init=True,
                   generator=torch.Generator().manual_seed(3))
    assert float(b.sigma.bias.detach()[0]) != 0.5
    c = GaborModel(hidden_dim=32, generator=torch.Generator().manual_seed(3))
    d = GaborModel(hidden_dim=32, generator=torch.Generator().manual_seed(3))
    for x, y in zip(c.parameters(), d.parameters()):
        assert torch.equal(x, y)


def test_convert_round_trip_and_layout():
    _, params, tm = _pair("float32", 32, 3, seed=3)
    back = export_jax_params(tm)
    assert set(back) == {"filters", "linears", "sigma", "remap", "rgb0", "rgb1"}
    assert set(back["filters"][0]) == {"omega", "phi", "mu", "gamma"}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(a, b)
    tm2 = GaborModel(hidden_dim=32, num_layers=3, generator=torch.Generator().manual_seed(9))
    load_jax_params(tm2, back)
    for (k, v), (k2, v2) in zip(tm.state_dict().items(), tm2.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    sd = tm.state_dict()
    assert "filters.2.gamma" in sd and "linears.1.weight" in sd and "rgb1.bias" in sd
    with pytest.raises(ValueError):
        load_jax_params(GaborModel(hidden_dim=64, num_layers=3), back)
    with pytest.raises(ValueError, match="filters"):
        load_jax_params(tm2, dict(back, filters=back["filters"][:2]))


def test_convert_grads_and_adam_state_by_name():
    """Gradients of the same loss through jax.grad and torch autograd, and
    one optax Adam step loaded into the port's Adam. JAX flattens the tree
    in sorted-key order (filters with gamma, mu, omega, phi; linears, remap,
    rgb0, rgb1, sigma), the port in parameter order (filters with omega,
    phi, mu, gamma; linears, sigma, remap, rgb0, rgb1): the maps go by name.
    float32 gradients to 1e-4 of their max."""
    jm, params, tm = _pair("float32", 32, 3, seed=4)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    def loss_j(p):
        rgb, sigma = jm.apply(p, jnp.asarray(pts), jnp.asarray(dirs))
        return jnp.sum(rgb ** 2) + 0.1 * jnp.sum(sigma)

    g_j = jax.grad(loss_j)(params)
    rgb, sigma = tm(_t(pts), _t(dirs))
    (torch.sum(rgb ** 2) + 0.1 * torch.sum(sigma)).backward()
    got = export_jax_grads(tm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g_j)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, {}))
    _, opt = tx.update((g_j, {}), opt, (params, {}))
    adam = make_optimizer(Config(), list(tm.parameters()))
    load_jax_opt_state(adam, opt)
    mu_ref = _flat_in_param_order(jax.tree.map(np.asarray, opt[0].mu[0]))
    assert adam.count == 1 and len(adam.mu) == len(mu_ref) == 3 * 4 + 2 * 2 + 2 * 4
    for p, m, r in zip(tm.parameters(), adam.mu, mu_ref):
        assert tuple(p.shape) == tuple(m.shape)
        np.testing.assert_array_equal(m.numpy(), r)


def test_model_from_lego_siren_config_with_gabor():
    """configs/lego_siren.txt with model_type = gabor builds the default
    GaborNet (8 stages, hidden 256, L_dir 4, bf16) and its train state."""
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt")),
        model_type="gabor")
    m = model_from_config(cfg)
    assert isinstance(m, GaborModel)
    assert (m.hidden_dim, m.num_layers, m.dir_encoding_dim, m.sigma_mul, m.input_scale,
            m.alpha, m.beta, m.cdt) == (256, 8, 4, 10.0, 64.0, 6.0, 1.0, torch.bfloat16)
    assert isinstance(create_model("GABOR", hidden_dim=32, pos_encoding_dim=10),
                      GaborModel)                  # knobs it does not take drop
    check_ported(cfg)
    state = create_train_state(dataclasses.replace(cfg, hidden_dim=32), device="cpu")
    assert isinstance(state.params, GaborModel) and state.fine_params is None
    settings = RenderSettings(near=NEAR, far=FAR)
    assert type(fused_render_for(state.params, settings)) is FusedGaborRender


# ---------------------------------------------------------------- renderer


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_make_eval_render_matches_jax(cdt):
    """The serving path (coarse-only), scaled down: 120 rays in tiles of 64
    (the last one ragged), 16 samples, perturb off, 4 stages at hidden 64;
    the JAX side on its pure path, the port on the route nerf_tpu takes at
    this width: no fused render (nerf_tpu's factory takes hidden h with
    h % 128 == 0 and (h/2) % 128 == 0 only), so the module, launching no
    kernel. float32 to 1e-5 (1e-4 on depth/disparity). bfloat16 to 1e-4
    (1e-3 on depth and disparity), the bounds set when this width still
    took the fused render's plain version, whose density from the unrounded
    last z and fast sine flip roundings against the pure path (measured
    3.5e-6 and 6.7e-6 then); the module rounds as the pure path does."""
    jm, params, tm = _pair(cdt, 64, 4, seed=9)
    ro, rd = _rays(np.random.default_rng(9), 120)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, chunk_size=64)
    ref = jax_eval_render(jm, JaxSettings(**kw))(
        params, {}, jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0))
    before = FusedGaborRender.launches
    got = make_eval_render(tm, RenderSettings(**kw))(tm, None, _t(ro), _t(rd))
    assert FusedGaborRender.launches == before                 # no kernel
    tol = 1e-5 if cdt == "float32" else 1e-4
    for name in ("rgb", "depth", "acc", "rgb_coarse", "disparity"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = 10.0 if name in ("depth", "disparity") else 1.0
        np.testing.assert_allclose(a, b, atol=tol * scale, err_msg=name)


# ---------------------------------------------------------------- train


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_gabor_train_steps_match_jax(cdt):
    """Three coarse-only steps (lego_siren.txt's shape with model_type =
    gabor, 16 samples), hidden 256 with 2 stages, 16 rays, perturb off: the
    JAX side is render_rays_train through the Pallas train kernel
    (interpret mode) + value_and_grad + optax; the port's is its train step
    on an injected batch. Loss and mse within 1e-5 (f32) / 1e-4 (bf16)
    relative (measured 1.7e-7 / 4.9e-6). Parameters: Adam moves each by at
    most lr = 5e-4 per step whatever the gradient's size, so an element
    whose gradient is near zero and of another sign in the two frameworks
    moves by up to 2 lr per step: 6 lr after three steps, and the mean
    difference under 0.1 lr (measured worst 0.021 lr f32 / 0.073 lr bf16,
    mean 0.021 lr, on the one-element density bias)."""
    jm, params, tm = _pair(cdt, 256, 2, seed=10)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False,
              white_background=True)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, {}))
    rng = np.random.default_rng(10)
    ro, rd = _rays(rng, 16)
    tgt = rng.uniform(0, 1, (16, 3)).astype(np.float32)

    @jax.jit
    def jax_step(pair, opt):
        def loss_fn(pair):
            return jax_render_rays_train(
                fr_j, pair[0], jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0),
                JaxSettings(**kw), jnp.asarray(tgt), viewdirs=jnp.asarray(rd))
        (loss, mse), g = jax.value_and_grad(loss_fn, has_aux=True)(pair)
        upd, opt = tx.update(g, opt, pair)
        return optax.apply_updates(pair, upd), opt, loss, mse

    state = TrainState(step=0, params=tm, fine_params=None,
                       optimizer=make_optimizer(Config(), list(tm.parameters())))
    _, train_on_batch = _make_step_body(state.params, RenderSettings(**kw), 16, seed=0)
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
        assert np.abs(a - b).mean() < 0.1 * lr, np.abs(a - b).mean() / lr


# ---------------------------------------------------------------- fit


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gabor_fit"))
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


def test_fit_resume_and_serve_gabor(scene_root):
    """lego_siren.txt's options with model_type = gabor (coarse-only,
    bfloat16, fused) at hidden 32 (8 stages) on a 16x16 scene: fit saves,
    validates and learns; a resume from the step-10 checkpoint repeats the
    first run bit for bit (the checkpoint names the family); the final
    checkpoint serves a request through RenderService on the CPU."""
    base = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    cfg = dataclasses.replace(
        base, model_type="gabor", dataset_path=os.path.join(scene_root, "scene"),
        num_random_rays=64, chunk_size=128, num_samples=8, hidden_dim=32,
        learning_rate=5e-3, num_iters=21, log_interval=1, val_interval=10,
        save_interval=10, save_path=os.path.join(scene_root, "a"),
        log_dir=os.path.join(scene_root, "logs"))
    lines_a: list = []
    state_a = fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(21)) and all(np.isfinite(list(a.values())))
    assert np.mean([a[i] for i in range(16, 21)]) < 0.9 * a[0]
    assert sum("[Validation Step]" in line for line in lines_a) == 2
    ckpt = os.path.join(cfg.save_path, "gabor_model_000010")
    saved = load_checkpoint(ckpt)
    assert saved["model_type"] == "gabor" and saved["fine_params"] == {}
    lines_b: list = []
    cfg_b = dataclasses.replace(cfg, num_iters=20, model_type="nerf",
                                save_path=os.path.join(scene_root, "b"))
    state_b = fit(cfg_b, resume_path=ckpt, device="cpu", log=lines_b.append)
    b = _mses(lines_b)
    assert sorted(b) == list(range(10, 20))
    for i in b:
        assert b[i] == a[i + 1], i
    for (k, x), (_, y) in zip(state_b.params.state_dict().items(),
                              state_a.params.state_dict().items()):
        assert torch.equal(x, y), k
    probe = create_train_state(cfg, device="cpu")
    restore_train_state(probe, ckpt)
    assert probe.step == 11 and isinstance(probe.params, GaborModel)
    final = os.path.join(cfg.save_path, "gabor_model_000021")
    svc = RenderService.from_checkpoint(dataclasses.replace(cfg, model_type="nerf"),
                                        final, device="cpu", log=lambda *_: None)
    assert svc.cfg.model_type == "gabor"
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
