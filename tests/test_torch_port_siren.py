"""The SIREN family of nerf_tpu_torch against nerf_tpu: the init laws, the
model, the weight converter (parameters, gradients, Adam moments), the
renderer (module and fused routes, coarse-only and hierarchical),
``make_eval_render``, train steps against the JAX step, and ``fit`` /
checkpoints / serving of ``configs/lego_siren.txt``-style runs on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX side
runs on the CPU (the fused kernels in interpret mode or the pure path);
perturb is off where both sides sample, so that the random streams do not
matter. Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.models.common import siren_init as jax_siren_init
from nerf_tpu.models.siren import SirenModel as JaxSiren
from nerf_tpu.ops.pallas.fused_render_siren import make_fused_siren_render as jax_fused
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.render.renderer import render_rays_train as jax_render_rays_train
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from nerf_tpu.train.step import make_eval_render as jax_eval_render
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.common import siren_init, uniform_init
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_grads,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.registry import create_model, model_from_config
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
from nerf_tpu_torch.render.renderer import RenderSettings, render_rays, render_rays_train
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import check_ported, fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.train.step import _make_step_body, fused_render_for, make_eval_render
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state

NEAR, FAR = 2.0, 6.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cdt="float32", hidden=256, seed=0):
    jm = JaxSiren(hidden_dim=hidden, compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = SirenModel(hidden_dim=hidden, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _rays(rng, num_rays):
    """Camera-like rays from z = 4 toward the origin."""
    ro = (rng.uniform(-0.5, 0.5, (num_rays, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


# ---------------------------------------------------------------- model


# float32: XLA's and torch's sines differ by an ulp, which eight sine layers
# carry to ~1e-6 of rgb and ~1e-5 of sigma (up to ~10), so 2e-5 / 2e-4.
# bfloat16: the same inputs round identically (the raw points too), but a
# last-bit difference of a sine or a float32 sum can land on the other side
# of a bf16 rounding boundary and move the sample by 2^-8 relative at that
# layer; at hidden 256 over four seeds that moved rgb by up to 6.6e-4 and
# sigma (values up to 18) by up to 3.1e-2, so 2e-3 / 1e-1.
_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-3, 1e-1)}


@pytest.mark.parametrize("hidden", [32, 256])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_siren_forward_matches_jax(hidden, cdt):
    jm, params, tm = _pair(cdt, hidden)
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


def test_init_laws_match_jax_bounds():
    """siren_init: U(-1/in, 1/in) on the first layer, U(-sqrt(6/in)/w0, .)
    after it, weight AND bias; uniform_init fills its bound. The draws
    differ between the frameworks (torch generator against JAX keys), so
    the laws are held by their extremes over many draws."""
    g = torch.Generator().manual_seed(0)
    u = uniform_init((20000,), 0.25, g)
    assert u.dtype == torch.float32 and float(u.abs().max()) <= 0.25
    assert float(u.abs().max()) > 0.249 and abs(float(u.mean())) < 5e-3
    for in_dim, w0, first in ((3, 30.0, True), (256, 1.0, False), (283, 1.0, False)):
        mine = siren_init(in_dim, 64, w0, first, g)
        ref = jax_siren_init(jax.random.key(1), in_dim, 64, w0, first)
        bound = 1.0 / in_dim if first else np.sqrt(6.0 / in_dim) / w0
        for p, r in ((mine.weight, ref["w"]), (mine.bias, ref["b"])):
            assert float(p.abs().max()) <= bound
            assert float(np.abs(np.asarray(r)).max()) <= bound
            assert float(p.abs().max()) > 0.8 * bound
        assert tuple(mine.weight.shape) == tuple(np.asarray(ref["w"]).T.shape)


def test_init_is_seeded_and_keeps_density_bias():
    a = SirenModel(hidden_dim=32, generator=torch.Generator().manual_seed(5))
    b = SirenModel(hidden_dim=32, generator=torch.Generator().manual_seed(5))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert float(a.sigma.bias.detach()[0]) == 0.5
    ref = SirenModel(hidden_dim=32, reference_init=True,
                     generator=torch.Generator().manual_seed(5))
    assert float(ref.sigma.bias.detach()[0]) != 0.5
    assert float(a.base[0].weight.detach().abs().max()) <= 1.0 / 3
    assert float(a.base[1].weight.detach().abs().max()) <= np.sqrt(6.0 / 32)
    assert float(a.rgb0.weight.detach().abs().max()) <= np.sqrt(6.0 / (32 + 27))
    assert (a.w0s, a.num_layers, a.sigma_mul, a.rgb_mul) == ((30.0,) + (1.0,) * 7, 8,
                                                            10.0, 1.0)


def test_convert_round_trip_and_layout():
    _, params, tm = _pair("float32", 32, seed=3)
    back = export_jax_params(tm)
    assert set(back) == {"base", "sigma", "remap", "rgb0", "rgb1"}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(a, b)
    tm2 = SirenModel(hidden_dim=32, generator=torch.Generator().manual_seed(9))
    load_jax_params(tm2, back)
    for (k, v), (k2, v2) in zip(tm.state_dict().items(), tm2.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    assert "base.7.weight" in tm.state_dict() and "rgb1.bias" in tm.state_dict()
    with pytest.raises(ValueError):
        load_jax_params(SirenModel(hidden_dim=64), back)
    short = dict(back, base=back["base"][:7])
    with pytest.raises(ValueError, match="base"):
        load_jax_params(tm2, short)


def test_convert_grads_and_adam_state_by_name():
    """Gradients of the same loss through jax.grad and torch autograd, and
    one optax Adam step loaded into the port's Adam. JAX flattens the SIREN
    dict in sorted-key order (base, remap, rgb0, rgb1, sigma), the port in
    parameter order (base, sigma, remap, rgb0, rgb1): the maps go by name.
    float32 gradients to 1e-4 of their max (sine-chain rounding)."""
    jm, params, tm = _pair("float32", 32, seed=4)
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
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, {}))
    _, opt = tx.update((g_j, {}), opt, (params, {}))
    adam = make_optimizer(Config(), list(tm.parameters()))
    load_jax_opt_state(adam, opt)
    mu_ref = _flat_in_param_order(jax.tree.map(np.asarray, opt[0].mu[0]))
    assert adam.count == 1 and len(adam.mu) == len(mu_ref) == 2 * 12
    for p, m, r in zip(tm.parameters(), adam.mu, mu_ref):
        assert tuple(p.shape) == tuple(m.shape)
        np.testing.assert_array_equal(m.numpy(), r)


def test_model_from_lego_siren_config():
    cfg = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    m = model_from_config(cfg)
    assert isinstance(m, SirenModel)
    assert (m.hidden_dim, m.num_layers, m.w0, m.hidden_w0, m.cdt) == (
        256, 8, 30.0, 1.0, torch.bfloat16)
    assert isinstance(create_model("SIREN", hidden_dim=32, pos_encoding_dim=10),
                      SirenModel)                  # knobs it does not take drop
    check_ported(cfg)
    state = create_train_state(dataclasses.replace(cfg, hidden_dim=32), device="cpu")
    assert isinstance(state.params, SirenModel) and state.fine_params is None
    assert state.optimizer.count == 0


def test_fused_render_for_picks_the_family():
    settings = RenderSettings(near=NEAR, far=FAR)
    assert type(fused_render_for(SirenModel(hidden_dim=32), settings)) is FusedSirenRender
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_render_for(torch.nn.Linear(3, 3), settings)


# ---------------------------------------------------------------- renderer


@pytest.mark.parametrize("fine", [0, 8])
def test_render_rays_matches_jax(fine):
    """render_rays, module route and fused route (its plain version), both
    against JAX's module route, perturb off, hidden 256, float32: 1e-5 on
    rgb/acc (the fused route rounds positions as the kernel does, an ulp
    from the module's), 1e-4 on depth and disparity."""
    jm, params, tm = _pair("float32", 256, seed=5)
    _, fine_p, tf = _pair("float32", 256, seed=6)
    ro, rd = _rays(np.random.default_rng(5), 10)
    kw = dict(near=NEAR, far=FAR, num_samples=16, num_fine_samples=fine,
              perturb=False, white_background=True)
    ref = jax_render_rays(jm.apply, params, jnp.asarray(ro), jnp.asarray(rd),
                          jax.random.key(0), JaxSettings(**kw), fine_params=fine_p)
    fr = FusedSirenRender(tm, NEAR, FAR)
    with torch.no_grad():
        for route in (None, fr):
            got = render_rays(tm, _t(ro), _t(rd), RenderSettings(**kw),
                              fine_params=tf, fused_render=route)
            for name in ("rgb", "acc", "depth", "disparity", "rgb_coarse"):
                tol = 1e-4 if name in ("depth", "disparity") else 1e-5
                np.testing.assert_allclose(getattr(got, name).numpy(),
                                           np.asarray(getattr(ref, name)),
                                           atol=tol, err_msg=f"{route} {name}")


@pytest.mark.parametrize("fine", [0, 8])
def test_render_rays_train_matches_jax(fine):
    """render_rays_train through the port's fused train pass (plain) against
    JAX's through the Pallas train kernel (interpret), perturb off, float32:
    the loss to 1e-6 relative, every gradient to 2e-4 of its max (the
    bounds of test_torch_port_siren_kernels.py)."""
    jm, params, tm = _pair("float32", 256, seed=7)
    _, fine_p, tf = _pair("float32", 256, seed=8)
    rng = np.random.default_rng(7)
    ro, rd = _rays(rng, 8)
    tgt = rng.uniform(0, 1, (8, 3)).astype(np.float32)
    kw = dict(near=NEAR, far=FAR, num_samples=16, num_fine_samples=fine,
              perturb=False, white_background=True)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)

    def loss_fn(pair):
        return jax_render_rays_train(fr_j, pair[0], jnp.asarray(ro), jnp.asarray(rd),
                                     jax.random.key(0), JaxSettings(**kw),
                                     jnp.asarray(tgt), fine_params=pair[1])

    (loss_j, mse_j), g_j = jax.value_and_grad(loss_fn, has_aux=True)((params, fine_p))
    loss, mse = render_rays_train(FusedSirenRender(tm, NEAR, FAR), tm, _t(ro), _t(rd),
                                  RenderSettings(**kw), _t(tgt), fine_params=tf)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(float(mse.detach()), float(mse_j), rtol=1e-6)
    models = (tm, tf) if fine else (tm,)
    for model, ref in zip(models, g_j):
        for a, b in zip(jax.tree.leaves(export_jax_grads(model)), jax.tree.leaves(ref)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4 * np.abs(b).max())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_make_eval_render_matches_jax(cdt):
    """The serving path of lego_siren.txt (coarse-only), scaled down: 120
    rays in tiles of 64 (the last one ragged), 16 samples, perturb off; the
    JAX side on its pure path, the port through its fused render's plain
    version. float32 to 1e-5 (1e-4 on depth/disparity). bfloat16: the fused
    route takes the density from the unrounded h8 and the fast sine, the
    pure JAX path from the bf16-rounded h8 and the exact sine, so rounding
    flips move a sample; 5e-3 (5e-2 on depth/disparity; measured 9.4e-4 on
    rgb, 2.8e-3 on depth; float32 8.9e-7 and 4.1e-6)."""
    jm, params, tm = _pair(cdt, 256, seed=9)
    ro, rd = _rays(np.random.default_rng(9), 120)
    kw = dict(near=NEAR, far=FAR, num_samples=16, perturb=False, chunk_size=64)
    ref = jax_eval_render(jm, JaxSettings(**kw))(
        params, {}, jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0))
    before = FusedSirenRender.launches
    got = make_eval_render(tm, RenderSettings(**kw))(tm, None, _t(ro), _t(rd))
    assert FusedSirenRender.launches == before                 # CPU: plain
    tol = 1e-5 if cdt == "float32" else 5e-3
    for name in ("rgb", "depth", "acc", "rgb_coarse", "disparity"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = 10.0 if name in ("depth", "disparity") else 1.0
        np.testing.assert_allclose(a, b, atol=tol * scale, err_msg=name)


# ---------------------------------------------------------------- train


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_siren_train_steps_match_jax(cdt):
    """Three coarse-only steps (lego_siren.txt's shape, 16 samples), hidden
    256, 16 rays, perturb off: the JAX side is render_rays_train through the
    Pallas train kernel (interpret mode) + value_and_grad + optax; the
    port's is its train step on an injected batch. Loss and mse within
    1e-5 (f32) / 5e-3 (bf16, the spread of the kernels file) relative.
    Parameters: Adam moves each by at most lr = 5e-4 per step whatever the
    gradient's size, so a gradient element near zero whose sign differs
    between the frameworks moves by up to 2 lr per step: 6 lr after three
    steps, and the mean difference under 0.1 lr (f32) / 0.5 lr (bf16)."""
    jm, params, tm = _pair(cdt, 256, seed=10)
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

    cfg = Config(model_type="siren", hidden_dim=256, compute_dtype=cdt, **kw)
    state = create_train_state(cfg, device="cpu")
    assert state.fine_params is None
    load_jax_params(state.params, jax.tree.map(np.asarray, params))
    _, train_on_batch = _make_step_body(state.params, RenderSettings(**kw), 16, seed=0)
    batch = RayBatch(*(_t(x) for x in (ro, rd, tgt, rd)))
    pair = (params, {})
    tol = 1e-5 if cdt == "float32" else 5e-3
    for _ in range(3):
        pair, opt, loss_j, mse_j = jax_step(pair, opt)
        m = train_on_batch(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=tol)
        np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=tol)
    assert state.step == 3 and state.optimizer.count == 3
    lr = 5e-4
    mean_tol = (0.1 if cdt == "float32" else 0.5) * lr
    for a, b in zip(_flat_in_param_order(export_jax_params(state.params)),
                    _flat_in_param_order(jax.tree.map(np.asarray, pair[0]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=6 * lr)
        assert np.abs(a - b).mean() < mean_tol, np.abs(a - b).mean() / lr


# ---------------------------------------------------------------- fit


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("siren_fit"))
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


def test_fit_resume_and_serve_siren(scene_root):
    """lego_siren.txt's options (siren, coarse-only, bfloat16, fused) at
    hidden 32 on a 16x16 scene: fit saves, validates and learns; a resume
    from the step-10 checkpoint repeats the first run bit for bit (the
    checkpoint names the family); the final checkpoint serves."""
    base = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    cfg = dataclasses.replace(
        base, dataset_path=os.path.join(scene_root, "scene"), num_random_rays=64,
        chunk_size=128, num_samples=8, hidden_dim=32, learning_rate=5e-3,
        num_iters=21, log_interval=1, val_interval=10, save_interval=10,
        save_path=os.path.join(scene_root, "a"),
        log_dir=os.path.join(scene_root, "logs"))
    lines_a: list = []
    state_a = fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(21)) and all(np.isfinite(list(a.values())))
    assert np.mean([a[i] for i in range(16, 21)]) < 0.9 * a[0]
    assert sum("[Validation Step]" in line for line in lines_a) == 2
    ckpt = os.path.join(cfg.save_path, "siren_model_000010")
    saved = load_checkpoint(ckpt)
    assert saved["model_type"] == "siren" and saved["fine_params"] == {}
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
    assert probe.step == 11 and isinstance(probe.params, SirenModel)
    final = os.path.join(cfg.save_path, "siren_model_000021")
    svc = RenderService.from_checkpoint(dataclasses.replace(cfg, model_type="nerf"),
                                        final, device="cpu", log=lambda *_: None)
    assert svc.cfg.model_type == "siren"
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
