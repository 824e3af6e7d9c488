"""The port's occupancy prior (``ops/occupancy.py``) against
``nerf_tpu.ops.occupancy``: the bake, the trilinear lookup and the drawn t;
then occupancy-guided rendering (``make_eval_render(occupancy=...)``) and a
train step against nerf_tpu's pure path, ``fit`` with ``occupancy_res`` and
its bit-identical resume, the serve bake and ``--occupancy``, and
``debug_nans`` in the photometric step, the distillation step and ``fit``.
All on the CPU at small widths; inputs from numpy seeds.

Tolerances. The bakes: exact equality of the {0, 1} grids (no lattice
density lies within float noise of the threshold; the NeRF case picks its
threshold in a gap of the densities). The lookup: 1e-6 (the same corner
law and products of {0, 1} values; measured 0). The drawn t: 2e-4, and
sorted: the bin weights agree exactly, but the two cumsums of the PDF
differ by an ulp (XLA's prefix scan and torch's running sum), and a bin at
the floor holds 3.5e-4 of the mass, so the inverse CDF amplifies that ulp
by bin width over mass (0.0625 / 3.5e-4 here; measured 7.5e-5 on t, the
same effect as tests/test_torch_port_render.py::test_sample_pdf_matches's
last-ulp note). The renders and the train step: the bounds of
tests/test_torch_port_render.py and tests/test_torch_port_train.py for the
pure path.
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
from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.ops import occupancy as jocc
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays as jax_render_rays
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from nerf_tpu.train.step import make_eval_render as jax_eval_render
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch import serve
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import RayBatch, RayPool
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_params,
    load_jax_params,
)
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops import occupancy as tocc
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.distill import make_distill_step
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState, create_train_state
from nerf_tpu_torch.train.step import _make_step_body, make_eval_render, make_train_step
from nerf_tpu_torch.utils.checkpoint import save_checkpoint

NEAR, FAR = 2.0, 6.0
DOMAIN = (-2.75, -1.25)          # grid_domain of scene_bound 1.5 in [2, 6]


def _t(x):
    return torch.from_numpy(np.array(x))


def _rays(rng, num_rays):
    """Camera-like rays from z = 4 toward the origin."""
    ro = (rng.uniform(-0.5, 0.5, (num_rays, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def _sphere_grid(r=8, radius=0.45):
    """A {0, 1} grid of a ball in the middle of DOMAIN, from both bakes."""
    c = 0.5 * (DOMAIN[0] + DOMAIN[1])
    jg = jocc.bake_occupancy(
        lambda p: jax.nn.relu(radius - jnp.linalg.norm(p - c, axis=-1)) * 10.0,
        grid_res=r, domain=DOMAIN, chunk=100)
    tg = tocc.bake_occupancy(
        lambda p: torch.relu(radius - torch.linalg.norm(p - c, dim=-1)) * 10.0,
        grid_res=r, domain=DOMAIN, chunk=100)
    return np.asarray(jg), tg


# ---------------------------------------------------------------- the prior


@pytest.mark.parametrize("dilate", [0, 1])
def test_bake_of_an_analytic_sphere_matches_jax(dilate):
    """A ball of radius 0.45 on a 16^3 lattice, in chunks of 1000 points
    (the JAX bake pads the last chunk, the port's is ragged): the same
    thresholded, dilated grid, exactly."""
    c = 0.5 * (DOMAIN[0] + DOMAIN[1])
    jg = jocc.bake_occupancy(
        lambda p: jax.nn.relu(0.45 - jnp.linalg.norm(p - c, axis=-1)) * 10.0,
        grid_res=16, domain=DOMAIN, dilate=dilate, chunk=1000)
    calls = []

    def sigma(p):
        calls.append(p.shape[0])
        return torch.relu(0.45 - torch.linalg.norm(p - c, dim=-1)) * 10.0

    tg = tocc.bake_occupancy(sigma, grid_res=16, domain=DOMAIN, dilate=dilate,
                             chunk=1000)
    assert calls == [1000] * 4 + [96]
    assert tg.shape == (16, 16, 16, 1) and tg.dtype == torch.float32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert 0 < float(tg.mean()) < 1


@pytest.mark.parametrize("dilate", [0, 1])
def test_bake_of_a_converted_nerf_matches_jax(dilate):
    """A hidden-32 NeRF converted from JAX, its density through
    ``sigma_field`` (directions (0, 0, 1)) on a 12^3 lattice over the lego
    domain, thresholded in the widest gap of its densities near the median:
    the same grid, exactly."""
    jm = JaxNeRF(hidden_dim=32, pos_encoding_dim=4, dir_encoding_dim=2)
    params = jm.init(jax.random.key(4))
    tm = NeRFModel(hidden_dim=32, pos_encoding_dim=4, dir_encoding_dim=2)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    pts = jnp.asarray(tocc.lattice(12, DOMAIN).numpy())
    s = np.sort(np.asarray(jocc.sigma_field(jm.apply, params)(pts)))
    k = len(s) // 2 - 100 + int(np.argmax(np.diff(s[len(s) // 2 - 100:len(s) // 2 + 100])))
    assert s[k + 1] - s[k] > 1e-5
    thresh = float(0.5 * (s[k] + s[k + 1]))
    jg = jocc.bake_occupancy(jocc.sigma_field(jm.apply, params), grid_res=12,
                             domain=DOMAIN, threshold=thresh, dilate=dilate, chunk=512)
    tg = tocc.bake_occupancy(tocc.sigma_field(tm), grid_res=12, domain=DOMAIN,
                             threshold=thresh, dilate=dilate, chunk=512)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert 0 < float(tg.mean()) < 1


def test_trilinear_lookup_matches_jax():
    """A random {0, 1} grid of 8^3 at 2000 points in [-1.2, 1.2]^3 (the
    clamp to the grid, the lower corner clamped to R - 2)."""
    rng = np.random.default_rng(3)
    grid = (rng.uniform(size=(8, 8, 8, 1)) < 0.4).astype(np.float32)
    p = rng.uniform(-1.2, 1.2, (2000, 3)).astype(np.float32)
    p[:20] = np.sign(p[:20])                     # corners and faces exactly
    ref = np.asarray(jocc._occ_trilinear(jnp.asarray(grid), jnp.asarray(p)))
    got = tocc._occ_trilinear(_t(grid), _t(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("perturb", [True, False])
def test_occupancy_t_matches_jax(perturb):
    """64 rays, 16 samples, the ball's grid: with the JAX key's uniform
    draws injected as ``u`` (perturb) or the strata's midpoints, the same
    monotonic t within 2e-4 (the module docstring)."""
    jg, tg = _sphere_grid()
    ro, rd = _rays(np.random.default_rng(5), 64)
    key = jax.random.key(9)
    ref = np.asarray(jocc.occupancy_t(
        key, jocc.OccupancyGrid(grid=jnp.asarray(jg), domain=DOMAIN), jnp.asarray(ro),
        jnp.asarray(rd), NEAR, FAR, 16, perturb=perturb))
    u = _t(np.asarray(jax.random.uniform(key, (64, 16)))) if perturb else None
    got = tocc.occupancy_t(tocc.OccupancyGrid(grid=tg, domain=DOMAIN), _t(ro), _t(rd),
                           NEAR, FAR, 16, perturb=perturb, u=u).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    assert (np.diff(got, axis=-1) >= 0).all()
    # the prior moves samples into the ball: more of them than uniform
    # stratification puts there
    g = torch.Generator().manual_seed(0)
    drawn = tocc.occupancy_t(tocc.OccupancyGrid(grid=tg, domain=DOMAIN), _t(ro),
                             _t(rd), NEAR, FAR, 16, generator=g)
    assert drawn.shape == (64, 16) and bool((drawn.diff(dim=-1) >= 0).all())


# ---------------------------------------------------------------- rendering


@pytest.mark.parametrize("fine_sampling", ["merge", "resample"])
def test_make_eval_render_with_occupancy_matches_jax(fine_sampling):
    """The serving path with the ball's prior, scaled down (hierarchical
    8+8, hidden 32, 100 rays in tiles of 64, perturb off) against
    nerf_tpu's pure path: rgb, acc and rgb_coarse within 1e-5, depth and
    disparity within 1e-4 (the render tests' bounds)."""
    jg, tg = _sphere_grid()
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=8, perturb=False,
              chunk_size=64, fine_sampling=fine_sampling)
    jm = JaxNeRF(hidden_dim=32)
    params, fine = jm.init(jax.random.key(1)), jm.init(jax.random.key(2))
    tm, tf = NeRFModel(hidden_dim=32), NeRFModel(hidden_dim=32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    load_jax_params(tf, jax.tree.map(np.asarray, fine))
    ro, rd = _rays(np.random.default_rng(7), 100)
    ref = jax_eval_render(jm, JaxSettings(**kw), use_pallas=False,
                          occupancy=jocc.OccupancyGrid(grid=jnp.asarray(jg), domain=DOMAIN))(
        params, fine, jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0))
    render = make_eval_render(tm, RenderSettings(**kw),
                              occupancy=tocc.OccupancyGrid(grid=tg, domain=DOMAIN))
    got = render(tm, tf, _t(ro), _t(rd))
    plain = make_eval_render(tm, RenderSettings(**kw))(tm, tf, _t(ro), _t(rd))
    for name in ("rgb", "acc", "rgb_coarse", "depth", "disparity"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        tol = 1e-4 if name in ("depth", "disparity") else 1e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
    assert not torch.allclose(got.depth, plain.depth)       # the prior moved t


def test_train_step_with_occupancy_matches_jax():
    """Three hierarchical 8+8 steps at hidden 32 with the ball's prior
    (perturb off, so no draws: the occupancy quantiles are the strata's
    midpoints) against JAX render_rays + value_and_grad + optax on the same
    batch: loss and mse within 1e-5 relative, parameters as
    test_hierarchical_train_step_matches_jax (6 lr, mean 0.1 lr)."""
    jg, tg = _sphere_grid()
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=8, perturb=False,
              white_background=True)
    jm = JaxNeRF(hidden_dim=32)
    params, fine = jm.init(jax.random.key(1)), jm.init(jax.random.key(2))
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, fine))
    rng = np.random.default_rng(5)
    ro, rd = _rays(rng, 16)
    tgt = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    occ_j = jocc.OccupancyGrid(grid=jnp.asarray(jg), domain=DOMAIN)
    settings_j = JaxSettings(**kw)

    @jax.jit
    def jax_step(pair, opt):
        def loss_fn(pair):
            out = jax_render_rays(jm.apply, pair[0], jnp.asarray(ro), jnp.asarray(rd),
                                  jax.random.key(0), settings_j, fine_params=pair[1],
                                  viewdirs=jnp.asarray(rd), occupancy=occ_j)
            mse = jnp.mean((out.rgb - tgt) ** 2)
            return mse + jnp.mean((out.rgb_coarse - tgt) ** 2), mse
        (loss, mse), g = jax.value_and_grad(loss_fn, has_aux=True)(pair)
        upd, opt = tx.update(g, opt, pair)
        return optax.apply_updates(pair, upd), opt, loss, mse

    cfg = Config(hidden_dim=32, **kw)
    state = create_train_state(cfg, device="cpu")
    load_jax_params(state.params, jax.tree.map(np.asarray, params))
    load_jax_params(state.fine_params, jax.tree.map(np.asarray, fine))
    _, train_on_batch = _make_step_body(state.params, RenderSettings(**kw), 16, seed=0,
                                        occupancy_opts=(DOMAIN, 64, 1e-2))
    batch = RayBatch(*(_t(x) for x in (ro, rd, tgt, rd)))
    pair = (params, fine)
    for _ in range(3):
        pair, opt, loss_j, mse_j = jax_step(pair, opt)
        m = train_on_batch(state, batch, tg)
        np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=1e-5)
    lr = 5e-4
    for model, ref in ((state.params, pair[0]), (state.fine_params, pair[1])):
        for a, b in zip(_flat_in_param_order(export_jax_params(model)),
                        _flat_in_param_order(jax.tree.map(np.asarray, ref))):
            np.testing.assert_allclose(a, b, rtol=0, atol=6 * lr)
            assert np.abs(a - b).mean() < 0.1 * lr


# ---------------------------------------------------------------- fit


def _cfg(root, **kw) -> Config:
    base = dict(dataset_path=os.path.join(root, "scene"), num_random_rays=32,
                num_samples=8, num_fine_samples=8, hidden_dim=32,
                learning_rate=5e-3, num_iters=7, log_interval=1,
                val_interval=100, save_interval=4, occupancy_res=8,
                occupancy_interval=2, save_path=os.path.join(root, "models"),
                log_dir=os.path.join(root, "logs"))
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("occ"))
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


def test_fit_with_occupancy_bakes_on_schedule_and_resumes_bit_identical(
        scene_root, monkeypatch):
    """7 iterations with an 8^3 prior rebaked every 2 optimizer steps: the
    bake before step 0 and after steps 2, 4 and 6, the loss finite; a
    resume from the step-4 checkpoint (a rebake point) bakes from the
    restored parameters, rebakes after optimizer step 6 (loop iteration 5),
    and repeats every mse bit for bit."""
    bakes = []
    real = tocc.bake_occupancy

    def counting(*a, **kw):
        out = real(*a, **kw)
        bakes.append(out)
        return out

    monkeypatch.setattr(tocc, "bake_occupancy", counting)
    lines_a = []
    cfg = _cfg(scene_root, save_path=os.path.join(scene_root, "a"))
    fit(cfg, device="cpu", log=lines_a.append)
    a = _mses(lines_a)
    assert sorted(a) == list(range(7)) and all(np.isfinite(v) for v in a.values())
    assert len(bakes) == 4 and all(b.shape == (8, 8, 8, 1) for b in bakes)
    first = bakes[:]
    bakes.clear()
    lines_b = []
    cfg_b = dataclasses.replace(cfg, save_path=os.path.join(scene_root, "b"))
    fit(cfg_b, resume_path=os.path.join(cfg.save_path, "nerf_model_000004"),
        device="cpu", log=lines_b.append)
    b = _mses(lines_b)
    assert sorted(b) == list(range(4, 7))
    for i in range(4, 6):
        assert b[i] == a[i + 1], i
    assert len(bakes) == 2
    for got, want in zip(bakes, first[2:]):
        assert torch.equal(got, want)


def test_fit_refuses_occupancy_no_more(scene_root):
    """``occupancy_res`` no longer raises (ROADMAP queue 1 item 2)."""
    from nerf_tpu_torch.train.loop import check_ported

    check_ported(_cfg(scene_root))


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def checkpoint(scene_root):
    cfg = _cfg(scene_root, perturb=False, chunk_size=100, num_render_poses=4,
               save_path=os.path.join(scene_root, "serve_models"))
    coarse = NeRFModel(hidden_dim=32, generator=torch.Generator().manual_seed(1))
    fine = NeRFModel(hidden_dim=32, generator=torch.Generator().manual_seed(2))
    return cfg, save_checkpoint(coarse, fine, cfg.save_path, "nerf", 5)


def test_build_renderer_bakes_from_the_fine_model(checkpoint):
    """A hierarchical config bakes its prior from the fine model over
    grid_domain(cfg), through fused_field_for (the module on the CPU), and
    the renderer samples from it."""
    cfg, ckpt = checkpoint
    svc = serve.RenderService.from_checkpoint(cfg, ckpt, occupancy=8, device="cpu",
                                              log=lambda *a: None)
    occ = svc._renderer.occupancy
    assert occ.domain == DOMAIN and occ.grid.shape == (8, 8, 8, 1)
    fine = svc.params[1]
    want = tocc.bake_occupancy(tocc.sigma_field(fine), grid_res=8, domain=DOMAIN)
    assert torch.equal(occ.grid, want)
    plain = serve.RenderService.from_checkpoint(cfg, ckpt, device="cpu",
                                                log=lambda *a: None)
    assert plain._renderer.occupancy is None
    img = svc.render_pose(svc.orbit_pose(1), key_idx=1)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_serve_cli_takes_occupancy(checkpoint, monkeypatch, tmp_path):
    cfg, ckpt = checkpoint
    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text("\n".join(
        f"{k} = {getattr(cfg, k)}" for k in (
            "dataset_path", "hidden_dim", "num_samples", "num_fine_samples",
            "chunk_size", "perturb")) + "\n")
    seen = []
    monkeypatch.setattr(serve, "serve_http", lambda svc, **kw: seen.append(svc))
    serve.main(["--config", str(cfg_path), "--checkpoint", ckpt, "--device", "cpu",
                "--occupancy", "8"])
    assert seen and seen[0]._renderer.occupancy.grid.shape == (8, 8, 8, 1)


# ---------------------------------------------------------------- debug_nans


def _nan_pool(n=256, nan=True):
    rng = np.random.default_rng(0)
    ro, rd = _rays(rng, n)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if nan:
        rgb[:] = np.nan
    return RayPool(rays_o=_t(ro), rays_d=_t(rd), rgb=_t(rgb), viewdirs=_t(rd))


@pytest.mark.parametrize("debug", [True, False])
def test_debug_nans_in_the_train_step(debug):
    """A batch whose targets are NaN makes a NaN loss: with ``debug_nans``
    the step raises FloatingPointError naming the step before the update;
    without, it updates on."""
    cfg = Config(hidden_dim=32, num_samples=8, num_fine_samples=0, debug_nans=debug)
    state = create_train_state(cfg, device="cpu")
    before = [p.detach().clone() for p in state.params.parameters()]
    settings = RenderSettings(near=NEAR, far=FAR, num_samples=8)
    step = make_train_step(state.params, settings, 32, seed=0, debug_nans=debug)
    if debug:
        with pytest.raises(FloatingPointError, match="at step 0"):
            step(state, _nan_pool())
        assert state.step == 0
        assert all(torch.equal(a, b) for a, b in zip(before, state.params.parameters()))
    else:
        m = step(state, _nan_pool())
        assert not np.isfinite(float(m["loss"])) and state.step == 1
    step(create_train_state(cfg, device="cpu"), _nan_pool(nan=False))  # finite: no raise


@pytest.mark.parametrize("debug", [True, False])
def test_debug_nans_in_the_distillation_step(debug):
    """A teacher that answers NaN: the distillation step raises naming its
    step with ``debug_nans``, and steps on without."""
    student = NeRFModel(hidden_dim=32, generator=torch.Generator().manual_seed(1))
    state = TrainState(step=0, params=student, fine_params=None,
                       optimizer=make_optimizer(Config(), list(student.parameters())))

    def teacher(p, d):
        return torch.full_like(p, float("nan")), torch.full(p.shape[:-1], float("nan"))

    step = make_distill_step(student, teacher, 64, 0, DOMAIN, 1, debug_nans=debug)
    if debug:
        with pytest.raises(FloatingPointError, match="distillation step 0"):
            step(state)
    else:
        assert not np.isfinite(float(step(state)["loss"][0]))


@pytest.mark.parametrize("debug", [True, False])
def test_debug_nans_in_fit(scene_root, debug):
    """A NaN learning rate makes the parameters NaN after the first update:
    ``fit`` with ``debug_nans`` raises at the next step; without, it runs to
    its end."""
    cfg = _cfg(scene_root, occupancy_res=0, num_iters=2, save_interval=100,
               learning_rate=float("nan"), debug_nans=debug,
               save_path=os.path.join(scene_root, f"nan_{debug}"))
    if debug:
        with pytest.raises(FloatingPointError, match="at step 1"):
            fit(cfg, device="cpu", log=lambda *a: None)
    else:
        state = fit(cfg, device="cpu", log=lambda *a: None)
        assert state.step == 2
