"""The port's training slice against nerf_tpu: the LR law and Adam against
optax, a full hierarchical train step against the JAX step (Pallas kernels
in interpret mode), the ray pipeline and its Feistel cipher, and ``fit`` on
the CPU (loss, checkpoints, bit-identical resume, chunked steps, refusals,
the CLI, serving from a train checkpoint)."""

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
from nerf_tpu.data import pipeline as jpipe
from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.ops.pallas.fused_render import make_fused_nerf_render as jax_fused
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.render.renderer import render_rays_train as jax_render_rays_train
from nerf_tpu.train.optim import lr_schedule as jax_lr_schedule
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from tests.synthetic import make_synthetic_blender_scene

from nerf_tpu_torch.cli import train_cli
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import (
    RayBatch,
    _mul32,
    build_ray_pool,
    epoch_indices,
    feistel_permute,
)
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.optim import Adam, lr_schedule, make_optimizer
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.train.step import (
    _make_step_body,
    make_scan_train_step,
    make_train_step,
)
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state

NEAR, FAR = 2.0, 6.0


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("step", [0, 1, 1000, 100000, 2_000_000])
def test_lr_schedule_matches_optax_law(step):
    """lego.txt's law (lr 5e-4, decay 300k to 0.1, floor 1e-4; the floor
    binds past ~210k steps). float32 exp of the same argument: 1e-6."""
    args = (5e-4, 300.0, 0.1, 1e-4)
    ref = float(jax_lr_schedule(*args)(jnp.asarray(step)))
    np.testing.assert_allclose(lr_schedule(*args)(step), ref, rtol=1e-6)


def test_adam_matches_optax():
    """Three updates from the same grads, then a fourth after loading
    optax's moments into a fresh optimizer. float32 Adam on both sides, in
    the same operation order: 1e-7 on parameters of size ~0.1."""
    cfg = JaxConfig()
    jm = JaxNeRF(hidden_dim=32)
    params = jm.init(jax.random.key(0))
    tx = jax_make_optimizer(cfg)
    opt = tx.init((params, {}))
    tm = NeRFModel(hidden_dim=32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    adam = make_optimizer(Config(), list(tm.parameters()))
    rng = np.random.default_rng(0)
    for it in range(4):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
            params)
        upd, opt = tx.update((grads, {}), opt, (params, {}))
        params = optax.apply_updates(params, upd[0])
        if it == 3:                      # restart the port from optax's state
            tm2 = NeRFModel(hidden_dim=32)
            load_jax_params(tm2, jax.tree.map(np.asarray, prev))
            adam = make_optimizer(Config(), list(tm2.parameters()))
            load_jax_opt_state(adam, prev_opt)
            tm = tm2
        gl = [torch.from_numpy(g.copy()) for g in _flat_in_param_order(
            jax.tree.map(np.asarray, grads))]
        adam.step(gl)
        for a, b in zip(_flat_in_param_order(export_jax_params(tm)),
                        _flat_in_param_order(jax.tree.map(np.asarray, params))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
        prev, prev_opt = params, opt
    assert adam.count == 4


def test_adam_state_round_trip():
    tm = NeRFModel(hidden_dim=16)
    adam = Adam(tm.parameters(), lambda s: 1e-3)
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    adam.step()
    other = Adam(NeRFModel(hidden_dim=16).parameters(), lambda s: 1e-3)
    other.load_state_dict(adam.state_dict())
    assert other.count == 1
    for a, b in zip(other.mu + other.nu, adam.mu + adam.nu):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- train step


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_hierarchical_train_step_matches_jax(cdt):
    """Three steps of a hierarchical 8+16 (lego.txt's 64+128, scaled down),
    hidden 256, 16 rays, perturb off: the JAX side is render_rays_train
    through the Pallas train kernel (interpret mode) + value_and_grad +
    optax; the port's is its train step on an injected batch. Loss and mse
    within 1e-5 (f32) / 2e-3 (bf16) relative. Parameters: Adam moves each
    by at most lr = 5e-4 per step whatever the gradient's size, so a
    gradient element near zero whose sign differs between the frameworks
    can move by up to 2 lr per step; the bound is 6 lr = 3e-3 after three
    steps, and the mean difference must stay under 0.1 lr (f32; measured
    0.023 lr) / 0.5 lr (bf16)."""
    jm = JaxNeRF(hidden_dim=256, compute_dtype=cdt)
    params, fine = jm.init(jax.random.key(1)), jm.init(jax.random.key(2))
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=16,
              perturb=False, white_background=True)
    settings_j = JaxSettings(**kw)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    tx = jax_make_optimizer(JaxConfig())
    opt = tx.init((params, fine))
    rng = np.random.default_rng(5)
    ro = (rng.uniform(-0.5, 0.5, (16, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(16, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tgt = rng.uniform(0, 1, (16, 3)).astype(np.float32)

    @jax.jit
    def jax_step(pair, opt):
        def loss_fn(pair):
            return jax_render_rays_train(
                fr_j, pair[0], jnp.asarray(ro), jnp.asarray(rd),
                jax.random.key(0), settings_j, jnp.asarray(tgt),
                fine_params=pair[1], viewdirs=jnp.asarray(rd))
        (loss, mse), g = jax.value_and_grad(loss_fn, has_aux=True)(pair)
        upd, opt = tx.update(g, opt, pair)
        return optax.apply_updates(pair, upd), opt, loss, mse

    cfg = Config(hidden_dim=256, compute_dtype=cdt, **kw)
    state = create_train_state(cfg, device="cpu")
    load_jax_params(state.params, jax.tree.map(np.asarray, params))
    load_jax_params(state.fine_params, jax.tree.map(np.asarray, fine))
    _, train_on_batch = _make_step_body(state.params, RenderSettings(**kw), 16,
                                        seed=0)
    batch = RayBatch(*(torch.from_numpy(x) for x in (ro, rd, tgt, rd)))
    pair = (params, fine)
    tol = 1e-5 if cdt == "float32" else 2e-3
    for _ in range(3):
        pair, opt, loss_j, mse_j = jax_step(pair, opt)
        m = train_on_batch(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=tol)
        np.testing.assert_allclose(float(m["mse"]), float(mse_j), rtol=tol)
    assert state.step == 3 and state.optimizer.count == 3
    lr = 5e-4
    mean_tol = (0.1 if cdt == "float32" else 0.5) * lr
    for model, ref in ((state.params, pair[0]), (state.fine_params, pair[1])):
        for a, b in zip(_flat_in_param_order(export_jax_params(model)),
                        _flat_in_param_order(jax.tree.map(np.asarray, ref))):
            np.testing.assert_allclose(a, b, rtol=0, atol=6 * lr)
            assert np.abs(a - b).mean() < mean_tol, np.abs(a - b).mean() / lr


# ---------------------------------------------------------------- pipeline


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 10000, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 2**32 - 1]
    for b in (0x9E3779B1, 0x85EBCA6B, 2**32 - 1):
        got = _mul32(torch.from_numpy(a.astype(np.int64)), b).numpy()
        np.testing.assert_array_equal(got, (a * np.uint32(b)).astype(np.int64))


@pytest.mark.parametrize("domain", [37, 1000, 4096])
def test_feistel_matches_jax_and_is_a_bijection(domain):
    key = jax.random.key(7)
    x = np.arange(domain, dtype=np.int32)
    ref = np.asarray(jpipe._feistel_permute(key, jnp.asarray(x), domain))
    rks = np.asarray(jax.random.bits(key, (4,), dtype=jnp.uint32))
    got = feistel_permute(rks, torch.from_numpy(x), domain).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.sort(got), x)


def test_epoch_indices_match_jax():
    """A 1000-ray pool in batches of 96: steps inside an epoch and steps
    whose batch straddles an epoch boundary (10 * 96 = 960 < 1000 < 1056)."""
    key = jax.random.key(3)

    def keys_of_epoch(e):
        return np.asarray(jax.random.bits(jax.random.fold_in(key, e), (4,),
                                          dtype=jnp.uint32))

    for step in (0, 3, 10, 11, 21):
        ref = np.asarray(jpipe.epoch_indices(key, jnp.asarray(step), 96, 1000))
        got = epoch_indices(keys_of_epoch, step, 96, 1000).numpy()
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="batch_size"):
        epoch_indices(keys_of_epoch, 0, 2000, 1000)


def test_ray_pool_sampling():
    rng = np.random.default_rng(1)
    n = 3 * 50
    pool = build_ray_pool(*(rng.normal(size=(3, 50, 3)).astype(np.float32)
                            for _ in range(3)))
    assert pool.size == n
    np.testing.assert_allclose(torch.linalg.norm(pool.viewdirs, dim=-1).numpy(),
                               1.0, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    b = pool.sample(g, 64)
    assert all(x.shape == (64, 3) for x in b)

    def rows(batch):       # the pool row of each drawn ray (exact match)
        same = (batch.rays_o[:, None] == pool.rays_o[None]).all(-1)
        assert bool(same.any(1).all())
        return same.float().argmax(1)

    rows(b)
    e = pool.sample_epoch(seed=1, step=0, batch_size=n)   # one whole epoch
    assert torch.equal(torch.sort(rows(e)).values, torch.arange(n))


# ---------------------------------------------------------------- fit


def _cfg(root, **kw) -> Config:
    base = dict(dataset_path=os.path.join(root, "scene"), num_random_rays=64,
                num_samples=8, num_fine_samples=8, hidden_dim=32,
                learning_rate=5e-3, num_iters=30, log_interval=1,
                val_interval=10, save_interval=10,
                save_path=os.path.join(root, "models"),
                log_dir=os.path.join(root, "logs"))
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fit"))
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


@pytest.fixture(scope="module")
def full_run(scene_root):
    """An uninterrupted 31-iteration run (the resumed run below repeats
    iteration 10, so it ends where this one does)."""
    lines = []
    cfg = _cfg(scene_root, num_iters=31, save_path=os.path.join(scene_root, "a"))
    state = fit(cfg, device="cpu", log=lines.append)
    return cfg, state, lines


def test_fit_loss_falls_and_saves(full_run):
    cfg, state, lines = full_run
    mses = _mses(lines)
    assert sorted(mses) == list(range(31))
    assert all(np.isfinite(v) for v in mses.values())
    assert np.mean([mses[i] for i in range(26, 31)]) < 0.8 * mses[0]
    for step in (10, 20, 31):
        path = os.path.join(cfg.save_path, f"nerf_model_{step:06d}")
        assert os.path.exists(path) and os.path.exists(path + ".meta.json")
    assert state.step == 31 and state.optimizer.count == 31
    assert sum("[Validation Step]" in line for line in lines) == 3
    logs = os.listdir(cfg.log_dir)
    assert any(os.path.exists(os.path.join(cfg.log_dir, d, "val_0000010.png"))
               for d in logs)


def test_fit_resume_is_bit_identical(full_run, scene_root):
    """Resume from the step-10 checkpoint: state.step comes back as 11 and
    the loop restarts at iteration 10 (the JAX loop's bookkeeping), so the
    resumed iteration i draws what the first run's i+1 drew. The step is
    deterministic, so every mse and every final parameter is bit-identical."""
    cfg_a, state_a, lines_a = full_run
    ckpt = os.path.join(cfg_a.save_path, "nerf_model_000010")
    saved = load_checkpoint(ckpt)
    assert saved["train_step"] == 11 and saved["optimizer"]["count"] == 11
    lines = []
    cfg = dataclasses.replace(cfg_a, num_iters=30,
                              save_path=os.path.join(scene_root, "b"))
    state = fit(cfg, resume_path=ckpt, device="cpu", log=lines.append)
    assert "Resuming training from iteration 10" in lines
    a, b = _mses(lines_a), _mses(lines)
    assert sorted(b) == list(range(10, 30))
    for i in b:
        assert b[i] == a[i + 1], i
    assert state.step == state_a.step == 31
    for m, ma in ((state.params, state_a.params), (state.fine_params, state_a.fine_params)):
        for (k, x), (_, y) in zip(m.state_dict().items(), ma.state_dict().items()):
            assert torch.equal(x, y), k
    for x, y in zip(state.optimizer.mu + state.optimizer.nu,
                    state_a.optimizer.mu + state_a.optimizer.nu):
        assert torch.equal(x, y)
    # a checkpoint restores exactly what was saved
    state_c = create_train_state(cfg, device="cpu")
    restore_train_state(state_c, ckpt)
    assert state_c.step == 11 and state_c.optimizer.count == 11
    for (k, x) in state_c.params.state_dict().items():
        assert torch.equal(x, saved["params"][k])


def test_scan_steps_equal_single_steps(scene_root):
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.train.loop import render_settings_from_config

    cfg = _cfg(scene_root)
    scene = load_scene(cfg)
    settings = render_settings_from_config(cfg)
    s1 = create_train_state(cfg, device="cpu")
    s2 = create_train_state(cfg, device="cpu")
    m_n = make_scan_train_step(s1.params, settings, 64, cfg.seed, 3)(s1, scene.pool)
    one = make_train_step(s2.params, settings, 64, cfg.seed)
    singles = [one(s2, scene.pool) for _ in range(3)]
    assert m_n["mse"].shape == (3,)
    assert torch.equal(m_n["mse"], torch.stack([m["mse"] for m in singles]))
    for x, y in zip(s1.params.parameters(), s2.params.parameters()):
        assert torch.equal(x, y)


def test_config_fields_read_nowhere_are_only_donate_state():
    """Every field of the port's Config is read (as an attribute) by some
    module of nerf_tpu_torch/ besides config.py, except donate_state: JAX
    buffer donation, which has no counterpart. mesh_shape and multihost
    are read by fit and fit_multiscene since the parallel layer."""
    import nerf_tpu_torch

    root = os.path.dirname(nerf_tpu_torch.__file__)
    text = ""
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and os.path.join(d, f) != os.path.join(root, "config.py"):
                with open(os.path.join(d, f)) as fh:
                    text += fh.read()
    unread = [f.name for f in dataclasses.fields(Config)
              if not re.search(rf"\.{f.name}\b", text)]
    assert unread == ["donate_state"]


@pytest.mark.parametrize("family", ["fastnerf", "plenoctree"])
def test_fit_takes_the_bakeable_families(scene_root, family):
    """FastNeRF and PlenOctree, which fit refused before they were ported,
    train through their modules: two finite iterations and a final
    checkpoint of the family."""
    cfg = dataclasses.replace(_cfg(scene_root), model_type=family, num_iters=2,
                              save_path=os.path.join(scene_root, f"bakeable_{family}"))
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    mses = _mses(lines)
    assert sorted(mses) == [0, 1] and all(np.isfinite(list(mses.values())))
    assert type(state.params).__name__.lower().startswith(family)
    assert os.path.exists(os.path.join(cfg.save_path, f"{family}_model_000002"))


@pytest.mark.parametrize("field,value,match", [
    ("tv_sh_lambda", 0.1, "TV regularizer"), ("upsample_steps", "5:16", "upsample hook"),
    ("tv_lambda", 0.1, "TV regularizer")])
def test_fit_refuses_grid_options_on_other_families(scene_root, field, value, match):
    """The TV prior and the upsample schedule are ported for the grid
    families; on a NeRF they are a config error (ValueError), as in
    nerf_tpu's fit."""
    cfg = dataclasses.replace(_cfg(scene_root), **{field: value})
    with pytest.raises(ValueError, match=match):
        fit(cfg, device="cpu", log=lambda *_: None)


@pytest.mark.parametrize("fine", [0, 8])
def test_fit_trains_gabor(scene_root, fine):
    """model_type = gabor fits through its fused train pass (the plain
    version on the CPU), coarse-only and hierarchical with a separate fine
    GaborNet: finite losses, a checkpoint named for the family, and both
    models' filters moved by the steps."""
    cfg = _cfg(scene_root, model_type="gabor", num_fine_samples=fine, num_iters=3,
               save_path=os.path.join(scene_root, f"gabor_{fine}"),
               log_dir=os.path.join(scene_root, f"gabor_logs_{fine}"))
    init = create_train_state(cfg, device="cpu")
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    mses = _mses(lines)
    assert sorted(mses) == [0, 1, 2] and all(np.isfinite(list(mses.values())))
    assert os.path.exists(os.path.join(cfg.save_path, "gabor_model_000003"))
    for before, after in zip(init.models(), state.models()):
        assert type(after).__name__ == "GaborModel"
        assert not torch.equal(before.filters[0].omega, after.filters[0].omega)
    assert (state.fine_params is None) == (fine == 0)


@pytest.mark.parametrize("fine", [0, 8])
def test_fit_trains_kilonerf(scene_root, fine):
    """model_type = kilonerf (grid 2, hidden 32) fits through the field
    route (the field kernels' plain versions on the CPU), coarse-only and
    hierarchical with a separate fine KiloNeRF: finite losses, a checkpoint
    named for the family with grid_res in its metadata, and both models'
    networks moved by the steps; the launch counters stay untouched on the
    CPU."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
    from nerf_tpu_torch.utils.checkpoint import read_metadata

    cfg = _cfg(scene_root, model_type="kilonerf", grid_res=2, num_fine_samples=fine,
               num_iters=3, save_path=os.path.join(scene_root, f"kilonerf_{fine}"),
               log_dir=os.path.join(scene_root, f"kilonerf_logs_{fine}"))
    init = create_train_state(cfg, device="cpu")
    counts = (KiloNeRFField.launches, KiloNeRFField.bwd_launches)
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    assert (KiloNeRFField.launches, KiloNeRFField.bwd_launches) == counts
    mses = _mses(lines)
    assert sorted(mses) == [0, 1, 2] and all(np.isfinite(list(mses.values())))
    path = os.path.join(cfg.save_path, "kilonerf_model_000003")
    assert read_metadata(path)["grid_res"] == 2
    for before, after in zip(init.models(), state.models()):
        assert type(after).__name__ == "KiloNeRFModel" and after.num_networks == 8
        assert not torch.equal(before.l1.w, after.l1.w)
    assert (state.fine_params is None) == (fine == 0)


def test_fit_on_cuda_without_a_card_raises(scene_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(_cfg(scene_root), device="cuda", log=lambda *_: None)


def test_train_cli_and_serving_a_train_checkpoint(scene_root, capsys):
    cfg_path = os.path.join(scene_root, "cfg.txt")
    save = os.path.join(scene_root, "cli")
    with open(cfg_path, "w") as f:
        f.write(f"dataset_path = {os.path.join(scene_root, 'scene')}\n"
                "num_random_rays = 32\nnum_samples = 8\nnum_fine_samples = 8\n"
                f"hidden_dim = 32\nsave_path = {save}\n"
                f"log_dir = {os.path.join(scene_root, 'cli_logs')}\n"
                "log_interval = 1\nval_interval = 100\nsave_interval = 100\n")
    train_cli.main(["--config", cfg_path, "--max-steps", "2", "--device", "cpu"])
    assert "[Iter 0000001]" in capsys.readouterr().out
    ckpt = os.path.join(save, "nerf_model_000002")
    svc = RenderService.from_checkpoint(cfg_path, ckpt, device="cpu",
                                        log=lambda *_: None)
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    if not torch.cuda.is_available():      # --device defaults to cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--config", cfg_path, "--max-steps", "1"])


def test_render_route_matches_train_route(scene_root):
    """The hierarchical loss and its parameter gradients through the
    forward render + its backward under autograd (``render_rays`` with the
    fused render) against the train pass (``render_rays_train``), same
    models and rays, perturb off: the same plain arithmetic on the CPU, so
    the loss to 1e-6 and each gradient to 1e-5 of its max."""
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.render.renderer import render_rays, render_rays_train
    from nerf_tpu_torch.train.loop import render_settings_from_config

    cfg = _cfg(scene_root, perturb=False)
    settings = render_settings_from_config(cfg)
    rng = np.random.default_rng(9)
    ro = (rng.uniform(-0.5, 0.5, (32, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(32, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    tgt = torch.from_numpy(rng.uniform(0, 1, (32, 3)).astype(np.float32))
    st = create_train_state(cfg, device="cpu")
    fr = FusedNerfRender(st.params, NEAR, FAR)
    loss, _ = render_rays_train(fr, st.params, ro, rd, settings, tgt,
                                fine_params=st.fine_params)
    loss.backward()
    ref = [p.grad.clone() for m in st.models() for p in m.parameters()]
    for m in st.models():
        m.zero_grad(set_to_none=True)
    out = render_rays(st.params, ro, rd, settings, fine_params=st.fine_params,
                      fused_render=fr)
    loss2 = torch.mean((out.rgb - tgt) ** 2) + torch.mean((out.rgb_coarse - tgt) ** 2)
    loss2.backward()
    np.testing.assert_allclose(float(loss2.detach()), float(loss.detach()), rtol=1e-6)
    got = [p.grad for m in st.models() for p in m.parameters()]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
