"""Teacher distillation of nerf_tpu_torch (``train/distill.py``) against
nerf_tpu's: the loss and its gradient against the same formula in JAX on
injected points, one chunk lowering the field error, the chunk logs and the
hand-off (step 0, fresh Adam), ``load_teacher`` reading the checkpoint's
metadata, and ``fit`` distilling and then fine-tuning from step 0, with a
resume that skips distillation. All on the CPU (the student's field kernels
through their plain versions); inputs from numpy seeds.
"""

from __future__ import annotations

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.gabor import GaborModel as JaxGabor
from nerf_tpu.models.kilonerf import KiloNeRFModel as JaxKilo
from nerf_tpu.models.nerf import NeRFModel as JaxNeRF
from nerf_tpu.models.siren import SirenModel as JaxSiren
from nerf_tpu.ops.pallas.fused_gabor import make_fused_gabor_apply
from nerf_tpu.ops.pallas.fused_kilonerf import make_fused_kilonerf_apply
from nerf_tpu.ops.pallas.fused_nerf import make_fused_nerf_apply
from nerf_tpu.ops.pallas.fused_siren import make_fused_siren_apply
from tests.synthetic import make_synthetic_blender_scene

from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
from nerf_tpu_torch.train.distill import (
    distill_loss,
    load_teacher,
    make_distill_step,
    run_distillation,
)
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState, create_train_state
from nerf_tpu_torch.train import step as step_mod
from nerf_tpu_torch.train.step import fused_field_for
from nerf_tpu_torch.utils.checkpoint import read_metadata, save_checkpoint

DOMAIN = (-2.75, -1.25)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _teacher_pair(seed=0):
    jt = JaxNeRF(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    tp = jt.init(jax.random.key(seed))
    tt = NeRFModel(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    load_jax_params(tt, jax.tree.map(np.asarray, tp))
    return jt, tp, tt


def _student_pair(seed=1, cdt="float32"):
    kw = dict(grid_res=2, hidden_dim=16, pos_encoding_dim=2, dir_encoding_dim=1,
              domain=DOMAIN, compute_dtype=cdt)
    js = JaxKilo(**kw)
    sp = js.init(jax.random.key(seed))
    ts = KiloNeRFModel(**kw)
    load_jax_params(ts, jax.tree.map(np.asarray, sp))
    return js, sp, ts


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_distill_loss_and_gradient_match_jax(cdt):
    """mean((s_rgb - t_rgb)^2) + mean((s_sigma - t_sigma)^2) on 300
    injected points of the domain: the JAX side with the student's Pallas
    kernels (interpret mode) and the teacher's module, as
    ``make_distill_step``'s loss_fn; the port with the student's field
    (plain versions) and the teacher's module. Loss within 1e-6 relative in
    float32 and 1e-4 in bfloat16 (measured 9.2e-8 / 9.1e-8); the student's
    gradients within 1e-5 / 5e-3 of each tensor's max (measured 1.7e-7 /
    1.7e-4); the teacher gets none."""
    jt, tp, tt = _teacher_pair()
    js, sp, ts = _student_pair(cdt=cdt)
    rng = np.random.default_rng(3)
    pts = rng.uniform(DOMAIN[0], DOMAIN[1], (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    fused = make_fused_kilonerf_apply(js, tile_fwd=16, tile_bwd=16, interpret=True)

    def loss_j(params):
        t_rgb, t_sigma = jt.apply(tp, jnp.asarray(pts), jnp.asarray(d))
        s_rgb, s_sigma = fused(params, jnp.asarray(pts), jnp.asarray(d))
        return (jnp.mean((s_rgb - jax.lax.stop_gradient(t_rgb)) ** 2)
                + jnp.mean((s_sigma - jax.lax.stop_gradient(t_sigma)) ** 2))

    lj, gj = jax.value_and_grad(loss_j)(sp)
    loss, rgb_mse, sigma_mse = distill_loss(fused_field_for(ts), tt, _t(pts), _t(d))
    loss.backward()
    assert float((loss - rgb_mse - sigma_mse).detach()) == 0.0
    rtol, gtol = (1e-6, 1e-5) if cdt == "float32" else (1e-4, 5e-3)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=rtol)
    got = export_jax_grads(ts)
    for name in got:
        for leaf in ("w", "b"):
            b = np.asarray(gj[name][leaf])
            np.testing.assert_allclose(got[name][leaf], b, rtol=0,
                                       atol=gtol * np.abs(b).max(), err_msg=name)
    assert all(p.grad is None for p in tt.parameters())


def _field_mse(student, teacher, n=512):
    rng = np.random.default_rng(7)
    pts = _t(rng.uniform(DOMAIN[0], DOMAIN[1], (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3))
    d = _t((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    with torch.no_grad():
        return float(distill_loss(student, teacher, pts, d)[0])


def test_distill_chunk_reduces_field_error():
    """One 60-step chunk (batch 1024, lr 2e-3) of a grid-2 student against a
    hidden-32 NeRF teacher halves the field error on held-out points, the
    loss trends down, the step counter advances by 60 and the draws key off
    it (cf. tests/test_distill.py::test_distill_step_reduces_field_error)."""
    _, _, tt = _teacher_pair()
    _, _, ts = _student_pair()
    tt.requires_grad_(False)
    student = fused_field_for(ts)
    state = TrainState(step=0, params=ts, fine_params=None,
                       optimizer=make_optimizer(Config(learning_rate=2e-3),
                                                list(ts.parameters())))
    before = _field_mse(student, tt)
    metrics = make_distill_step(student, tt, 1024, seed=2, domain=DOMAIN,
                                num_steps=60)(state)
    after = _field_mse(student, tt)
    assert after < 0.5 * before, (before, after)
    losses = metrics["loss"].numpy()
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert state.step == 60 and state.optimizer.count == 60


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("distill"))
    make_synthetic_blender_scene(os.path.join(r, "scene"), h=16, w=16,
                                 num_train=4, num_val=1, num_test=1)
    return r


def _cfg(root, **kw):
    base = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    opts = dict(dataset_path=os.path.join(root, "scene"), num_random_rays=64,
                chunk_size=128, num_samples=8, hidden_dim=32, pos_encoding_dim=2,
                dir_encoding_dim=1, compute_dtype="float32", num_iters=6,
                log_interval=1, val_interval=100, save_interval=100,
                log_dir=os.path.join(root, "logs"))
    opts.update(kw)
    return dataclasses.replace(base, **opts)


@pytest.fixture(scope="module")
def teacher_ckpt(root):
    """A small NeRF teacher trained on the module path (use_pallas =
    false, as a hidden-32 NeRF runs in the JAX package too)."""
    cfg = _cfg(root, model_type="nerf", use_pallas=False,
               save_path=os.path.join(root, "teacher"))
    fit(cfg, device="cpu", log=lambda *_: None)
    return os.path.join(cfg.save_path, "nerf_model_000006")


def test_run_distillation_logs_chunks_and_hands_off(root, teacher_ckpt):
    """150 steps run as chunks of 100 and 50, one "[Distill] done/total
    loss: ... (rgb ..., sigma ...)" line each and every step's loss as a
    ``distill_loss`` scalar; the state comes back at step 0 with a fresh
    Adam (count 0, zero moments) over the same, moved, parameters."""
    cfg = _cfg(root, model_type="kilonerf", grid_res=2, distill_from=teacher_ckpt,
               distill_steps=150, distill_batch=256, learning_rate=2e-3)
    state = create_train_state(cfg, device="cpu")
    start = [p.detach().clone() for p in state.params.parameters()]
    lines, scalars = [], []
    out = run_distillation(cfg, state, device="cpu", log=lines.append,
                           log_scalar=lambda tag, v, step: scalars.append((tag, step, v)))
    assert [line.split("  ")[0] for line in lines] == ["[Distill] 100/150",
                                                        "[Distill] 150/150"]
    for line in lines:
        assert re.match(r"\[Distill\] \d+/150  loss: \d+\.\d{6}  "
                        r"\(rgb \d+\.\d{6}, sigma \d+\.\d{4}\)$", line), line
    assert [s[1] for s in scalars] == list(range(150))
    assert {s[0] for s in scalars} == {"distill_loss"}
    assert scalars[-1][2] < scalars[0][2]
    assert out.step == 0 and out.params is state.params
    assert out.optimizer.count == 0
    assert all(float(m.abs().max()) == 0.0 for m in out.optimizer.mu + out.optimizer.nu)
    assert out.optimizer.params == list(state.params.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(start, state.params.parameters()))


def test_load_teacher_reads_the_metadata(root, teacher_ckpt):
    """The teacher is rebuilt from the checkpoint's model_type and
    grid_res over the same config: a NeRF from a kilonerf config (its
    module, frozen), and a KiloNeRF of grid 2 under a config of grid 3 (its
    field kernels, weights packed once)."""
    cfg = _cfg(root, model_type="kilonerf", grid_res=3)
    t = load_teacher(cfg, teacher_ckpt, device="cpu")
    assert isinstance(t, NeRFModel) and not any(p.requires_grad for p in t.parameters())
    assert isinstance(load_teacher(dataclasses.replace(cfg, use_pallas=False),
                                   teacher_ckpt, device="cpu"), NeRFModel)
    ks = KiloNeRFModel(grid_res=2, hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1,
                       domain=DOMAIN, generator=torch.Generator().manual_seed(5))
    path = save_checkpoint(ks, None, os.path.join(root, "kt"), "kilonerf", 0)
    assert read_metadata(path)["grid_res"] == 2
    kt = load_teacher(cfg, path, device="cpu")
    assert isinstance(kt, KiloNeRFField) and kt.packed is not None
    assert kt.model.grid_res == 2
    pts = torch.rand(50, 3) * 1.5 - 2.75
    d = torch.nn.functional.normalize(torch.randn(50, 3), dim=-1)
    with torch.no_grad():
        a, b = kt(pts, d), ks(pts, d)
    torch.testing.assert_close(a[0], b[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(a[1], b[1], atol=1e-4, rtol=0)
    # a NeRF at hidden 256 takes nerf_tpu's field kernel there: the module
    # on the CPU (the card takes the port's NerfField)
    big = NeRFModel(hidden_dim=256)
    assert fused_field_for(big) is big



_WRAPPERS = {"nerf": NerfField, "siren": SirenField, "gabor": GaborField}
_FAMILIES = {"nerf": (NeRFModel, JaxNeRF, make_fused_nerf_apply),
             "siren": (SirenModel, JaxSiren, make_fused_siren_apply),
             "gabor": (GaborModel, JaxGabor, make_fused_gabor_apply)}


@pytest.mark.parametrize("family,hidden,layers,row", [
    ("nerf", 32, 8, None), ("nerf", 256, 8, "kernel"), ("nerf", 512, 8, "row 1"),
    ("siren", 256, 8, "kernel"), ("siren", 512, 8, "row 9"), ("siren", 256, 4, None),
    ("gabor", 128, 8, None), ("gabor", 256, 8, "kernel"), ("gabor", 512, 8, "row 13"),
    ("gabor", 256, 4, "row 13")])
def test_teacher_field_route_follows_nerf_tpu(monkeypatch, family, hidden, layers, row):
    """A NeRF, SIREN or GaborNet teacher takes a field kernel exactly where
    nerf_tpu's make_fused_*_apply gives one (NeRF and GaborNet by width,
    SIREN by width and 8 layers): on the card one at hidden 256 (a GaborNet
    of 8 stages) takes the port's field wrapper (NerfField, SirenField,
    GaborField); where the port's kernels do not cover the shape (hidden
    512, a GaborNet of 4 stages) fused_field_for raises and names its row of
    PERF.md's table; elsewhere, and on the CPU, the teacher is its
    module."""
    cls, jcls, make = _FAMILIES[family]
    kw = dict(hidden_dim=hidden) if family == "nerf" else dict(hidden_dim=hidden,
                                                              num_layers=layers)
    assert (make(jcls(**kw), interpret=True) is not None) == (row is not None)
    model = cls(**kw)
    assert fused_field_for(model) is model
    monkeypatch.setattr(step_mod, "_on_card", lambda m: True)
    if row is None:
        assert fused_field_for(model) is model
    elif row == "kernel":
        assert type(fused_field_for(model)) is _WRAPPERS[family]
    else:
        with pytest.raises(NotImplementedError, match=re.escape(f"PERF.md {row} ")):
            fused_field_for(model)

def test_fit_distills_then_finetunes_and_resume_skips_it(root, teacher_ckpt):
    """fit() with distill_from: the distillation log lines, then the
    photometric loop from iteration 0 (state.step 5 after 5 iterations, as
    without distillation), grid_res in the checkpoint's metadata; a resume
    from the step-3 checkpoint runs no distillation and ends on the first
    run's parameters bit for bit (it repeats iteration 3 with the first
    run's step-4 draws, as the JAX loop's bookkeeping does). (cf. tests/test_distill.py::
    test_fit_distills_then_finetunes)."""
    cfg = _cfg(root, model_type="kilonerf", grid_res=2, distill_from=teacher_ckpt,
               distill_steps=12, distill_batch=256, num_iters=5, save_interval=3,
               save_path=os.path.join(root, "k"), log_dir=os.path.join(root, "klogs"))
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    assert any(line.startswith("Distilling from teacher") for line in lines)
    assert [line.split("  ")[0] for line in lines if line.startswith("[Distill]")] == [
        "[Distill] 12/12"]
    iters = [int(m.group(1)) for line in lines
             for m in [re.search(r"\[Iter (\d+)\]", line)] if m]
    assert iters == [0, 1, 2, 3, 4]
    assert state.step == 5 and state.optimizer.count == 5
    assert np.isfinite(float(sum(p.detach().sum() for p in state.params.parameters())))
    ckpt = os.path.join(cfg.save_path, "kilonerf_model_000003")
    assert read_metadata(ckpt)["grid_res"] == 2
    lines2: list = []
    resumed = fit(dataclasses.replace(cfg, grid_res=4, num_iters=4,
                                      save_path=os.path.join(root, "k2")),
                  resume_path=ckpt, device="cpu", log=lines2.append)
    assert not any("Distill" in line for line in lines2)
    assert resumed.params.grid_res == 2 and resumed.step == 5
    for (k, x), (_, y) in zip(resumed.params.state_dict().items(),
                              state.params.state_dict().items()):
        assert torch.equal(x, y), k


def test_train_cli_distills_and_trains_kilonerf(root, teacher_ckpt, capsys):
    """The train CLI on a config file with model_type = kilonerf and
    distill_from: distillation, then the photometric steps, on the CPU; a
    checkpoint with grid_res in its metadata."""
    from nerf_tpu_torch.cli import train_cli

    path = os.path.join(root, "kilo_cli.txt")
    save = os.path.join(root, "cli_models")
    with open(path, "w") as f:
        f.write("\n".join([
            f"dataset_path = {os.path.join(root, 'scene')}", "model_type = kilonerf",
            "hidden_dim = 32", "grid_res = 2", "pos_encoding_dim = 2",
            "dir_encoding_dim = 1", "num_random_rays = 64", "chunk_size = 128",
            "num_samples = 8", f"distill_from = {teacher_ckpt}", "distill_steps = 5",
            "distill_batch = 128", f"save_path = {save}",
            f"log_dir = {os.path.join(root, 'cli_logs')}", "log_interval = 1",
            "val_interval = 100", "save_interval = 100"]) + "\n")
    train_cli.main(["--config", path, "--device", "cpu", "--max-steps", "2"])
    out = capsys.readouterr().out
    assert "[Distill] 5/5" in out and "[Iter 0000001]" in out
    assert read_metadata(os.path.join(save, "kilonerf_model_000002"))["grid_res"] == 2
