"""Teacher distillation of nerf_tpu_torch (``train/distill.py``) against
nerf_tpu's: the loss and its gradient against the same formula in JAX on
injected points, one chunk lowering the field error, and the teacher's
field route. All on the CPU (the student's field kernels through their
plain versions); inputs from numpy seeds. The loops (the chunk logs and the
hand-off, ``load_teacher``, ``fit`` and the train CLI distilling) are in
``test_torch_port_distill_fit.py``.
"""

from __future__ import annotations

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
from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
from nerf_tpu_torch.train.distill import distill_loss, make_distill_step
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import TrainState
from nerf_tpu_torch.train import step as step_mod
from nerf_tpu_torch.train.step import fused_field_for

DOMAIN = (-2.75, -1.25)


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




_WRAPPERS = {"nerf": NerfField, "siren": SirenField, "gabor": GaborField}
_FAMILIES = {"nerf": (NeRFModel, JaxNeRF, make_fused_nerf_apply),
             "siren": (SirenModel, JaxSiren, make_fused_siren_apply),
             "gabor": (GaborModel, JaxGabor, make_fused_gabor_apply)}


@pytest.mark.parametrize("family,hidden,layers,row", [
    ("nerf", 32, 8, None), ("nerf", 256, 8, "kernel"), ("nerf", 512, 8, "kernel"),
    ("nerf", 1024, 8, "kernel"), ("nerf", 1280, 8, "row 1"),
    ("siren", 256, 8, "kernel"), ("siren", 512, 8, "kernel"), ("siren", 1024, 8, "kernel"),
    ("siren", 1280, 8, "row 9"), ("siren", 256, 4, None),
    ("gabor", 128, 8, None), ("gabor", 256, 8, "kernel"), ("gabor", 512, 8, "kernel"),
    ("gabor", 256, 4, "kernel"), ("gabor", 1024, 1, "kernel"), ("gabor", 1280, 8, "row 13")])
def test_teacher_field_route_follows_nerf_tpu(monkeypatch, family, hidden, layers, row):
    """A NeRF, SIREN or GaborNet teacher takes a field kernel exactly where
    nerf_tpu's make_fused_*_apply gives one (NeRF and GaborNet by width,
    SIREN by width and 8 layers): on the card a NeRF or SIREN at hidden 256
    to 1024, a GaborNet at 256 to 1024 of any depth takes the port's field
    wrapper (NerfField, SirenField, GaborField); where the port's kernels do
    not cover the shape (a NeRF, SIREN or GaborNet at 1280) fused_field_for
    raises and names its row of
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
