"""The plain versions of the port's NeRF field kernels
(``ops/cuda/fused_nerf.py``: ``nerf_field_plain`` and
``nerf_field_bwd_plain`` behind ``NerfField``) against nerf_tpu's Pallas
kernels (``make_fused_nerf_apply``) in interpret mode on the CPU, in both
compute dtypes; and the port's route choice (fused render, field kernel,
module or raise) against nerf_tpu's factories called directly.

The kernels themselves run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py); the CPU route of the wrapper is the plain version, which
repeats their arithmetic. Hidden 256 is the narrowest width the TPU kernel
takes; 300 points are no tile multiple. One interpret-mode run per dtype
(forward and VJP), in a module-scoped fixture. Inputs come from numpy seeds.

Tolerances. float32 (the bounds of tests/test_pallas_kernels.py): rgb 1e-5,
sigma 1e-4, every gradient (weights, points, directions) 1e-4 of its max;
measured 6.0e-8, 3.0e-8 and 6.8e-7 of the max. bfloat16: the same rounding
points and fast sine on both sides, so the forward differs only where a
last-bit difference of a float32 sum flips one bf16 rounding: 1e-4 on rgb
and sigma (measured 4.0e-5 and 3.4e-5). Its gradients are the render
kernels' case (tests/test_torch_port_train_kernels.py): every dz is rounded
to bf16 before each product, so such a flip is carried through ten layers;
measured 7.8e-2 of the max (an early layer's weight) and 7.1e-2 on the
point cotangent, so 0.25 of the max and 0.05 on the relative Frobenius
norm, the render kernels' bounds.
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
from nerf_tpu.ops.pallas.fused_render import make_fused_nerf_render
from nerf_tpu.ops.pallas.fused_render_gabor import make_fused_gabor_render
from nerf_tpu.ops.pallas.fused_render_siren import make_fused_siren_render
from nerf_tpu.ops.pallas.fused_siren import make_fused_siren_apply

from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
from nerf_tpu_torch.ops.cuda.fused_nerf import (
    NerfField,
    input_transposes,
    nerf_field_bwd_plain,
    nerf_field_plain,
)
from nerf_tpu_torch.ops.cuda.fused_render import PP, pack_params
from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train import step as step_mod
from nerf_tpu_torch.train.step import _kernel_route, fused_field_for

N = 300
FWD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 1e-4)}
GRAD_TOL = {"float32": (1e-4, None), "bfloat16": (0.25, 0.05)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    """One forward and one VJP of the Pallas kernels (interpret mode) and of
    the port's field on the CPU, same weights, points, directions and
    cotangent, for the loss sum(cot * [rgb, sigma])."""
    cdt = request.param
    jm = JaxNeRF(hidden_dim=256, compute_dtype=cdt)
    params = jm.init(jax.random.key(3))
    tm = NeRFModel(hidden_dim=256, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cot = rng.normal(size=(N, 4)).astype(np.float32)
    fused = make_fused_nerf_apply(jm, tile_fwd=128, tile_bwd=128, interpret=True)

    def loss(p, x, dd):
        r, s = fused(p, x, dd)
        return jnp.sum(r * cot[:, :3]) + jnp.sum(s * cot[:, 3])

    rgb_j, sig_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    g_j = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pts), jnp.asarray(d))

    before = (NerfField.launches, NerfField.bwd_launches)
    x, dd = _t(pts).requires_grad_(True), _t(d).requires_grad_(True)
    rgb_t, sig_t = NerfField(tm)(x, dd)
    (torch.sum(rgb_t * _t(cot)[:, :3]) + torch.sum(sig_t * _t(cot)[:, 3])).backward()
    assert (NerfField.launches, NerfField.bwd_launches) == before   # CPU: plain
    return dict(cdt=cdt, tm=tm, pts=pts, d=d, cot=cot,
                jax=(np.asarray(rgb_j), np.asarray(sig_j),
                     jax.tree.map(np.asarray, g_j[0]), np.asarray(g_j[1]),
                     np.asarray(g_j[2])),
                port=(rgb_t.detach().numpy(), sig_t.detach().numpy(),
                      export_jax_grads(tm), x.grad.numpy(), dd.grad.numpy()))


def _assert_grad(a, b, cdt, what):
    tol, fro = GRAD_TOL[cdt]
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.abs(b).max()),
                               err_msg=what)
    if fro is not None:
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < fro, (what, rel)


def test_field_forward_matches_pallas_interpret(case):
    rgb, sig = case["port"][:2]
    rgb_j, sig_j = case["jax"][:2]
    tol_rgb, tol_sig = FWD_TOL[case["cdt"]]
    assert rgb.shape == (N, 3) and sig.shape == (N,)
    np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=tol_rgb)
    np.testing.assert_allclose(sig, sig_j, rtol=0, atol=tol_sig)


def test_field_weight_gradients_match_pallas_interpret(case):
    got, ref = case["port"][2], case["jax"][2]
    for blk in ("block1", "block2", "rgb"):
        for i, (g, r) in enumerate(zip(got[blk], ref[blk])):
            for k in ("w", "b"):
                _assert_grad(np.asarray(g[k]), np.asarray(r[k]), case["cdt"],
                             f"{blk}[{i}].{k}")


def test_field_input_gradients_match_pallas_interpret(case):
    """The VJP's point and direction cotangents: the encodings' backward
    with the exact cosine, after dz6 w6p^T + dz1 w1^T and dzr0 wr0d^T."""
    _assert_grad(case["port"][3], case["jax"][3], case["cdt"], "points")
    _assert_grad(case["port"][4], case["jax"][4], case["cdt"], "directions")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_plain_versions_agree_with_the_wrapper(cdt):
    """The wrapper's CPU route is the plain versions: a field over a leading
    shape (20, 3) that it flattens, under autograd, gives exactly the
    outputs of ``nerf_field_plain`` and the point, direction and weight
    gradients of ``nerf_field_bwd_plain`` on the packing (hidden 64, 60
    points: the plain versions take any width)."""
    tm = NeRFModel(hidden_dim=64, compute_dtype=cdt,
                   generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    pts = _t(rng.uniform(-1.2, 1.2, (60, 3)).astype(np.float32))
    d = _t(rng.normal(size=(60, 3)).astype(np.float32))
    cot = _t(rng.normal(size=(60, 4)).astype(np.float32))
    x = pts.reshape(20, 3, 3).clone().requires_grad_(True)
    dd = d.reshape(20, 3, 3).clone().requires_grad_(True)
    rgb2, sig2 = NerfField(tm)(x, dd)
    assert rgb2.shape == (20, 3, 3) and sig2.shape == (20, 3)
    (torch.sum(rgb2.reshape(60, 3) * cot[:, :3])
     + torch.sum(sig2.reshape(60) * cot[:, 3])).backward()
    with torch.no_grad():
        packed = NerfField(tm).pack().packed
        rgb, sig = nerf_field_plain(packed, pts, d, 10, 4)
        gw, gv, dpts, ddirs = nerf_field_bwd_plain(packed, pts, d, cot, 10, 4)
    assert torch.equal(rgb2.detach().reshape(60, 3), rgb)
    assert torch.equal(sig2.detach().reshape(60), sig)
    assert torch.equal(x.grad.reshape(60, 3), dpts)
    assert torch.equal(dd.grad.reshape(60, 3), ddirs)
    assert gw.shape == packed.wmat.shape and gv.shape == packed.vec.shape
    assert torch.equal(tm.linears(tm.block1)[0].bias.grad, gv[:64])


def test_input_transposes_layout():
    """w1^T, w6p^T and wr0d^T, zero-padded to 128 columns, in order (the
    backward kernel's OFF_T_* offsets)."""
    packed = pack_params(NeRFModel(generator=torch.Generator().manual_seed(1)))
    t = input_transposes(packed)
    assert t.numel() == 256 * 128 * 2 + 128 * 128 and t.dtype == packed.wmat.dtype
    w1t = t[:256 * 128].view(256, 128)
    assert torch.equal(w1t[:, :PP], packed.mats["w1"].t()) and not w1t[:, PP:].any()
    wr0dt = t[2 * 256 * 128:].view(128, 128)
    assert torch.equal(wr0dt[:, :32], packed.mats["wr0d"].t()) and not wr0dt[:, 32:].any()


def test_packed_field_gives_points_their_gradient():
    """A packed field (fixed weights, as an occupancy bake or a teacher)
    still differentiates in the points and directions, and leaves the
    model's parameters without a gradient."""
    tm = NeRFModel(hidden_dim=256, generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    x = _t(rng.uniform(-1, 1, (40, 3)).astype(np.float32)).requires_grad_(True)
    d = _t(rng.normal(size=(40, 3)).astype(np.float32))
    rgb, sig = NerfField(tm).pack()(x, d)
    (rgb.sum() + sig.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is None for p in tm.parameters())


# ---------------------------------------------------------------- route

_RENDER = {"nerf": make_fused_nerf_render, "siren": make_fused_siren_render,
           "gabor": make_fused_gabor_render}
_APPLY = {"nerf": make_fused_nerf_apply, "siren": make_fused_siren_apply,
          "gabor": make_fused_gabor_apply, "kilonerf": make_fused_kilonerf_apply}
_MODELS = {"nerf": (NeRFModel, JaxNeRF), "siren": (SirenModel, JaxSiren),
           "gabor": (GaborModel, JaxGabor), "kilonerf": (KiloNeRFModel, JaxKilo)}


@pytest.mark.parametrize("family,kw,field,row", [
    ("nerf", dict(hidden_dim=32), "module", None),
    ("nerf", dict(hidden_dim=128), "module", None),
    ("nerf", dict(hidden_dim=256), NerfField, None),
    ("nerf", dict(hidden_dim=512), "raise", "row 1"),
    ("siren", dict(hidden_dim=256, num_layers=8), SirenField, None),
    ("siren", dict(hidden_dim=512, num_layers=8), "raise", "row 9"),
    ("siren", dict(hidden_dim=256, num_layers=4), "module", None),
    ("gabor", dict(hidden_dim=256), GaborField, None),
    ("gabor", dict(hidden_dim=512), "raise", "row 13"),
    ("kilonerf", dict(hidden_dim=32, grid_res=2), KiloNeRFField, None),
    ("kilonerf", dict(hidden_dim=256, grid_res=2), "module", None)])
def test_route_follows_nerf_tpu(monkeypatch, family, kw, field, row):
    """On the card, the port takes a fused render exactly where nerf_tpu's
    ``make_fused_*_render`` gives one (its own kernels where they cover the
    shape: hidden 256), and otherwise the field route, whose field is a
    field kernel where nerf_tpu's ``make_fused_*_apply`` gives one and the
    port's covers the shape (hidden 256), the module where nerf_tpu gives
    none, and a raise naming PERF.md's row where nerf_tpu takes a field
    kernel at a shape the port's do not cover (hidden 512). On
    the CPU the field is the module wherever nerf_tpu's is (KiloNeRF keeps
    its field's plain versions)."""
    cls, jcls = _MODELS[family]
    jm, tm = jcls(**kw), cls(**kw)
    tpu_render = family in _RENDER and _RENDER[family](jm, 2.0, 6.0,
                                                       interpret=True) is not None
    tpu_field = _APPLY[family](jm, interpret=True) is not None
    assert tpu_field == (field != "module")
    settings = RenderSettings()
    cpu_field = fused_field_for(tm)
    assert (cpu_field is tm) == (family != "kilonerf" or field == "module")
    monkeypatch.setattr(step_mod, "_on_card", lambda m: True)
    fr, fac = _kernel_route(tm, settings, True)
    assert (fr is not None) == tpu_render
    if tpu_render:
        # the port's render kernels cover hidden 256 (a NeRF at 512 raises
        # at launch, as the NotImplementedError of the shape guard)
        assert fr.supported() == (kw["hidden_dim"] == 256)
    else:
        assert fac is fused_field_for
    if field == "raise":
        with pytest.raises(NotImplementedError, match=re.escape(f"PERF.md {row} ")):
            fused_field_for(tm)
    elif field == "module":
        assert fused_field_for(tm) is tm
    else:
        assert type(fused_field_for(tm)) is field
