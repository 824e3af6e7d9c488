"""The NeRF kernels at the wider shapes nerf_tpu's take (PERF.md rows 1-5
at hidden 512-1024 and with wider encodings), on the CPU: the port's plain
versions of rows 3, 5 and 4 (forward render, train pass, render backward)
and 1 and 2 (field forward and backward) at hidden 512, at lego.txt's
encodings in float32 and at L = 12 / 6 (p_pad 128, d_pad 64) in bfloat16,
against nerf_tpu's Pallas kernels in interpret mode; weights carried across
by ``load_jax_params``, inputs from numpy seeds (8 rays x 16 samples, 96
field points). Each shape's plan is held in test_torch_port_kernel_plans.py.

Tolerances. Outputs as the hidden-256 comparisons (test_torch_port_render,
test_torch_port_train_kernels): 1e-5 in float32 and 1e-4 in bfloat16, depth
1e-4 / 1e-3 (measured at hidden 512: 2.4e-7 and 2.3e-5). Gradients, atol =
tol x max|g| and a bound on the relative Frobenius norm: in bfloat16 0.25
and 0.05, as at hidden 256 (one flipped bf16 rounding of a dz is carried
through nine layers; measured 0.121 and 0.040, the field's first layers).
In float32 2e-2 and 5e-3 where hidden 256 holds 2e-3: a pre-activation
within an ulp of zero takes another ReLU mask in the two frameworks, and
at hidden 512 one such point of 96 moves the field's third-layer gradient
by 1.3e-2 of its max (Frobenius 1.9e-3); the train pass's worst is 2.0e-3
(4.8e-4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.ops.pallas.fused_nerf import make_fused_nerf_apply
from nerf_tpu.ops.pallas.fused_render import make_fused_nerf_render as jax_fused

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender

NEAR, FAR = 2.0, 6.0
FWD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 1e-3)}
GRAD_TOL = {"float32": (2e-2, 5e-3), "bfloat16": (0.25, 0.05)}
R, S, N = 8, 16, 96


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- against Pallas


@pytest.fixture(scope="module", params=[(512, 10, 4, "float32"), (512, 12, 6, "bfloat16")],
                ids=["h512-float32", "h512-L12-6-bfloat16"])
def case(request):
    """nerf_tpu's Pallas kernels (interpret mode) and the port's plain
    versions on the same weights and inputs: the forward render, the train
    pass's loss and gradients, the gradients through the forward render's
    custom VJP (rgb, acc and depth terms), and the field's outputs and VJP
    (weights, points, directions)."""
    h, lp, ld, cdt = request.param
    jm = JaxNeRF(hidden_dim=h, pos_encoding_dim=lp, dir_encoding_dim=ld, compute_dtype=cdt)
    params = jm.init(jax.random.key(23))

    def port_model():
        tm = NeRFModel(hidden_dim=h, pos_encoding_dim=lp, dir_encoding_dim=ld,
                       compute_dtype=cdt)
        load_jax_params(tm, jax.tree.map(np.asarray, params))
        return tm

    rng = np.random.default_rng(23)
    ro = (rng.uniform(-0.5, 0.5, (R, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    edges = np.linspace(NEAR, FAR, S + 1)
    t = (edges[:-1] + rng.uniform(0, 1, (R, S)) * (edges[1:] - edges[:-1])).astype(np.float32)
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cot = rng.normal(size=(N, 4)).astype(np.float32)
    ray = tuple(jnp.asarray(x) for x in (ro, rd, rd, t))

    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    fwd_j = fr_j(params, *ray)
    (loss_j, aux_j), gtrain_j = jax.value_and_grad(
        lambda p: fr_j.train(p, *ray, jnp.asarray(tgt), True), has_aux=True)(params)

    def render_loss_j(p):
        out = fr_j(p, *ray)
        return (jnp.sum((out["rgb"] - tgt) ** 2) + 0.3 * jnp.sum(out["acc"] ** 2)
                + 0.05 * jnp.sum(out["depth"]))

    gbwd_j = jax.grad(render_loss_j)(params)
    fused = make_fused_nerf_apply(jm, tile_fwd=32, tile_bwd=32, interpret=True)

    def field_loss_j(p, x, dd):
        r, s = fused(p, x, dd)
        return jnp.sum(r * cot[:, :3]) + jnp.sum(s * cot[:, 3])

    field_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    gfield_j = jax.grad(field_loss_j, argnums=(0, 1, 2))(params, jnp.asarray(pts),
                                                         jnp.asarray(d))

    tm = port_model()
    fr = FusedNerfRender(tm, NEAR, FAR)
    assert fr.supported() and fr.plan.h == h
    ray_t = tuple(_t(x) for x in (ro, rd, rd, t))
    with torch.no_grad():
        fwd = fr(tm, *ray_t)
    loss, aux = fr.train(tm, *ray_t, _t(tgt), True)
    loss.backward()
    gtrain = export_jax_grads(tm)
    tm = port_model()
    out = fr(tm, *ray_t)
    (torch.sum((out["rgb"] - _t(tgt)) ** 2) + 0.3 * torch.sum(out["acc"] ** 2)
     + 0.05 * torch.sum(out["depth"])).backward()
    gbwd = export_jax_grads(tm)
    tm = port_model()
    x, dd = _t(pts).requires_grad_(True), _t(d).requires_grad_(True)
    field = NerfField(tm)
    assert field.supported()
    rgb, sig = field(x, dd)
    (torch.sum(rgb * _t(cot)[:, :3]) + torch.sum(sig * _t(cot)[:, 3])).backward()
    return dict(cdt=cdt, fwd=(fwd, fwd_j), train=(float(loss.detach()), aux, float(loss_j),
                                                  aux_j), gtrain=(gtrain, gtrain_j),
                gbwd=(gbwd, gbwd_j),
                field=((rgb.detach().numpy(), sig.detach().numpy()), field_j),
                gfield=((export_jax_grads(tm), x.grad.numpy(), dd.grad.numpy()),
                        gfield_j))


def _assert_grad(a, b, cdt, what):
    tol, fro = GRAD_TOL[cdt]
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.abs(b).max()), err_msg=what)
    if fro is not None:
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert rel < fro, (what, rel)


def _assert_tree(got, ref, cdt):
    for blk in ("block1", "block2", "rgb"):
        for i, (g, r) in enumerate(zip(got[blk], ref[blk])):
            for k in ("w", "b"):
                _assert_grad(g[k], r[k], cdt, f"{blk}[{i}].{k}")


def test_row3_forward_render_matches_pallas(case):
    """Row 3: rgb, acc and the weights within 1e-5 / 1e-4, depth within
    1e-4 / 1e-3 of the Pallas forward render."""
    got, ref = case["fwd"]
    tol, tol_depth = FWD_TOL[case["cdt"]]
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), rtol=0,
                               atol=tol_depth)


def test_row5_train_pass_matches_pallas(case):
    """Row 5: the loss (relative), rgb, acc and weights within the forward
    tolerance, every weight gradient within the gradient tolerance."""
    cdt = case["cdt"]
    loss, aux, loss_j, aux_j = case["train"]
    tol = FWD_TOL[cdt][0]
    np.testing.assert_allclose(loss, loss_j, rtol=tol)
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]), rtol=0, atol=tol,
                                   err_msg=k)
    _assert_tree(*case["gtrain"], cdt)


def test_row4_render_backward_matches_pallas(case):
    """Row 4: the gradients of a loss on rgb, acc and depth through the
    forward render, against jax.grad through the Pallas render's custom
    VJP (its backward kernel)."""
    _assert_tree(*case["gbwd"], case["cdt"])


def test_row1_field_forward_matches_pallas(case):
    """Row 1: rgb and sigma of 96 points within the forward tolerance (the
    depth one for sigma)."""
    (rgb, sig), (rgb_j, sig_j) = case["field"]
    tol, tol_sig = FWD_TOL[case["cdt"]]
    np.testing.assert_allclose(rgb, np.asarray(rgb_j), rtol=0, atol=tol)
    np.testing.assert_allclose(sig, np.asarray(sig_j), rtol=0, atol=tol_sig)


def test_row2_field_backward_matches_pallas(case):
    """Row 2: the weight gradients and the point and direction cotangents
    of sum(cot * [rgb, sigma]) against the Pallas field's VJP."""
    (gw, gx, gd), (gw_j, gx_j, gd_j) = case["gfield"]
    cdt = case["cdt"]
    _assert_tree(gw, jax.tree.map(np.asarray, gw_j), cdt)
    _assert_grad(gx, gx_j, cdt, "points")
    _assert_grad(gd, gd_j, cdt, "directions")
