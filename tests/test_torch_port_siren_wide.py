"""The SIREN kernels at the wider shapes nerf_tpu's take (PERF.md rows 6-10
at hidden 512-1024 and with a wider direction encoding), on the CPU: the
port's plain versions of rows 6, 8 and 7 (forward render, train pass,
render backward) and 9 and 10 (field forward and backward: the field's
VJP, weights, points and directions) at hidden 512, at lego_siren.txt's
direction encoding (L_d = 4, d_pad 32) in float32 and at L_d = 6 (d_pad 64)
in bfloat16, against nerf_tpu's Pallas SIREN kernels in interpret mode;
weights carried across by ``load_jax_params``, inputs from numpy seeds (8
rays x 16 samples, 96 field points), t fixed by the seed. Each shape's plan
is held in test_torch_port_kernel_plans.py.

Tolerances, those of the hidden-256 SIREN comparisons
(test_torch_port_siren_kernels.py, test_torch_port_siren_gabor_field.py).
float32: the same arithmetic with sums in another order and XLA's sine
against torch's; the render outputs within 1e-5 (depth 2e-5), the loss
2e-6 relative, the render gradients 2e-4 of their max; the field's rgb
1e-5, sigma 1e-4 / 15 of its max and its gradients 1e-4 of their max
(measured at hidden 512: outputs 1.6e-6, depth 1.2e-6, loss 3.0e-7
relative, render gradients 5.0e-6 of their max, field rgb 2.4e-7, sigma
6.8e-7 of its max, field gradients 2.2e-6). bfloat16: XLA evaluates the
degree-11 sine with other roundings than the port, a flipped bf16 rounding
is carried through the sine layers and w0 = 30 and sigma_mul = 10 magnify
it: the render outputs
within 1e-2, the loss 2e-3 relative, the render gradients 0.1 of their max
and 0.05 relative Frobenius; the field's rgb 1e-2, sigma 1e-2 of its max,
its gradients 0.05 of their max and 0.02 Frobenius (measured at hidden 512
with L_d = 6: outputs 1.6e-3, depth 5.5e-4, loss 2.6e-4 relative, render
gradients 7.9e-3 of their max and 6.4e-3 Frobenius, field rgb 9.2e-4,
sigma 1.1e-3 of its max, field gradients 6.0e-3 and 4.2e-3 Frobenius).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.siren import SirenModel as JaxSiren
from nerf_tpu.ops.pallas.fused_render_siren import make_fused_siren_render as jax_fused
from nerf_tpu.ops.pallas.fused_siren import make_fused_siren_apply

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
from nerf_tpu_torch.ops.cuda.fused_siren import SirenField

NEAR, FAR = 2.0, 6.0
# the render: (outputs, depth, loss relative, gradient of its max, Frobenius)
RENDER_TOL = {"float32": (1e-5, 2e-5, 2e-6, 2e-4, None),
              "bfloat16": (1e-2, 2e-2, 2e-3, 0.1, 0.05)}
# the field: (rgb, sigma of its max, gradient of its max, Frobenius)
FIELD_TOL = {"float32": (1e-5, 1e-4 / 15, 1e-4, None),
             "bfloat16": (1e-2, 1e-2, 0.05, 0.02)}
R, S, N = 8, 16, 96


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=[(512, 4, "float32"), (512, 6, "bfloat16")],
                ids=["h512-float32", "h512-Ld6-bfloat16"])
def case(request):
    """nerf_tpu's Pallas SIREN kernels (interpret mode) and the port's plain
    versions on the same weights and inputs: the forward render, the train
    pass's loss and gradients, the gradients through the forward render's
    custom VJP (rgb, acc and depth terms), and the field's outputs and VJP
    (weights, points, directions)."""
    h, ld, cdt = request.param
    jm = JaxSiren(hidden_dim=h, dir_encoding_dim=ld, compute_dtype=cdt)
    params = jm.init(jax.random.key(24))

    def port_model():
        tm = SirenModel(hidden_dim=h, dir_encoding_dim=ld, compute_dtype=cdt)
        load_jax_params(tm, jax.tree.map(np.asarray, params))
        return tm

    rng = np.random.default_rng(24)
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
    fused = make_fused_siren_apply(jm, tile_fwd=32, tile_bwd=32, interpret=True)

    def field_loss_j(p, x, dd):
        r, s = fused(p, x, dd)
        return jnp.sum(r * cot[:, :3]) + jnp.sum(s * cot[:, 3])

    field_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    gfield_j = jax.grad(field_loss_j, argnums=(0, 1, 2))(params, jnp.asarray(pts),
                                                         jnp.asarray(d))

    tm = port_model()
    fr = FusedSirenRender(tm, NEAR, FAR)
    assert fr.supported() and fr.plan.tag == f"h{h}d{32 if ld == 4 else 64}"
    ray_t = tuple(_t(x) for x in (ro, rd, rd, t))
    before = (FusedSirenRender.launches, FusedSirenRender.train_launches,
              FusedSirenRender.bwd_launches, SirenField.launches, SirenField.bwd_launches)
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
    field = SirenField(tm)
    assert field.supported() and field.plan == fr.plan
    rgb, sig = field(x, dd)
    (torch.sum(rgb * _t(cot)[:, :3]) + torch.sum(sig * _t(cot)[:, 3])).backward()
    # the CPU route is the plain versions: no kernel launched
    assert before == (FusedSirenRender.launches, FusedSirenRender.train_launches,
                      FusedSirenRender.bwd_launches, SirenField.launches,
                      SirenField.bwd_launches)
    return dict(cdt=cdt, fwd=(fwd, fwd_j), train=(float(loss.detach()), aux, float(loss_j),
                                                  aux_j), gtrain=(gtrain, gtrain_j),
                gbwd=(gbwd, gbwd_j),
                field=((rgb.detach().numpy(), sig.detach().numpy()), field_j),
                gfield=((export_jax_grads(tm), x.grad.numpy(), dd.grad.numpy()),
                        gfield_j))


def _assert_grad(a, b, tol, fro, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.abs(b).max()), err_msg=what)
    if fro is not None:
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert rel < fro, (what, rel)


def _assert_tree(got, ref, tol, fro):
    for i, (g, r) in enumerate(zip(got["base"], ref["base"])):
        for k in ("w", "b"):
            _assert_grad(g[k], r[k], tol, fro, f"base[{i}].{k}")
    for n in ("sigma", "remap", "rgb0", "rgb1"):
        for k in ("w", "b"):
            _assert_grad(got[n][k], ref[n][k], tol, fro, f"{n}.{k}")


def test_row6_forward_render_matches_pallas(case):
    """Row 6: rgb, acc and the weights within the output tolerance, depth
    within its own, of the Pallas forward render."""
    got, ref = case["fwd"]
    tol, tol_depth = RENDER_TOL[case["cdt"]][:2]
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), rtol=0,
                               atol=tol_depth)


def test_row8_train_pass_matches_pallas(case):
    """Row 8: the loss (relative), rgb, acc and weights within the output
    tolerance, every weight gradient within the gradient tolerance."""
    tol, _, loss_tol, gtol, fro = RENDER_TOL[case["cdt"]]
    loss, aux, loss_j, aux_j = case["train"]
    np.testing.assert_allclose(loss, loss_j, rtol=loss_tol)
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]), rtol=0, atol=tol,
                                   err_msg=k)
    _assert_tree(*case["gtrain"], gtol, fro)


def test_row7_render_backward_matches_pallas(case):
    """Row 7: the gradients of a loss on rgb, acc and depth through the
    forward render, against jax.grad through the Pallas render's custom
    VJP (its backward kernel)."""
    _, _, _, gtol, fro = RENDER_TOL[case["cdt"]]
    _assert_tree(*case["gbwd"], gtol, fro)


def test_row9_field_forward_matches_pallas(case):
    """Row 9: rgb and sigma (over its max) of 96 points within the field
    tolerances."""
    (rgb, sig), (rgb_j, sig_j) = case["field"]
    tol_rgb, tol_sig = FIELD_TOL[case["cdt"]][:2]
    assert rgb.shape == (N, 3) and sig.shape == (N,)
    np.testing.assert_allclose(rgb, np.asarray(rgb_j), rtol=0, atol=tol_rgb)
    np.testing.assert_allclose(sig, np.asarray(sig_j), rtol=0,
                               atol=tol_sig * float(np.abs(np.asarray(sig_j)).max()))


def test_row10_field_backward_matches_pallas(case):
    """Row 10: the weight gradients and the point and direction cotangents
    of sum(cot * [rgb, sigma]) against the Pallas field's VJP."""
    (gw, gx, gd), (gw_j, gx_j, gd_j) = case["gfield"]
    _, _, gtol, fro = FIELD_TOL[case["cdt"]]
    _assert_tree(gw, jax.tree.map(np.asarray, gw_j), gtol, fro)
    _assert_grad(gx, gx_j, gtol, fro, "points")
    _assert_grad(gd, gd_j, gtol, fro, "directions")
