"""The GaborNet kernels at the wider shapes nerf_tpu's take (PERF.md rows
11-14 at hidden 512-1024, with a wider direction encoding and at other
depths), on the CPU: the port's plain versions of rows 11 and 12 (forward
render, train pass with the coefficient cotangents completed through the
prep) and 13 and 14 (field forward and its VJP: weights, filter banks,
points, directions) at hidden 512 with lego_siren.txt's direction encoding
(L_d = 4, d_pad 32) in float32 and with L_d = 6 (d_pad 64) in bfloat16,
both of 3 stages (an odd depth ends its stages in the other activation
buffer), and at hidden 256 with 4 stages in bfloat16 and with one stage
(nerf_tpu's loops run at n = 1 too) in float32, against nerf_tpu's
Pallas GaborNet kernels in interpret mode; weights carried across by
``load_jax_params``, inputs from numpy seeds (6 rays x 13 samples, 96 field
points). Each shape's plan is held in test_torch_port_kernel_plans.py.

Tolerances, those of the hidden-256 GaborNet comparisons
(test_torch_port_gabor_kernels.py, test_torch_port_siren_gabor_field.py).
The render: outputs 1e-5 in float32 (depth 2e-5) and 1e-4 in bfloat16
(depth 2e-4), the loss 2e-6 / 5e-5 relative, every gradient (the filters'
through the prep too) 2e-2 of its max floored at 1e-2 of the largest;
measured 1.2e-7 / 3.8e-6 on the outputs (depth 2.4e-7 / 7.6e-6), the loss
7.2e-8 / 2.8e-6 relative, the gradients 3.0e-5 / 2.5e-5 of their max. The field:
rgb 1e-5 / 1e-3, sigma 1e-4 / 15 and 1e-3 of its max (the GaborNet's),
every gradient (weights, filter banks, points, directions) 1e-4 of its max
in float32 and in bfloat16 0.05 of its max and 0.02 relative Frobenius (the
SIREN's: at hidden 512 with d_pad 64 the rgb head's 512 + 64 products flip
more bf16 roundings of y than at 256, and a flipped ReLU mask moves one
point's share of a sum over 96 points); measured rgb 6.0e-8 / 2.7e-5,
sigma 1.3e-7 / 5.7e-5 of its max, gradients 1.4e-6 / 3.7e-2 of their max
(rgb0.b; the direction cotangent 2.1e-2) and 8.5e-3 Frobenius in
bfloat16; the same d_pad-64 shape in float32 agrees within 1.2e-6. (Worst
over the four cases; float32 / bfloat16.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.gabor import GaborModel as JaxGabor
from nerf_tpu.ops.pallas.fused_gabor import make_fused_gabor_apply
from nerf_tpu.ops.pallas.fused_render_gabor import make_fused_gabor_render as jax_fused

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender

NEAR, FAR = 2.0, 6.0
# the render: (outputs, loss relative, gradient of its max)
RENDER_TOL = {"float32": (1e-5, 2e-6, 2e-2), "bfloat16": (1e-4, 5e-5, 2e-2)}
# the field: (rgb, sigma of its max, gradient of its max, Frobenius)
FIELD_TOL = {"float32": (1e-5, 1e-4 / 15, 1e-4, None),
             "bfloat16": (1e-3, 1e-3, 0.05, 0.02)}
R, S, N = 6, 13, 96
CASES = [(512, 4, 3, "float32"), (512, 6, 3, "bfloat16"), (256, 4, 4, "bfloat16"),
         (256, 4, 1, "float32")]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=CASES,
                ids=["h512-n3-float32", "h512-Ld6-n3-bfloat16", "h256-n4-bfloat16",
                     "h256-n1-float32"])
def case(request):
    """nerf_tpu's Pallas GaborNet kernels (interpret mode) and the port's
    plain versions on the same weights and inputs: the forward render, the
    train pass's loss and gradients (the filters' through the prep), and
    the field's outputs and VJP (weights, filter banks, points,
    directions)."""
    h, ld, n, cdt = request.param
    jm = JaxGabor(hidden_dim=h, dir_encoding_dim=ld, num_layers=n, compute_dtype=cdt)
    params = jm.init(jax.random.key(25))

    def port_model():
        tm = GaborModel(hidden_dim=h, dir_encoding_dim=ld, num_layers=n, compute_dtype=cdt)
        load_jax_params(tm, jax.tree.map(np.asarray, params))
        return tm

    rng = np.random.default_rng(25)
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
    fused = make_fused_gabor_apply(jm, tile_fwd=32, tile_bwd=32, interpret=True)

    def field_loss_j(p, x, dd):
        r, s = fused(p, x, dd)
        return jnp.sum(r * cot[:, :3]) + jnp.sum(s * cot[:, 3])

    field_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    gfield_j = jax.grad(field_loss_j, argnums=(0, 1, 2))(params, jnp.asarray(pts),
                                                         jnp.asarray(d))

    tm = port_model()
    fr = FusedGaborRender(tm, NEAR, FAR)
    assert fr.supported() and fr.plan.tag == f"h{h}d{32 if ld == 4 else 64}n{n}"
    ray_t = tuple(_t(x) for x in (ro, rd, rd, t))
    before = (FusedGaborRender.launches, FusedGaborRender.train_launches,
              GaborField.launches, GaborField.bwd_launches)
    with torch.no_grad():
        fwd = fr(tm, *ray_t)
    loss, aux = fr.train(tm, *ray_t, _t(tgt), True)
    loss.backward()
    gtrain = export_jax_grads(tm)
    tm = port_model()
    x, dd = _t(pts).requires_grad_(True), _t(d).requires_grad_(True)
    field = GaborField(tm)
    assert field.supported() and field.plan == fr.plan
    rgb, sig = field(x, dd)
    (torch.sum(rgb * _t(cot)[:, :3]) + torch.sum(sig * _t(cot)[:, 3])).backward()
    # the CPU route is the plain versions: no kernel launched
    assert before == (FusedGaborRender.launches, FusedGaborRender.train_launches,
                      GaborField.launches, GaborField.bwd_launches)
    return dict(cdt=cdt, fwd=(fwd, fwd_j),
                train=(float(loss.detach()), aux, float(loss_j), aux_j),
                gtrain=(gtrain, gtrain_j),
                field=((rgb.detach().numpy(), sig.detach().numpy()), field_j),
                gfield=((export_jax_grads(tm), x.grad.numpy(), dd.grad.numpy()), gfield_j))


def _leaves(tree):
    """(name, array) of a GaborNet pytree, by name."""
    out = [(f"filters[{i}].{k}", f[k]) for i, f in enumerate(tree["filters"])
           for k in ("omega", "phi", "mu", "gamma")]
    out += [(f"linears[{i}].{k}", lyr[k]) for i, lyr in enumerate(tree.get("linears", []))
            for k in ("w", "b")]           # none at one stage
    return out + [(f"{m}.{k}", tree[m][k]) for m in ("sigma", "remap", "rgb0", "rgb1")
                  for k in ("w", "b")]


def _assert_tree(got, ref, tol, fro=None, floored=False):
    """Every leaf within ``tol`` of its max (floored at 1e-2 of the tree's
    largest element where ``floored``), and within ``fro`` relative
    Frobenius norm where given."""
    leaves = [(name, np.asarray(a), np.asarray(b))
              for (name, a), (_, b) in zip(_leaves(got), _leaves(ref))]
    floor = 1e-2 * max(float(np.abs(b).max()) for *_, b in leaves) if floored else 0.0
    for name, a, b in leaves:
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(float(np.abs(b).max()), floor),
                                   err_msg=name)
        if fro is not None and np.linalg.norm(b) > 0:
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < fro, name


def test_wide_forward_render_matches_pallas_interpret(case):
    tol = RENDER_TOL[case["cdt"]][0]
    got, ref = case["fwd"]
    for k in ("rgb", "acc", "depth", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=tol * (2.0 if k == "depth" else 1.0), err_msg=k)


def test_wide_train_pass_matches_pallas_interpret(case):
    """The loss, rgb, acc and weights of the train pass, and every gradient
    (the 23-style weight layout at this depth, the filters' through the
    prep)."""
    tol, loss_rtol, gtol = RENDER_TOL[case["cdt"]]
    loss, aux, loss_j, aux_j = case["train"]
    np.testing.assert_allclose(loss, loss_j, rtol=loss_rtol)
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]), rtol=0, atol=tol,
                                   err_msg=k)
    _assert_tree(*case["gtrain"], gtol, floored=True)


def test_wide_field_matches_pallas_interpret(case):
    """The field's rgb and sigma, and its VJP: every weight and filter-bank
    gradient, the point and direction cotangents."""
    tol_rgb, tol_sig, gtol, fro = FIELD_TOL[case["cdt"]]
    (rgb, sig), (rgb_j, sig_j) = case["field"]
    np.testing.assert_allclose(rgb, np.asarray(rgb_j), rtol=0, atol=tol_rgb)
    np.testing.assert_allclose(sig, np.asarray(sig_j), rtol=0,
                               atol=tol_sig * float(np.abs(np.asarray(sig_j)).max()))
    (gw, gx, gd), (gw_j, gx_j, gd_j) = case["gfield"]
    _assert_tree(gw, jax.tree.map(np.asarray, gw_j), gtol, fro)
    for a, b, what in ((gx, gx_j, "points"), (gd, gd_j, "dirs")):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=gtol * float(np.abs(b).max()),
                                   err_msg=what)
        if fro is not None:
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < fro, what
