"""The port's GaborNet render and train pass (CPU: their plain versions)
against the JAX package's Pallas kernels in interpret mode
(``nerf_tpu/ops/pallas/fused_render_gabor.py``), run as
``tests/test_fused_render.py`` runs them.

Inputs come from numpy seeds: camera-like rays from z = 4 toward the
origin, stratified t, random targets. Hidden 256 is the width the Pallas
kernels take; the depth is cut to 2-4 stages and the batches to 5-6 rays x
8-16 samples (odd S, ray counts that are not tile multiples). Every
gradient tensor, the filters' (omega, phi, mu, gamma) included, is compared
with ``atol = tol * max|g_ref|``.

Tolerances, with the worst errors measured over two seeds of each case.
The prep (the per-ray coefficients) is the same arithmetic on both sides:
equal to 1e-6 of the max (measured 0). Forward outputs: float32 1e-5
(measured 7.2e-7; 2e-5 on depth), bfloat16 1e-4 (measured 3.2e-6, depth
1.4e-5: the port's fast sine rounds as written, XLA's the other way in
the last bit). Loss: 2e-6 relative in float32 (measured 2.6e-7), 5e-5 in
bfloat16 (measured 5.4e-6). Gradients: 2e-2 of the max in both dtypes
(measured 5.6e-3 float32 / 6.2e-3 bfloat16, both on the density bias bs,
one sum over every sample of terms that cancel; every other tensor within
1e-3), the max floored at 1e-2 of the largest gradient element of the
model: at init the last stage's z is tiny (a product of filters), so the
density row's gradient is 1e-5 of the others' and a flipped bf16 rounding
moved ws by 5.7e-2 of its own max (bfloat16, seed 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.gabor import GaborModel as JaxGabor
from nerf_tpu.ops.pallas.fused_render_gabor import make_fused_gabor_render as jax_fused
from nerf_tpu.ops.pallas.fused_render_gabor import pack_params as jax_pack_params

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.ops.cuda.fused_render import DP, _encode
from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
    FusedGaborRender,
    cast_packed,
    fused_gabor_render_plain,
    fused_gabor_train_plain,
    gabor_coeffs,
    grad_views,
    pack_f32,
    stack_filters,
)

NEAR, FAR = 2.0, 6.0
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
LOSS_RTOL = {"float32": 2e-6, "bfloat16": 5e-5}
GRAD_TOL = 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(cdt, n, num_rays, num_samples, seed):
    jm = JaxGabor(hidden_dim=256, num_layers=n, compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = GaborModel(hidden_dim=256, num_layers=n, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    ro = (rng.uniform(-0.5, 0.5, (num_rays, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    edges = np.linspace(NEAR, FAR, num_samples + 1)
    t = (edges[:-1] + rng.uniform(0, 1, (num_rays, num_samples))
         * (edges[1:] - edges[:-1])).astype(np.float32)
    tgt = rng.uniform(0, 1, (num_rays, 3)).astype(np.float32)
    return jm, params, tm, ro, rd, t, tgt


def _leaves(tree):
    """(name, array) of a GaborNet pytree, by name."""
    out = [(f"filters[{i}].{k}", f[k]) for i, f in enumerate(tree["filters"])
           for k in ("omega", "phi", "mu", "gamma")]
    out += [(f"linears[{i}].{k}", lyr[k]) for i, lyr in enumerate(tree["linears"])
            for k in ("w", "b")]
    return out + [(f"{n}.{k}", tree[n][k]) for n in ("sigma", "remap", "rgb0", "rgb1")
                  for k in ("w", "b")]


def _scale(ref: np.ndarray, floor: float) -> float:
    """A gradient tensor's scale: its max, floored at 1e-2 of the model's
    largest gradient element (the density row ws and bias bs are sums over
    every sample of terms that cancel, at init many orders below the
    others)."""
    return max(float(np.abs(ref).max()), floor)


def _assert_grads(got_tree, ref_tree, tol=GRAD_TOL):
    floor = 1e-2 * max(float(np.abs(np.asarray(b)).max()) for _, b in _leaves(ref_tree))
    for (name, a), (_, b) in zip(_leaves(got_tree), _leaves(ref_tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * _scale(b, floor),
                                   err_msg=name)


def test_pack_layout_matches_pack_params():
    """The float32 packing holds fused_render_gabor.py::pack_params's
    arrays (ws as a row, wr0 split, wr0d padded to 32 rows, wr1/br1 to 8)."""
    _, params, tm, *_ = _case("float32", 3, 2, 2, seed=0)
    ref = {k: np.asarray(v) for k, v in jax_pack_params(params, 32, 256).items()}
    with torch.no_grad():
        packed = cast_packed(*pack_f32(tm), torch.float32, 256, 3)
    got = {**packed.mats, **packed.vecs}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy().reshape(v.shape), v, err_msg=k)


def test_coefficients_match_prep():
    """gabor_coeffs (batched over the stages) against FusedGaborRender._prep
    (stage by stage), and the plain versions' direction encoding against
    the prep's denc."""
    jm, params, tm, ro, rd, *_ = _case("float32", 3, 6, 4, seed=1)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    prepf, denc = fr_j._prep(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd))
    fr = FusedGaborRender(tm, NEAR, FAR)
    with torch.no_grad():
        coeffs = gabor_coeffs(*stack_filters(tm), *fr.affine(_t(ro), _t(rd)))
    coeffs = coeffs.view(5, 6, 3, 256).numpy()
    for k, name in enumerate("ABPQR"):
        for i in range(3):
            ref = np.asarray(prepf[name][i])
            np.testing.assert_allclose(coeffs[k][:, i], ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"{name}{i}")
    np.testing.assert_allclose(_encode(_t(rd), 4, DP, torch.sin).numpy(),
                               np.asarray(denc), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cdt,n,num_rays,num_samples",
                         [("float32", 2, 6, 16), ("bfloat16", 3, 6, 8)])
def test_forward_matches_pallas_interpret(cdt, n, num_rays, num_samples):
    jm, params, tm, ro, rd, t, _ = _case(cdt, n, num_rays, num_samples, seed=2)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    ref = fr_j(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
               jnp.asarray(t))
    fr = FusedGaborRender(tm, NEAR, FAR)
    before = FusedGaborRender.launches
    with torch.no_grad():
        got = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
    assert FusedGaborRender.launches == before          # CPU: plain version
    for k in ("rgb", "acc", "depth", "weights"):
        scale = 2.0 if k == "depth" else 1.0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=FWD_TOL[cdt] * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("cdt,n,num_rays,num_samples",
                         [("float32", 2, 6, 13), ("bfloat16", 3, 5, 16)])
def test_train_pass_matches_pallas_interpret(cdt, n, num_rays, num_samples, white_bg):
    """jax.grad of fr.train (the Pallas train kernel's weight gradients and
    dA..dR, completed through the prep by autodiff) against loss.backward()
    (the plain train pass's, completed through the prep by autograd)."""
    jm, params, tm, ro, rd, t, tgt = _case(cdt, n, num_rays, num_samples, seed=3)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)

    def loss_j(p):
        return fr_j.train(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
                          jnp.asarray(t), jnp.asarray(tgt), white_bg)

    (lj, aux_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    fr = FusedGaborRender(tm, NEAR, FAR)
    before = FusedGaborRender.train_launches
    loss, aux = fr.train(tm, _t(ro), _t(rd), _t(rd), _t(t), _t(tgt), white_bg)
    assert FusedGaborRender.train_launches == before
    assert not aux["weights"].requires_grad and loss.requires_grad
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=LOSS_RTOL[cdt])
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]),
                                   atol=FWD_TOL[cdt], err_msg=k)
    for p in tm.parameters():
        assert p.grad.dtype == torch.float32
    _assert_grads(export_jax_grads(tm), g_j)


def test_plain_train_pass_is_the_gradient_of_the_plain_forward():
    """The hand-written backward of fused_gabor_train_plain (weight
    gradients and dA..dR) against autograd through fused_gabor_render_plain
    and the MSE, float32 at hidden 64 with 3 stages: the same function
    differentiated two ways, so 1e-4 of each tensor's max (sums in another
    order)."""
    tm = GaborModel(hidden_dim=64, num_layers=3,
                    generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    ro = _t((rng.uniform(-0.5, 0.5, (5, 3)) + [0.0, 0.0, 4.0]).astype(np.float32))
    rd = torch.nn.functional.normalize(_t(rng.normal(size=(5, 3)).astype(np.float32))
                                       * 0.2 + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    t = torch.sort(_t(rng.uniform(NEAR, FAR, (5, 11)).astype(np.float32)), -1).values
    tgt = _t(rng.uniform(0, 1, (5, 3)).astype(np.float32))
    fr = FusedGaborRender(tm, NEAR, FAR)
    wflat, vec = (x.detach().requires_grad_() for x in pack_f32(tm))
    with torch.no_grad():
        coeffs = gabor_coeffs(*stack_filters(tm), *fr.affine(ro, rd))
    coeffs.requires_grad_()
    packed = cast_packed(wflat, vec, torch.float32, 64, 3)
    rgb, acc, _, _ = fused_gabor_render_plain(packed, coeffs, rd, t, fr.consts)
    loss = torch.mean((rgb + (1.0 - acc[:, None]) - tgt) ** 2)
    loss.backward()
    with torch.no_grad():
        loss2, *_, (gw, gv), dcoef = fused_gabor_train_plain(
            packed, coeffs, rd, t, tgt, True, fr.consts)
    torch.testing.assert_close(loss2, loss.detach(), rtol=1e-6, atol=0)
    got = {**grad_views(gw, gv, 64, 3), **{f"d{k}": dcoef[i] for i, k in enumerate("ABPQR")}}
    ref = {**grad_views(wflat.grad, vec.grad, 64, 3),
           **{f"d{k}": coeffs.grad[i] for i, k in enumerate("ABPQR")}}
    floor = 1e-2 * max(float(r.abs().max()) for r in ref.values())
    for k, r in ref.items():
        torch.testing.assert_close(got[k], r, rtol=0, atol=1e-4 * _scale(r.numpy(), floor),
                                   msg=k)


def test_supported_shapes_and_forward_only_render():
    """The kernels take hidden 256 to 1024 with the direction encoding
    padded to at most 64 columns and any depth (gabor_plan.covered; the
    plain versions any width and depth); the forward render has no
    gradient, as in nerf_tpu."""
    for kw in ({}, {"num_layers": 4}, {"hidden_dim": 512}, {"dir_encoding_dim": 10}):
        assert FusedGaborRender(GaborModel(**kw), NEAR, FAR).supported()
    for kw in ({"hidden_dim": 128}, {"hidden_dim": 1280}, {"dir_encoding_dim": 11}):
        fr = FusedGaborRender(GaborModel(**kw), NEAR, FAR)
        assert not fr.supported()
        assert "hidden 256 to 1024" in fr._unsupported()
        assert "ROADMAP.md queue 2" in fr._unsupported()
    tm = GaborModel(hidden_dim=32, num_layers=2)
    fr = FusedGaborRender(tm, NEAR, FAR)
    ro, rd = torch.zeros(2, 3) + 4.0, torch.tensor([[0.0, 0.0, -1.0]] * 2)
    t = torch.linspace(NEAR, FAR, 4).expand(2, 4).contiguous()
    with pytest.raises(NotImplementedError, match="forward-only"):
        fr(tm, ro, rd, rd, t)
    with torch.no_grad():
        out = fr(tm, ro, rd, rd, t)
    assert out["rgb"].shape == (2, 3) and torch.isfinite(out["rgb"]).all()
