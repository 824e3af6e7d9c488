"""The port's SIREN render, train pass and render backward (CPU: their plain
versions) against the JAX package's Pallas kernels in interpret mode
(``nerf_tpu/ops/pallas/fused_render_siren.py``), run as
``tests/test_fused_render.py`` runs them.

Inputs come from numpy seeds: camera-like rays from z = 4 toward the
origin, stratified t, random targets. Hidden 256 is the width the fused
kernels take, so the ray and sample counts stay small (6-12 rays, S in
{8, 13, 16, 24}: odd S and ray counts that are not tile multiples). Every
gradient tensor is compared with ``atol = tol * max|g_ref|``.

Tolerances (measured over six seeds of the train-pass case). float32: the
same arithmetic with sums in another order and XLA's sine against torch's
(an ulp apart); through eight sine layers that moves the gradients by up to
1.4e-5 of their max, so 2e-4; the loss to 2e-6 relative (measured 2.7e-7),
the forward outputs to 1e-5 (measured 2.0e-6; 2e-5 on depth, which reaches
6). bfloat16: XLA evaluates the degree-11 sine with other roundings than
the port (which matches the CUDA kernel bit for bit): on CPU the two differ
in half of all inputs, by up to 3.7e-6. Each such difference can flip the
bf16 rounding of an activation, and w0 = 30 on the first layer amplifies a
flip of the rounded positions, so the forward outputs move by up to 4.1e-3
(tolerance 1e-2), the loss by 2.2e-4 relative (2e-3), the gradients by up
to 1.1e-2 of their max (0.1) and in relative Frobenius norm (0.05).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.siren import SirenModel as JaxSiren
from nerf_tpu.ops.pallas.fused_render_siren import make_fused_siren_render as jax_fused
from nerf_tpu.ops.pallas.fused_siren import pack_params as jax_pack_params

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_render_siren import (
    FusedSirenRender,
    fused_siren_render_bwd_plain,
    fused_siren_train_plain,
    grad_views,
    pack_params,
)

NEAR, FAR = 2.0, 6.0
GRAD_TOL = {"float32": (2e-4, None), "bfloat16": (0.1, 0.05)}
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LOSS_RTOL = {"float32": 2e-6, "bfloat16": 2e-3}


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(cdt, num_rays, num_samples, seed):
    jm = JaxSiren(compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = SirenModel(compute_dtype=cdt)
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
    """(name, array) of a SIREN pytree, by name."""
    out = [(f"base[{i}].{k}", lyr[k]) for i, lyr in enumerate(tree["base"])
           for k in ("w", "b")]
    return out + [(f"{n}.{k}", tree[n][k]) for n in ("sigma", "remap", "rgb0", "rgb1")
                  for k in ("w", "b")]


def _assert_grads(got_tree, ref_tree, cdt):
    tol, fro = GRAD_TOL[cdt]
    for (name, a), (_, b) in zip(_leaves(got_tree), _leaves(ref_tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max()) + 1e-30
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)
        if fro is not None:
            rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
            assert rel < fro, (name, rel)


def test_pack_layout_matches_fused_siren_pack_params():
    """The float32 packing holds fused_siren.py::pack_params's arrays (w1
    padded to 8 rows, wr0 split, wr0d padded to 32, wr1/br1 to 8)."""
    jm, params, tm, *_ = _case("float32", 2, 2, seed=0)
    ref = {k: np.asarray(v) for k, v in jax_pack_params(params, 32, 256).items()}
    with torch.no_grad():
        packed = pack_params(tm)
    got = {**packed.mats, **packed.vecs}
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy().reshape(v.shape), v, err_msg=k)
    assert set(got) == set(ref)


@pytest.mark.parametrize("cdt,num_rays,num_samples",
                         [("float32", 6, 24), ("bfloat16", 12, 13)])
def test_forward_matches_pallas_interpret(cdt, num_rays, num_samples):
    jm, params, tm, ro, rd, t, _ = _case(cdt, num_rays, num_samples, seed=1)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    ref = fr_j(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
               jnp.asarray(t))
    fr = FusedSirenRender(tm, NEAR, FAR)
    before = FusedSirenRender.launches
    with torch.no_grad():
        got = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
    assert FusedSirenRender.launches == before          # CPU: plain version
    for k in ("rgb", "acc", "depth", "weights"):
        scale = 2.0 if k == "depth" else 1.0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=FWD_TOL[cdt] * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("cdt,num_rays,num_samples",
                         [("float32", 10, 13), ("bfloat16", 8, 16)])
def test_train_pass_matches_pallas_interpret(cdt, num_rays, num_samples, white_bg):
    jm, params, tm, ro, rd, t, tgt = _case(cdt, num_rays, num_samples, seed=2)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)

    def loss_j(p):
        return fr_j.train(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
                          jnp.asarray(t), jnp.asarray(tgt), white_bg)

    (lj, aux_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    fr = FusedSirenRender(tm, NEAR, FAR)
    before = FusedSirenRender.train_launches
    loss, aux = fr.train(tm, _t(ro), _t(rd), _t(rd), _t(t), _t(tgt), white_bg)
    assert FusedSirenRender.train_launches == before
    assert not aux["weights"].requires_grad and loss.requires_grad
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=LOSS_RTOL[cdt])
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]),
                                   atol=FWD_TOL[cdt], err_msg=k)
    for p in tm.parameters():
        assert p.grad.dtype == torch.float32
    _assert_grads(export_jax_grads(tm), g_j, cdt)


@pytest.mark.parametrize("cdt,num_rays,num_samples",
                         [("float32", 9, 16), ("bfloat16", 7, 8)])
def test_render_backward_matches_pallas_interpret(cdt, num_rays, num_samples):
    """jax.grad through the forward render (custom VJP: the Pallas backward
    kernel) of a loss on rgb, acc and depth; the depth term exercises the
    g_depth * t path."""
    jm, params, tm, ro, rd, t, tgt = _case(cdt, num_rays, num_samples, seed=3)
    wa, wd = 0.3, 0.05
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)

    def loss_j(p):
        out = fr_j(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
                   jnp.asarray(t))
        return (jnp.sum((out["rgb"] - tgt) ** 2) + wa * jnp.sum(out["acc"] ** 2)
                + wd * jnp.sum(out["depth"]))

    g_j = jax.grad(loss_j)(params)
    fr = FusedSirenRender(tm, NEAR, FAR)
    before = FusedSirenRender.bwd_launches
    out = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
    assert not out["weights"].requires_grad
    loss = (torch.sum((out["rgb"] - _t(tgt)) ** 2) + wa * torch.sum(out["acc"] ** 2)
            + wd * torch.sum(out["depth"]))
    loss.backward()
    assert FusedSirenRender.bwd_launches == before
    _assert_grads(export_jax_grads(tm), g_j, cdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_two_backward_routes_agree(cdt):
    """The MSE gradient through the train pass equals the one through the
    forward render and its backward: the same plain arithmetic, so 1e-5 of
    the max in float32 and the bf16 bound above."""
    _, _, tm, ro, rd, t, tgt = _case(cdt, 11, 13, seed=4)
    fr = FusedSirenRender(tm, NEAR, FAR)
    loss, _ = fr.train(tm, _t(ro), _t(rd), _t(rd), _t(t), _t(tgt), True)
    loss.backward()
    g_train = export_jax_grads(tm)
    tm.zero_grad(set_to_none=True)
    out = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
    rgb = out["rgb"] + (1.0 - out["acc"][:, None])
    loss2 = torch.mean((rgb - _t(tgt)) ** 2)
    loss2.backward()
    torch.testing.assert_close(loss2, loss.detach(), rtol=1e-6, atol=0)
    tol = 1e-5 if cdt == "float32" else GRAD_TOL[cdt][0]
    for (name, a), (_, b) in zip(_leaves(export_jax_grads(tm)), _leaves(g_train)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(),
                                   err_msg=name)


def test_plain_versions_share_the_forward():
    """fused_siren_render_bwd_plain with the MSE head's cotangent gives
    fused_siren_train_plain's gradients exactly; the padding stays zero."""
    _, _, tm, ro, rd, t, tgt = _case("float32", 6, 8, seed=5)
    fr = FusedSirenRender(tm, NEAR, FAR)
    with torch.no_grad():
        packed = fr.pack(tm)
        o_aff, d_aff = fr.affine(_t(ro), _t(rd))
        loss, rgb, acc, _, (gw, gv) = fused_siren_train_plain(
            packed, o_aff, d_aff, _t(rd), _t(t), _t(tgt), False, fr.consts)
        scale = 1.0 / (3 * 6)
        g_ray = torch.zeros(6, 8)
        g_ray[:, :3] = 2 * scale * (rgb - _t(tgt))
        gw2, gv2 = fused_siren_render_bwd_plain(packed, o_aff, d_aff, _t(rd),
                                                _t(t), g_ray, fr.consts)
    torch.testing.assert_close(gw2, gw, rtol=0, atol=0)
    torch.testing.assert_close(gv2, gv, rtol=0, atol=0)
    views = grad_views(gw, gv, 256)
    assert views["wr1"][:, 3:].abs().max() == 0      # padded columns stay 0
    assert views["w1"][3:].abs().max() == 0          # padded rows stay 0
    assert views["wr0d"][27:].abs().max() == 0


def test_supported_shapes():
    """The kernels take hidden 256 to 1024 (siren_plan.py; the TPU kernels
    also take 1280, where the port raises on the card); the layout has 8
    sine layers, so another depth has no fused render at all."""
    near_far = (NEAR, FAR)
    assert FusedSirenRender(SirenModel(), *near_far).supported()
    assert FusedSirenRender(SirenModel(hidden_dim=512), *near_far).supported()
    assert not FusedSirenRender(SirenModel(hidden_dim=1280), *near_far).supported()
    msg = FusedSirenRender(SirenModel(hidden_dim=1280), *near_far)._unsupported()
    assert "hidden 1280" in msg and "ROADMAP" in msg
    with pytest.raises(NotImplementedError, match="8 sine layers"):
        FusedSirenRender(SirenModel(num_layers=6), *near_far)
