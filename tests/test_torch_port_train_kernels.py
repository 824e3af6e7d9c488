"""The port's train pass and render backward (CPU: their plain versions)
against the JAX package's Pallas kernels in interpret mode.

Inputs come from numpy seeds: camera-like rays from z = 4 toward the
origin, stratified t, random targets. Hidden 256 is the narrowest width the
TPU kernels take, so the ray and sample counts stay small (8-16 rays,
S in {8, 13, 24}: an odd S and ray counts that are not tile multiples).
Every gradient tensor is compared with ``atol = tol * max|g_ref|``.

Tolerances. float32: the same arithmetic with sums in another order; a
pre-activation within an ulp of zero can flip one ReLU mask between the
frameworks, which moves an early layer's gradient by up to 4.3e-4 of its
max (measured over 12 draws), so 2e-3. bfloat16: each dz is rounded to
bf16 before every product, so a last-bit difference in a float32 sum
flips roundings that the backward then carries through nine layers; a
1e-6 change of t alone moves the port's own bf16 gradients by up to 7% of
their max, and the two frameworks differ by up to 17% (measured), so 0.25
on the max and 0.05 on the relative Frobenius norm. Forward outputs:
1e-5 (f32) and 1e-4 (bf16), the bounds of test_torch_port_render.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.ops.pallas.fused_render import make_fused_nerf_render as jax_fused

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.fused_render import (
    FusedNerfRender,
    fused_render_bwd_plain,
    fused_train_plain,
    grad_views,
)

NEAR, FAR = 2.0, 6.0
GRAD_TOL = {"float32": (2e-3, None), "bfloat16": (0.25, 0.05)}
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(cdt, num_rays, num_samples, seed):
    jm = JaxNeRF(hidden_dim=256, compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = NeRFModel(hidden_dim=256, compute_dtype=cdt)
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


def _assert_grads(got_tree, ref_tree, cdt):
    tol, fro = GRAD_TOL[cdt]
    for blk in ("block1", "block2", "rgb"):
        for i, (g, r) in enumerate(zip(got_tree[blk], ref_tree[blk])):
            for k in ("w", "b"):
                a, b = np.asarray(g[k]), np.asarray(r[k])
                assert a.shape == b.shape
                scale = float(np.abs(b).max()) + 1e-30
                np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                           err_msg=f"{blk}[{i}].{k}")
                if fro is not None:
                    rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
                    assert rel < fro, (blk, i, k, rel)


@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("cdt,num_rays,num_samples",
                         [("float32", 10, 13), ("bfloat16", 12, 8)])
def test_train_pass_matches_pallas_interpret(cdt, num_rays, num_samples, white_bg):
    jm, params, tm, ro, rd, t, tgt = _case(cdt, num_rays, num_samples, seed=1)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)

    def loss_j(p):
        return fr_j.train(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
                          jnp.asarray(t), jnp.asarray(tgt), white_bg)

    (lj, aux_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    fr = FusedNerfRender(tm, NEAR, FAR)
    before = FusedNerfRender.train_launches
    loss, aux = fr.train(tm, _t(ro), _t(rd), _t(rd), _t(t), _t(tgt), white_bg)
    assert FusedNerfRender.train_launches == before     # CPU: plain version
    assert not aux["weights"].requires_grad and loss.requires_grad
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=FWD_TOL[cdt])
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]),
                                   atol=FWD_TOL[cdt], err_msg=k)
    for p in tm.parameters():
        assert p.grad.dtype == torch.float32
    _assert_grads(export_jax_grads(tm), g_j, cdt)


@pytest.mark.parametrize("cdt,num_rays,num_samples",
                         [("float32", 9, 24), ("bfloat16", 8, 13)])
def test_render_backward_matches_pallas_interpret(cdt, num_rays, num_samples):
    """jax.grad through the forward render (custom VJP: the Pallas backward
    kernel) of a loss on rgb, acc and depth; the depth term exercises the
    g_depth * t path."""
    jm, params, tm, ro, rd, t, tgt = _case(cdt, num_rays, num_samples, seed=2)
    wa, wd = 0.3, 0.05
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)

    def loss_j(p):
        out = fr_j(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
                   jnp.asarray(t))
        return (jnp.sum((out["rgb"] - tgt) ** 2) + wa * jnp.sum(out["acc"] ** 2)
                + wd * jnp.sum(out["depth"]))

    g_j = jax.grad(loss_j)(params)
    fr = FusedNerfRender(tm, NEAR, FAR)
    before = FusedNerfRender.bwd_launches
    out = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
    assert not out["weights"].requires_grad
    loss = (torch.sum((out["rgb"] - _t(tgt)) ** 2) + wa * torch.sum(out["acc"] ** 2)
            + wd * torch.sum(out["depth"]))
    loss.backward()
    assert FusedNerfRender.bwd_launches == before
    _assert_grads(export_jax_grads(tm), g_j, cdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_two_backward_routes_agree(cdt):
    """The MSE gradient through the train pass equals the one through the
    forward render and its backward (same plain arithmetic, so 1e-5 of the
    max in float32; bfloat16 as above)."""
    _, _, tm, ro, rd, t, tgt = _case(cdt, 11, 13, seed=3)
    fr = FusedNerfRender(tm, NEAR, FAR)
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
    for blk in ("block1", "block2", "rgb"):
        for a, b in zip(export_jax_grads(tm)[blk], g_train[blk]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k], b[k], rtol=0,
                                           atol=tol * np.abs(b[k]).max())


def test_plain_versions_share_the_forward():
    """fused_render_bwd_plain with the MSE head's cotangent gives
    fused_train_plain's gradients exactly."""
    _, _, tm, ro, rd, t, tgt = _case("float32", 6, 8, seed=4)
    fr = FusedNerfRender(tm, NEAR, FAR)
    with torch.no_grad():
        packed = fr.pack(tm)
        o_aff, d_aff = fr.affine(_t(ro), _t(rd))
        loss, rgb, acc, _, (gw, gv) = fused_train_plain(
            packed, o_aff, d_aff, _t(rd), _t(t), _t(tgt), False, 10, 4)
        scale = 1.0 / (3 * 6)
        g_ray = torch.zeros(6, 8)
        g_ray[:, :3] = 2 * scale * (rgb - _t(tgt))
        gw2, gv2 = fused_render_bwd_plain(packed, o_aff, d_aff, _t(rd), _t(t),
                                          g_ray, 10, 4)
    torch.testing.assert_close(gw2, gw, rtol=0, atol=0)
    torch.testing.assert_close(gv2, gv, rtol=0, atol=0)
    views = grad_views(gw, gv, 256)
    assert views["wr1"][:, 3:].abs().max() == 0      # padded columns stay 0
    assert views["w1"][63:].abs().max() == 0         # padded rows stay 0
