"""nerf_tpu_torch against nerf_tpu: sampling, compositing, the fused render
(the port's plain version against the Pallas kernel in interpret mode) and
the slice end to end through ``make_eval_render``. Inputs come from numpy
seeds; random draws are injected so that both packages see the same
numbers."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu.ops import volume as jvol
from nerf_tpu.ops.pallas.fused_render import make_fused_nerf_render as jax_fused
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.train.step import make_eval_render as jax_eval_render

from nerf_tpu_torch.models.convert import load_jax_params
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops import sampling as tsamp
from nerf_tpu_torch.ops import volume as tvol
from nerf_tpu_torch.ops.cuda.fused_render import (
    FusedNerfRender,
    fast_sin,
)
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.step import make_eval_render

NEAR, FAR = 2.0, 6.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _sorted_t(rng, num_rays, num_samples):
    edges = np.linspace(NEAR, FAR, num_samples + 1)
    t = edges[:-1] + rng.uniform(0, 1, (num_rays, num_samples)) * (
        edges[1:] - edges[:-1])
    return t.astype(np.float32)


def _rays(rng, num_rays):
    ro = rng.uniform(2.5, 3.5, (num_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("num_samples", [8, 64, 192])
@pytest.mark.parametrize("jitter_mode", ["per_ray", "shared"])
def test_stratified_sample_midpoints_match(num_samples, jitter_mode):
    ref = jsamp.stratified_sample(jax.random.key(0), NEAR, FAR, num_samples, 5,
                                  jitter_mode=jitter_mode, perturb=False)
    got = tsamp.stratified_sample(NEAR, FAR, num_samples, 5,
                                  jitter_mode=jitter_mode, perturb=False)
    # jnp.linspace and torch.linspace round some float32 grid points
    # differently in the last bit (1 ulp at t=6 is 4.8e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_stratified_sample_jitter_stays_in_bins():
    g = torch.Generator().manual_seed(0)
    t = tsamp.stratified_sample(NEAR, FAR, 16, 32, generator=g)
    edges = np.linspace(NEAR, FAR, 17)
    assert t.shape == (32, 16)
    assert np.all(t.numpy() >= edges[:-1] - 1e-6)
    assert np.all(t.numpy() <= edges[1:] + 1e-6)
    shared = tsamp.stratified_sample(NEAR, FAR, 16, 4, jitter_mode="shared",
                                     generator=g)
    assert torch.equal(shared[0], shared[3])


def test_deltas_positions_normalize_match():
    rng = np.random.default_rng(0)
    t = _sorted_t(rng, 4, 10)
    ro, rd = _rays(rng, 4)
    np.testing.assert_array_equal(tsamp.deltas_from_t(_t(t)).numpy(),
                                  np.asarray(jsamp.deltas_from_t(jnp.asarray(t))))
    p_ref = jsamp.sample_positions(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t))
    p = tsamp.sample_positions(_t(ro), _t(rd), _t(t))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-6)
    np.testing.assert_allclose(
        tsamp.normalize_positions(p, NEAR, FAR).numpy(),
        np.asarray(jsamp.normalize_positions(p_ref, NEAR, FAR)), atol=1e-6)


@pytest.mark.parametrize("mode", ["injected_u", "deterministic"])
def test_sample_pdf_matches(mode):
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(NEAR, FAR, (6, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (6, 16)).astype(np.float32)
    w[0] = 0.0                                   # an empty ray
    w[1, :8] = 0.0                               # half-empty
    kw = {}
    if mode == "injected_u":
        u = rng.uniform(0, 1 - 1e-5, (6, 24)).astype(np.float32)
        kw_j, kw["u"] = {"u": jnp.asarray(u)}, _t(u)
    else:
        kw_j, kw["deterministic"] = {"deterministic": True}, True
    ref = jsamp.sample_pdf(jax.random.key(0), jnp.asarray(bins), jnp.asarray(w),
                           24, **kw_j)
    got = tsamp.sample_pdf(_t(bins), _t(w), 24, **kw)
    # same searchsorted bins; cumsum order may differ in the last ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_merge_samples_matches():
    rng = np.random.default_rng(3)
    tc = _sorted_t(rng, 5, 8)
    tf = rng.uniform(NEAR, FAR, (5, 16)).astype(np.float32)
    tf[0, :3] = tc[0, 2]                         # ties keep a stable order
    ref = jsamp.merge_samples(jnp.asarray(tc), jnp.asarray(tf))
    got = tsamp.merge_samples(_t(tc), _t(tf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- volume


def test_exclusive_cumprod_matches():
    x = np.random.default_rng(4).uniform(0, 1, (3, 5, 7)).astype(np.float32)
    for dim in (-1, 1):
        np.testing.assert_allclose(
            tvol.exclusive_cumprod(_t(x), dim=dim).numpy(),
            np.asarray(jvol.exclusive_cumprod(jnp.asarray(x), axis=dim)),
            rtol=1e-6)


@pytest.mark.parametrize("white", [True, False])
def test_composite_matches(white):
    rng = np.random.default_rng(5)
    t = _sorted_t(rng, 6, 12)
    rgb = rng.uniform(0, 1, (6, 12, 3)).astype(np.float32)
    sigma = rng.uniform(0, 5, (6, 12)).astype(np.float32)
    sigma[0] = 0.0                               # empty ray: acc 0, tail exact
    deltas = np.asarray(jsamp.deltas_from_t(jnp.asarray(t)))
    ref = jvol.composite(jnp.asarray(rgb), jnp.asarray(sigma),
                         jnp.asarray(deltas), t=jnp.asarray(t),
                         white_background=white)
    got = tvol.composite(_t(rgb), _t(sigma), _t(deltas), t=_t(t),
                         white_background=white)
    for name in ("rgb", "weights", "depth", "acc", "disparity"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(got.acc[0]) == 0.0


# ---------------------------------------------------------------- fused render


def _fused_pair(cdt, hidden=256, num_rays=6, num_samples=32, seed=0):
    jm = JaxNeRF(hidden_dim=hidden, compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = NeRFModel(hidden_dim=hidden, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    ro, rd = _rays(rng, num_rays)
    t = _sorted_t(rng, num_rays, num_samples)
    return jm, params, tm, ro, rd, t


# float32 (the bounds of tests/test_fused_render.py): the port runs the same
# float32 arithmetic with sums in another order. bfloat16: the same bf16
# rounding points and fast sine on both sides; a last-ulp difference in a
# float32 sum can still flip one bf16 rounding, so 1e-4 / 1e-3 on depth.
_FUSED_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 1e-3)}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_fused_render_plain_matches_pallas_interpret(cdt):
    jm, params, tm, ro, rd, t = _fused_pair(cdt)
    fr_j = jax_fused(jm, NEAR, FAR, normalize=True, interpret=True)
    ref = fr_j(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rd),
               jnp.asarray(t))
    fr = FusedNerfRender(tm, NEAR, FAR, normalize=True)
    assert fr.supported()
    before = FusedNerfRender.launches
    with torch.no_grad():
        got = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
    assert FusedNerfRender.launches == before   # CPU: plain version, no launch
    tol, tol_depth = _FUSED_TOL[cdt]
    for k in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                               atol=tol_depth)


def test_fused_render_plain_matches_unfused_path():
    """The fused plain version against the port's own module path + composite
    (float32: the cos columns as sin(x + pi/2) differ by ~1 ulp of the
    argument, within the same bounds as the Pallas test)."""
    _, _, tm, ro, rd, t = _fused_pair("float32", hidden=32, num_samples=16)
    fr = FusedNerfRender(tm, NEAR, FAR)
    with torch.no_grad():
        got = fr(tm, _t(ro), _t(rd), _t(rd), _t(t))
        pts = tsamp.normalize_positions(
            tsamp.sample_positions(_t(ro), _t(rd), _t(t)), NEAR, FAR)
        rgb, sigma = tm(pts, _t(rd)[:, None, :].expand(pts.shape))
        ref = tvol.composite(rgb, sigma, tsamp.deltas_from_t(_t(t)), t=_t(t),
                             white_background=False)
    torch.testing.assert_close(got["rgb"], ref.rgb, atol=1e-5, rtol=0)
    torch.testing.assert_close(got["acc"], ref.acc, atol=1e-5, rtol=0)
    torch.testing.assert_close(got["weights"], ref.weights, atol=1e-5, rtol=0)
    torch.testing.assert_close(got["depth"], ref.depth, atol=1e-4, rtol=0)


def test_fast_sin_matches_reference_and_sin():
    from nerf_tpu.ops.pallas.fused_nerf import _fast_sin

    x = np.linspace(-600, 600, 20001, dtype=np.float32)
    got = fast_sin(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_fast_sin(jnp.asarray(x))))
    np.testing.assert_allclose(got, np.sin(x.astype(np.float64)), atol=1e-4)


def test_kernel_shape_guard():
    fr = FusedNerfRender(NeRFModel(hidden_dim=32), NEAR, FAR)
    assert not fr.supported()
    assert FusedNerfRender(NeRFModel(hidden_dim=256), NEAR, FAR).supported()


def test_wrapper_rejects_other_devices():
    tm = NeRFModel(hidden_dim=32)
    fr = FusedNerfRender(tm, NEAR, FAR)
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fr(fr.pack(tm), x, x, x, torch.zeros(2, 4, device="meta"))


# ---------------------------------------------------------------- slice


@pytest.mark.parametrize("fine_sampling", ["merge", "resample"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_make_eval_render_matches_jax(fine_sampling, cdt):
    """The whole slice: hierarchical 8+16, 120 rays in tiles of 64 (the last
    one ragged), perturb off, converted params; the JAX side on the CPU
    (pure-JAX path), the port through its fused render's plain version."""
    rng = np.random.default_rng(7)
    jm = JaxNeRF(hidden_dim=256, compute_dtype=cdt)
    params = jm.init(jax.random.key(1))
    fine = jm.init(jax.random.key(2))
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=16,
              perturb=False, chunk_size=64, fine_sampling=fine_sampling)
    ro, rd = _rays(rng, 120)
    ref = jax_eval_render(jm, JaxSettings(**kw))(
        params, fine, jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0))

    tm = NeRFModel(hidden_dim=256, compute_dtype=cdt)
    tf = NeRFModel(hidden_dim=256, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    load_jax_params(tf, jax.tree.map(np.asarray, fine))
    got = make_eval_render(tm, RenderSettings(**kw))(tm, tf, _t(ro), _t(rd))
    # fused plain vs pure JAX: float32 to 1e-5 (the fused cos columns and
    # positions round differently from the unfused ones by ~1 ulp, which the
    # fine resample then moves slightly; measured 3e-7); bfloat16 also
    # differs in where h9 is rounded for the density and in the fast sine,
    # so 5e-4 (measured 2e-5). Depth and disparity scale with t (up to 6).
    tol = 1e-5 if cdt == "float32" else 5e-4
    for name in ("rgb", "depth", "acc", "rgb_coarse", "disparity"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = 10.0 if name in ("depth", "disparity") else 1.0
        np.testing.assert_allclose(a, b, atol=tol * scale, err_msg=name)


def test_unfused_eval_render_matches_jax():
    rng = np.random.default_rng(8)
    jm = JaxNeRF(hidden_dim=32)
    params = jm.init(jax.random.key(3))
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=16,
              perturb=False, chunk_size=50)
    ro, rd = _rays(rng, 120)
    ref = jax_eval_render(jm, JaxSettings(**kw), use_pallas=False)(
        params, {}, jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0))
    tm = NeRFModel(hidden_dim=32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    got = make_eval_render(tm, RenderSettings(**kw), fused=False)(
        tm, None, _t(ro), _t(rd))
    for name in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=2e-5,
                                   err_msg=name)
