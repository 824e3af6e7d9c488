"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX's CPU mesh.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import RayBatch
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.fused_render import (
    FusedNerfRender,
    fused_render_bwd_plain,
    fused_render_plain,
    fused_train_plain,
    grad_views,
)
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.train.step import _make_step_body, make_eval_render

pytestmark = pytest.mark.cuda

NEAR, FAR = 2.0, 6.0
# kernel vs plain on the same card (see chip_smoke.py for the reasoning):
# float32 sums in another order; bfloat16 rounding flips after such sums
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# gradients, atol = tol * max|g|: float32 sums over thousands of points in
# another order (the b10s/w10s sums cancel), bfloat16 as chip_smoke.py says
GRAD_TOL = {"float32": 5e-3, "bfloat16": 5e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(num_rays, num_samples, dev, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(2.5, 3.5, (num_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(num_rays, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    t = np.sort(rng.uniform(NEAR, FAR, (num_rays, num_samples)), axis=-1)
    return tuple(torch.from_numpy(np.array(x, np.float32)).to(dev)
                 for x in (ro, rd, t))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 37), (5, 8), (1000, 64), (200, 192)])
def test_kernel_matches_plain(dev, cdt, shape):
    """Odd sample counts make chunks span rays; few rays leave CTAs idle."""
    model = NeRFModel(compute_dtype=cdt,
                      generator=torch.Generator().manual_seed(1)).to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    ro, rd, t = _inputs(*shape, dev)
    with torch.no_grad():
        packed = fr.pack(model)
        before = FusedNerfRender.launches
        got = fr(packed, ro, rd, rd, t)
        torch.cuda.synchronize()
        assert FusedNerfRender.launches == before + 1
        o_aff, d_aff = fr.affine(ro, rd)
        ref = fused_render_plain(packed, o_aff, d_aff, rd, t, 10, 4)
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert got[k].shape == ref[i].shape
        assert torch.isfinite(got[k]).all()
        scale = 10.0 if k == "depth" else 1.0
        torch.testing.assert_close(got[k], ref[i], atol=TOL[cdt] * scale,
                                   rtol=0, msg=k)


def test_kernel_refuses_unsupported_width(dev):
    small = NeRFModel(hidden_dim=32).to(dev)
    fr = FusedNerfRender(small, NEAR, FAR)
    ro, rd, t = _inputs(4, 8, dev)
    before = FusedNerfRender.launches
    with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden"):
        fr(small, ro, rd, rd, t)
    assert FusedNerfRender.launches == before


def _assert_grads(got, ref, cdt):
    """Each gradient tensor within tol of its max |g|, the max floored at
    1e-2 of the largest gradient element of the model: b10s is one sum of
    terms of both signs, whose residue alone is no scale."""
    g, r = grad_views(*got, 256), grad_views(*ref, 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert torch.isfinite(g[k]).all(), k
        scale = max(float(r[k].abs().max()), floor)
        err = float((g[k] - r[k]).abs().max())
        assert err <= GRAD_TOL[cdt] * scale, (k, err, scale)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 37), (5, 8), (133, 64)])
@pytest.mark.parametrize("white_bg", [True, False])
def test_train_kernel_matches_plain(dev, cdt, shape, white_bg):
    """Odd S (chunks span rays), a ray count that leaves CTAs idle, and 133
    rays (one more than the SMs: two rays on some CTAs)."""
    model = NeRFModel(compute_dtype=cdt,
                      generator=torch.Generator().manual_seed(4)).to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    ro, rd, t = _inputs(*shape, dev, seed=1)
    tgt = torch.rand(shape[0], 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        before = FusedNerfRender.train_launches
        got = fr._train(packed, o_aff, d_aff, rd, t, tgt, white_bg)
        torch.cuda.synchronize()
        assert FusedNerfRender.train_launches == before + 1
        ref = fused_train_plain(packed, o_aff, d_aff, rd, t, tgt, white_bg, 10, 4)
    torch.testing.assert_close(got[0], ref[0], rtol=TOL[cdt], atol=0)
    for i in (1, 2, 3):
        torch.testing.assert_close(got[i], ref[i], atol=TOL[cdt], rtol=0)
    _assert_grads(got[4], ref[4], cdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 37), (7, 13)])
def test_backward_kernel_matches_plain_and_autograd(dev, cdt, shape):
    """The backward kernel against its plain version, and through autograd
    (the forward kernel, then the backward kernel) from a loss on rgb, acc
    and depth."""
    model = NeRFModel(compute_dtype=cdt,
                      generator=torch.Generator().manual_seed(5)).to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    ro, rd, t = _inputs(*shape, dev, seed=3)
    g_ray = torch.randn(shape[0], 8, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
    g_ray[:, 5:] = 0
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        got = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
        ref = fused_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, 10, 4)
    _assert_grads(got, ref, cdt)
    before = (FusedNerfRender.launches, FusedNerfRender.bwd_launches)
    out = fr(model, ro, rd, rd, t)
    loss = (torch.sum(out["rgb"] * g_ray[:, :3]) + torch.sum(out["acc"] * g_ray[:, 3])
            + torch.sum(out["depth"] * g_ray[:, 4]))
    loss.backward()
    assert (FusedNerfRender.launches, FusedNerfRender.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    b1 = model.linears(model.block1)[0]
    assert b1.weight.grad.dtype == torch.float32
    torch.testing.assert_close(b1.weight.grad.T[:63],
                               grad_views(*got, 256)["w1"][:63])


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_train_step_on_card_matches_cpu(dev, cdt):
    """Two hierarchical 8+16 steps of the same state on one batch (perturb
    off), on the card through the kernels and on the CPU through the plain
    versions: loss and mse within the kernel tolerance; parameters within
    the Adam sign noise of tests/test_torch_port_train.py (2 lr per step)."""
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=16,
              perturb=False, white_background=True)
    cfg = Config(hidden_dim=256, compute_dtype=cdt, **kw)
    states = [create_train_state(cfg, device=d) for d in ("cpu", dev)]
    ro, rd, _ = _inputs(64, 1, "cpu", seed=7)
    tgt = torch.rand(64, 3, generator=torch.Generator().manual_seed(8))
    metrics = []
    for st in states:
        _, train_on_batch = _make_step_body(st.params, RenderSettings(**kw), 64, 0)
        d = st.params.block1[0].weight.device
        batch = RayBatch(*(x.to(d) for x in (ro, rd, tgt, rd)))
        before = FusedNerfRender.train_launches
        metrics.append([train_on_batch(st, batch) for _ in range(2)])
        assert FusedNerfRender.train_launches - before == (4 if d.type == "cuda" else 0)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "mse"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k],
                                       rtol=10 * TOL[cdt], atol=0)
    for a, b in zip(states[0].params.parameters(), states[1].params.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=4 * 5e-4, rtol=0)


@pytest.mark.parametrize("fine_sampling", ["merge", "resample"])
def test_eval_render_on_card_matches_cpu(dev, fine_sampling):
    """make_eval_render through the kernel against the same render on the
    CPU through the plain version (perturb off, ragged last tile)."""
    model = NeRFModel(generator=torch.Generator().manual_seed(2))
    fine = NeRFModel(generator=torch.Generator().manual_seed(3))
    settings = RenderSettings(near=NEAR, far=FAR, num_samples=16,
                              num_fine_samples=32, perturb=False,
                              chunk_size=96, fine_sampling=fine_sampling)
    ro, rd, _ = _inputs(250, 1, "cpu")
    ref = make_eval_render(model, settings)(model, fine, ro, rd)
    model, fine = model.to(dev), fine.to(dev)
    before = FusedNerfRender.launches
    got = make_eval_render(model, settings)(model, fine, ro.to(dev), rd.to(dev))
    assert FusedNerfRender.launches == before + 2 * 3
    for name in ("rgb", "depth", "acc", "rgb_coarse"):
        scale = 10.0 if name == "depth" else 1.0
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(ref, name),
                                   atol=1e-4 * scale, rtol=0, msg=name)


# ---------------------------------------------------------------- SIREN

# SIREN kernel vs plain. float32 as for the NeRF kernels. bfloat16: a sum
# that lands on the other side of a bf16 rounding boundary moves one
# activation by 2^-8 relative, and SIREN multiplies the density by
# sigma_mul = 10 (and its first layer by w0 = 30), so a flip moves a
# compositing weight about ten times as far as in the NeRF: 5e-3 on the
# forward outputs (5e-2 on depth). Gradients: with a few dozen points a
# flip is a sizable share of a cancelling sum such as bs (one sum of
# dsig): 0.1 of the max (measured 6.9e-2 for bs at 7 rays x 13; at 1024 x
# 256 every gradient is within 5.3e-4, chip_smoke.py).
SIREN_TOL = {"float32": TOL["float32"], "bfloat16": 5e-3}
SIREN_GRAD_TOL = {"float32": GRAD_TOL["float32"], "bfloat16": 0.1}


def _siren_grads_close(got, ref, cdt):
    """As _assert_grads, over the SIREN layout's 25 gradient tensors."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import grad_views as siren_views

    g, r = siren_views(*got, 256), siren_views(*ref, 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert torch.isfinite(g[k]).all(), k
        scale = max(float(r[k].abs().max()), floor)
        err = float((g[k] - r[k]).abs().max())
        assert err <= SIREN_GRAD_TOL[cdt] * scale, (k, err, scale)


def _siren(cdt, seed, dev, **kw):
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender

    model = SirenModel(compute_dtype=cdt, generator=torch.Generator().manual_seed(seed),
                       **kw).to(dev)
    return model, FusedSirenRender(model, NEAR, FAR)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 37), (5, 8), (1000, 64), (133, 256)])
def test_siren_kernel_matches_plain(dev, cdt, shape):
    """Odd S (chunks span rays), few rays (idle CTAs), 133 rays (one more
    than the SMs) at lego_siren.txt's 256 samples."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_render_plain)

    model, fr = _siren(cdt, 1, dev)
    ro, rd, t = _inputs(*shape, dev)
    with torch.no_grad():
        packed = fr.pack(model)
        before = FusedSirenRender.launches
        got = fr(packed, ro, rd, rd, t)
        torch.cuda.synchronize()
        assert FusedSirenRender.launches == before + 1
        o_aff, d_aff = fr.affine(ro, rd)
        ref = fused_siren_render_plain(packed, o_aff, d_aff, rd, t, fr.consts)
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert got[k].shape == ref[i].shape
        assert torch.isfinite(got[k]).all()
        scale = 10.0 if k == "depth" else 1.0
        err = float((got[k] - ref[i]).abs().max())
        assert err <= SIREN_TOL[cdt] * scale, (k, err)


def test_siren_kernel_refuses_unsupported_shapes(dev):
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender

    ro, rd, t = _inputs(4, 8, dev)
    model, fr = _siren("float32", 0, dev, hidden_dim=512)
    before = FusedSirenRender.launches
    with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden 256"):
        fr(model, ro, rd, rd, t)
    assert FusedSirenRender.launches == before
    with pytest.raises(NotImplementedError, match="8 sine layers"):
        _siren("float32", 0, dev, num_layers=6)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 37), (5, 8), (133, 64)])
@pytest.mark.parametrize("white_bg", [True, False])
def test_siren_train_kernel_matches_plain(dev, cdt, shape, white_bg):
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_train_plain)

    model, fr = _siren(cdt, 4, dev)
    ro, rd, t = _inputs(*shape, dev, seed=1)
    tgt = torch.rand(shape[0], 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        before = FusedSirenRender.train_launches
        got = fr._train(packed, o_aff, d_aff, rd, t, tgt, white_bg)
        torch.cuda.synchronize()
        assert FusedSirenRender.train_launches == before + 1
        ref = fused_siren_train_plain(packed, o_aff, d_aff, rd, t, tgt, white_bg,
                                      fr.consts)
    torch.testing.assert_close(got[0], ref[0], rtol=SIREN_TOL[cdt], atol=0)
    for i in (1, 2, 3):
        torch.testing.assert_close(got[i], ref[i], atol=SIREN_TOL[cdt], rtol=0)
    _siren_grads_close(got[4], ref[4], cdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 37), (7, 13)])
def test_siren_backward_kernel_matches_plain_and_autograd(dev, cdt, shape):
    """The backward kernel against its plain version, and through autograd
    (the forward kernel, then the backward kernel) from a loss on rgb, acc
    and depth."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_render_bwd_plain, grad_views)

    model, fr = _siren(cdt, 5, dev)
    ro, rd, t = _inputs(*shape, dev, seed=3)
    g_ray = torch.randn(shape[0], 8, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
    g_ray[:, 5:] = 0
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        got = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
        ref = fused_siren_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray,
                                           fr.consts)
    _siren_grads_close(got, ref, cdt)
    before = (FusedSirenRender.launches, FusedSirenRender.bwd_launches)
    out = fr(model, ro, rd, rd, t)
    loss = (torch.sum(out["rgb"] * g_ray[:, :3]) + torch.sum(out["acc"] * g_ray[:, 3])
            + torch.sum(out["depth"] * g_ray[:, 4]))
    loss.backward()
    assert (FusedSirenRender.launches, FusedSirenRender.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert model.base[0].weight.grad.dtype == torch.float32
    torch.testing.assert_close(model.base[0].weight.grad.T,
                               grad_views(*got, 256)["w1"][:3])
    torch.testing.assert_close(model.sigma.weight.grad[0], grad_views(*got, 256)["ws"])


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_siren_train_step_on_card_matches_cpu(dev, cdt):
    """Two coarse-only 32-sample steps of the same SIREN state on one batch
    (perturb off), on the card through the train kernel and on the CPU
    through its plain version: loss and mse within the kernel tolerance;
    parameters within the Adam sign noise (2 lr per step)."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender

    kw = dict(near=NEAR, far=FAR, num_samples=32, perturb=False,
              white_background=True)
    cfg = Config(model_type="siren", hidden_dim=256, compute_dtype=cdt, **kw)
    states = [create_train_state(cfg, device=d) for d in ("cpu", dev)]
    ro, rd, _ = _inputs(64, 1, "cpu", seed=7)
    tgt = torch.rand(64, 3, generator=torch.Generator().manual_seed(8))
    metrics = []
    for st in states:
        _, train_on_batch = _make_step_body(st.params, RenderSettings(**kw), 64, 0)
        d = st.params.base[0].weight.device
        batch = RayBatch(*(x.to(d) for x in (ro, rd, tgt, rd)))
        before = FusedSirenRender.train_launches
        metrics.append([train_on_batch(st, batch) for _ in range(2)])
        assert FusedSirenRender.train_launches - before == (2 if d.type == "cuda" else 0)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "mse"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k],
                                       rtol=10 * TOL[cdt], atol=0)
    for a, b in zip(states[0].params.parameters(), states[1].params.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=4 * 5e-4, rtol=0)


# ---------------------------------------------------------------- GaborNet

# The GaborNet kernels against their plain versions: the tolerances of the
# SIREN kernels (sigma_mul = 10 here too). The coefficient cotangents dA..dR
# are compared per coefficient with atol = tol * max|d| (float32 sums of a
# ray's samples in another order; measured 3.9e-4 of the max in bf16 at
# 1024 x 256, chip_smoke.py).
GABOR_TOL = SIREN_TOL
GABOR_GRAD_TOL = SIREN_GRAD_TOL


def _gabor(cdt, seed, dev, **kw):
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender

    model = GaborModel(compute_dtype=cdt, generator=torch.Generator().manual_seed(seed),
                       **kw).to(dev)
    return model, FusedGaborRender(model, NEAR, FAR)


def _gabor_coeffs(fr, model, ro, rd):
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import gabor_coeffs, stack_filters

    with torch.no_grad():
        return gabor_coeffs(*stack_filters(model), *fr.affine(ro, rd))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 13), (7, 37), (300, 37), (133, 256)])
def test_gabor_kernel_matches_plain(dev, cdt, shape):
    """Few rays (idle CTAs) with odd S (chunks span rays), 300 x 37 and 133
    rays (one more than the SMs) at lego_siren.txt's 256 samples."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_render_plain)

    model, fr = _gabor(cdt, 1, dev)
    ro, rd, t = _inputs(*shape, dev)
    with torch.no_grad():
        before = FusedGaborRender.launches
        got = fr(model, ro, rd, rd, t)
        torch.cuda.synchronize()
        assert FusedGaborRender.launches == before + 1
        ref = fused_gabor_render_plain(fr.pack(model).packed,
                                       _gabor_coeffs(fr, model, ro, rd), rd, t, fr.consts)
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert got[k].shape == ref[i].shape
        assert torch.isfinite(got[k]).all()
        scale = 10.0 if k == "depth" else 1.0
        err = float((got[k] - ref[i]).abs().max())
        assert err <= GABOR_TOL[cdt] * scale, (k, err)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 13), (7, 37), (300, 37)])
@pytest.mark.parametrize("white_bg", [True, False])
def test_gabor_train_kernel_matches_plain(dev, cdt, shape, white_bg):
    """Loss, rgb, acc, weights, the 23 weight gradients and dA..dR."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_train_plain, grad_views)

    model, fr = _gabor(cdt, 4, dev)
    ro, rd, t = _inputs(*shape, dev, seed=1)
    tgt = torch.rand(shape[0], 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    coeffs = _gabor_coeffs(fr, model, ro, rd)
    with torch.no_grad():
        packed = fr.pack(model).packed
        before = FusedGaborRender.train_launches
        got = fr._train(packed, coeffs, rd, t, tgt, white_bg)
        torch.cuda.synchronize()
        assert FusedGaborRender.train_launches == before + 1
        ref = fused_gabor_train_plain(packed, coeffs, rd, t, tgt, white_bg, fr.consts)
    torch.testing.assert_close(got[0], ref[0], rtol=GABOR_TOL[cdt], atol=0)
    for i in (1, 2, 3):
        torch.testing.assert_close(got[i], ref[i], atol=GABOR_TOL[cdt], rtol=0)
    g, r = grad_views(*got[4], 256), grad_views(*ref[4], 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert torch.isfinite(g[k]).all(), k
        scale = max(float(r[k].abs().max()), floor)
        err = float((g[k] - r[k]).abs().max())
        assert err <= GABOR_GRAD_TOL[cdt] * scale, (k, err, scale)
    assert got[5].shape == coeffs.shape and torch.isfinite(got[5]).all()
    for j in range(5):
        err = float((got[5][j] - ref[5][j]).abs().max())
        assert err <= GABOR_GRAD_TOL[cdt] * float(ref[5][j].abs().max()), (j, err)


def test_gabor_kernels_refuse_unsupported_shapes_and_the_render_vjp(dev):
    """Hidden 256 with 8 stages only (the plain versions take any shape on
    the CPU); the forward render under autograd raises before launching."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender

    ro, rd, t = _inputs(4, 8, dev)
    tgt = torch.rand(4, 3, device=dev)
    for kw in ({"hidden_dim": 128}, {"num_layers": 4}):
        model, fr = _gabor("float32", 0, dev, **kw)
        before = (FusedGaborRender.launches, FusedGaborRender.train_launches)
        with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden 256"):
            fr(model, ro, rd, rd, t)
        with pytest.raises(NotImplementedError, match="8 stages"):
            fr.train(model, ro, rd, rd, t, tgt, True)
        assert (FusedGaborRender.launches, FusedGaborRender.train_launches) == before
    model, fr = _gabor("float32", 0, dev)
    before = FusedGaborRender.launches
    with pytest.raises(NotImplementedError, match="forward-only"):
        fr(model, ro, rd, rd, t)
    assert FusedGaborRender.launches == before


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_gabor_train_step_on_card_matches_cpu(dev, cdt):
    """Two coarse-only 32-sample steps of the same GaborNet state on one
    batch (perturb off), on the card through the train kernel and on the
    CPU through its plain version (the filters through the prep on both):
    loss and mse within the kernel tolerance; parameters within the Adam
    sign noise (2 lr per step)."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender

    kw = dict(near=NEAR, far=FAR, num_samples=32, perturb=False,
              white_background=True)
    cfg = Config(model_type="gabor", hidden_dim=256, compute_dtype=cdt, **kw)
    states = [create_train_state(cfg, device=d) for d in ("cpu", dev)]
    ro, rd, _ = _inputs(64, 1, "cpu", seed=7)
    tgt = torch.rand(64, 3, generator=torch.Generator().manual_seed(8))
    metrics = []
    for st in states:
        _, train_on_batch = _make_step_body(st.params, RenderSettings(**kw), 64, 0)
        d = st.params.remap.weight.device
        batch = RayBatch(*(x.to(d) for x in (ro, rd, tgt, rd)))
        before = FusedGaborRender.train_launches
        metrics.append([train_on_batch(st, batch) for _ in range(2)])
        assert FusedGaborRender.train_launches - before == (2 if d.type == "cuda" else 0)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "mse"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k],
                                       rtol=10 * TOL[cdt], atol=0)
    for a, b in zip(states[0].params.parameters(), states[1].params.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=4 * 5e-4, rtol=0)


# ---------------------------------------------------------------- KiloNeRF

# kernel vs plain (chip_smoke.py states the same): float32 sums over 32-63
# terms in another order; bfloat16 roundings flip after such sums and move
# one activation by 2^-8 relative. Gradients: atol = tol * max|g| per
# tensor, the max floored at 1e-2 of the model's largest gradient.
KILO_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
KILO_GRAD_TOL = {"float32": 5e-4, "bfloat16": 5e-3}
KILO_DOMAIN = (-2.75, -1.25)


def _kilo(cdt, seed, dev, grid=8, **kw):
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel

    return KiloNeRFModel(grid_res=grid, hidden_dim=32, compute_dtype=cdt, domain=KILO_DOMAIN,
                         generator=torch.Generator().manual_seed(seed), **kw).to(dev)


def _kilo_points(kind, n, dev, seed=0):
    """(points, dirs): ``uniform`` over the domain, ``camera`` samples of
    rays from a radius-4 sphere normalised like the renderer's (many in the
    border voxels, most networks empty at small n), ``voxel`` all in one
    voxel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g, device=dev), dim=-1)
    lo, hi = KILO_DOMAIN
    if kind == "uniform":
        pts = torch.rand(n, 3, generator=g, device=dev) * (hi - lo) + lo
    elif kind == "voxel":
        pts = lo + (hi - lo) * (0.3 + 0.1 * torch.rand(n, 3, generator=g, device=dev) / 8)
    else:
        cam = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=g, device=dev), dim=-1) * 4.0
        t = 2.0 + 4.0 * torch.rand(n, 1, generator=g, device=dev)
        pts = 2.0 * (cam + t * (-cam / 4.0 + 0.1 * dirs) - NEAR) / (FAR - NEAR) - 1.0
    return pts, dirs


def _kilo_grad_errors(got, ref):
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import unpack

    g, r = unpack(got, 32, 63, 27), unpack(ref, 32, 63, 27)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    return {k: float((g[k] - r[k]).abs().max()) / max(float(r[k].abs().max()), floor)
            for k in r}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n", [("uniform", 1000), ("uniform", 37), ("voxel", 700),
                                    ("camera", 5003), ("camera", 262144)])
def test_kilonerf_kernels_match_plain(dev, cdt, kind, n):
    """Both kernels against their plain versions at ragged counts, 37
    points (most of the 512 networks empty: their gradients exactly 0),
    every point in one voxel (one network's runs and pieces) and the
    1024 x 256 serving/training count; one launch each."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        KiloNeRFField, cast_packed, dispatch, kilonerf_bwd_plain, kilonerf_fwd_plain,
        pack_f32)

    model = _kilo(cdt, 3, dev)
    field = KiloNeRFField(model)
    pts, dirs = _kilo_points(kind, n, dev, seed=n)
    disp = dispatch(model, pts, dirs)
    if kind == "voxel":
        assert int((disp.counts > 0).sum()) == 1
    wc = cast_packed(pack_f32(model), model.cdt)
    cot = torch.randn(n, 4, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    before = (KiloNeRFField.launches, KiloNeRFField.bwd_launches)
    with torch.no_grad():
        out = field._forward(wc, disp)
        grad = field._backward(wc, disp, cot)
        torch.cuda.synchronize()
        ref = kilonerf_fwd_plain(wc, disp, 32, 10, 4)
        ref_g = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4)
    assert (KiloNeRFField.launches, KiloNeRFField.bwd_launches) == (before[0] + 1,
                                                                    before[1] + 1)
    assert out.shape == (n, 4) and torch.isfinite(out).all() and torch.isfinite(grad).all()
    assert float((out - ref).abs().max()) <= KILO_TOL[cdt] * max(1.0, float(ref.abs().max()))
    errs = _kilo_grad_errors(grad, ref_g)
    assert max(errs.values()) <= KILO_GRAD_TOL[cdt], errs
    empty = disp.counts == 0
    assert bool((grad[empty] == 0).all())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_kilonerf_field_autograd_on_card_matches_cpu(dev, cdt):
    """The field under autograd (forward kernel, then backward kernel via
    loss.backward()) against the same model on the CPU (plain versions):
    outputs within KILO_TOL, parameter gradients within KILO_GRAD_TOL of
    their max; no gradient reaches the points."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField

    model = _kilo(cdt, 5, dev, grid=4)
    cpu = KiloNeRFModel(grid_res=4, hidden_dim=32, compute_dtype=cdt, domain=KILO_DOMAIN)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pts, dirs = _kilo_points("uniform", 3000, dev, seed=5)
    outs = []
    for m, p, d in ((model, pts, dirs), (cpu, pts.cpu(), dirs.cpu())):
        p = p.clone().requires_grad_(True)
        rgb, sigma = KiloNeRFField(m)(p, d)
        (torch.sum(rgb ** 2) + 0.1 * torch.sum(sigma)).backward()
        assert p.grad is None
        outs.append((rgb.detach().cpu(), sigma.detach().cpu(),
                     [q.grad.detach().cpu() for q in m.parameters()]))
    (rg, sg, gg), (rc, sc, gc) = outs
    torch.testing.assert_close(rg, rc, atol=KILO_TOL[cdt], rtol=0)
    torch.testing.assert_close(sg, sc, atol=KILO_TOL[cdt] * max(1.0, float(sc.abs().max())),
                               rtol=0)
    floor = 1e-2 * max(float(x.abs().max()) for x in gc)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= KILO_GRAD_TOL[cdt] * max(float(b.abs().max()), floor)


def test_kilonerf_kernels_refuse_unsupported_widths(dev):
    """Hidden 32 with encodings of at most 64 / 32 columns only (the plain
    versions take any width on the CPU): NotImplementedError naming the
    width, before any launch."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField

    pts, dirs = _kilo_points("uniform", 100, dev)
    for kw in ({"hidden_dim": 64}, {"hidden_dim": 32, "dir_encoding_dim": 6}):
        model = KiloNeRFModel(grid_res=2, domain=KILO_DOMAIN, **kw).to(dev)
        before = KiloNeRFField.launches
        with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden 32"):
            KiloNeRFField(model)(pts, dirs)
        assert KiloNeRFField.launches == before


def test_kilonerf_train_step_on_card_matches_cpu(dev):
    """Two coarse-only 32-sample steps of the same float32 KiloNeRF state
    (grid 4) on one batch (perturb off), on the card through the field
    kernels and on the CPU through their plain versions: loss and mse
    within 10x the kernel tolerance; parameters within the Adam sign noise
    (2 lr per step)."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField

    kw = dict(near=NEAR, far=FAR, num_samples=32, perturb=False, white_background=True)
    cfg = Config(model_type="kilonerf", hidden_dim=32, grid_res=4, **kw)
    states = [create_train_state(cfg, device=d) for d in ("cpu", dev)]
    ro, rd, _ = _inputs(64, 1, "cpu", seed=7)
    tgt = torch.rand(64, 3, generator=torch.Generator().manual_seed(8))
    metrics = []
    for st in states:
        _, train_on_batch = _make_step_body(st.params, RenderSettings(**kw), 64, 0)
        d = st.params.l1.w.device
        batch = RayBatch(*(x.to(d) for x in (ro, rd, tgt, rd)))
        before = (KiloNeRFField.launches, KiloNeRFField.bwd_launches)
        metrics.append([train_on_batch(st, batch) for _ in range(2)])
        n = 2 if d.type == "cuda" else 0
        assert (KiloNeRFField.launches - before[0], KiloNeRFField.bwd_launches - before[1]) == (n, n)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "mse"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=10 * TOL["float32"], atol=0)
    for a, b in zip(states[0].params.parameters(), states[1].params.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=4 * 5e-4, rtol=0)


# ---------------------------------------------------------------- NeRF field


def _field_points(n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn(n, 3, generator=g, device=dev)
    return (torch.rand(n, 3, generator=g, device=dev) * 1.5 - 2.75,
            d / torch.linalg.norm(d, dim=-1, keepdim=True))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 1000, 4096])
def test_nerf_field_kernels_match_plain_versions(dev, cdt, n):
    """Both NeRF field kernels against their plain versions on the card
    (ragged chunks included): rgb and sigma within TOL, the weight
    gradients and the point and direction cotangents within GRAD_TOL of
    their max; one launch each."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import (
        NerfField, nerf_field_bwd_plain, nerf_field_plain)

    model = NeRFModel(compute_dtype=cdt, generator=torch.Generator().manual_seed(3)).to(dev)
    field = NerfField(model).pack()
    pts, dirs = _field_points(n, dev, seed=n)
    cot = torch.randn(n, 4, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    before = (NerfField.launches, NerfField.bwd_launches)
    with torch.no_grad():
        rgb, sigma = field._forward(field.packed, pts, dirs)
        got = field._backward(field.packed, pts, dirs, cot)
        ref_rgb, ref_sigma = nerf_field_plain(field.packed, pts, dirs, 10, 4)
        ref = nerf_field_bwd_plain(field.packed, pts, dirs, cot, 10, 4)
    torch.cuda.synchronize()
    assert (NerfField.launches - before[0], NerfField.bwd_launches - before[1]) == (1, 1)
    torch.testing.assert_close(rgb, ref_rgb, atol=TOL[cdt], rtol=0)
    torch.testing.assert_close(sigma, ref_sigma, atol=TOL[cdt], rtol=0)
    g, r = grad_views(got[0], got[1], 256), grad_views(ref[0], ref[1], 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert float((g[k] - r[k]).abs().max()) <= GRAD_TOL[cdt] * max(
            float(r[k].abs().max()), floor), k
    for a, b in zip(got[2:], ref[2:]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= GRAD_TOL[cdt] * float(b.abs().max())


def test_nerf_field_autograd_on_card_matches_cpu(dev):
    """The float32 field under autograd (forward kernel, then the backward
    kernel through loss.backward()) against the same model on the CPU
    (plain versions): outputs within TOL, parameter and point gradients
    within GRAD_TOL of their max."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField

    model = NeRFModel(generator=torch.Generator().manual_seed(5)).to(dev)
    cpu = NeRFModel()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pts, dirs = _field_points(2000, dev, seed=5)
    outs = []
    for m, p, d in ((model, pts, dirs), (cpu, pts.cpu(), dirs.cpu())):
        p = p.clone().requires_grad_(True)
        rgb, sigma = NerfField(m)(p, d)
        (torch.sum(rgb ** 2) + 0.1 * torch.sum(sigma)).backward()
        outs.append((rgb.detach().cpu(), sigma.detach().cpu(), p.grad.cpu(),
                     [q.grad.detach().cpu() for q in m.parameters()]))
    (rg, sg, pg, gg), (rc, sc, pc, gc) = outs
    torch.testing.assert_close(rg, rc, atol=TOL["float32"], rtol=0)
    torch.testing.assert_close(sg, sc, atol=TOL["float32"], rtol=0)
    for a, b in zip(gg + [pg], gc + [pc]):
        assert float((a - b).abs().max()) <= GRAD_TOL["float32"] * float(b.abs().max())


def test_nerf_field_kernels_refuse_unsupported_widths(dev):
    """Hidden 256 with encodings of at most 64 / 32 columns only:
    NotImplementedError before any launch (the plain versions take any
    width on the CPU)."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField

    pts, dirs = _field_points(100, dev)
    for kw in ({"hidden_dim": 128}, {"dir_encoding_dim": 6}):
        model = NeRFModel(**kw).to(dev)
        before = NerfField.launches
        with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden 256"):
            NerfField(model)(pts, dirs)
        assert NerfField.launches == before


def test_field_route_trains_unsupported_widths_through_the_module(dev):
    """A NeRF at hidden 128 (no kernel of nerf_tpu's takes it) trains on
    the card through the module, launching no kernel and raising nothing;
    a NeRF at 256 takes the NerfField in fused_field_for, one at 512 raises
    naming row 1."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
    from nerf_tpu_torch.train.step import fused_field_for

    kw = dict(near=NEAR, far=FAR, num_samples=16, num_fine_samples=8, perturb=False)
    st = create_train_state(Config(hidden_dim=128, **kw), device=dev)
    ro, rd, _ = _inputs(64, 1, dev, seed=2)
    batch = RayBatch(ro, rd, torch.rand(64, 3, device=dev), rd)
    _, train_on_batch = _make_step_body(st.params, RenderSettings(**kw), 64, 0)
    before = (FusedNerfRender.launches, FusedNerfRender.train_launches, NerfField.launches)
    m = train_on_batch(st, batch)
    assert bool(torch.isfinite(m["loss"])) and st.step == 1
    assert (FusedNerfRender.launches, FusedNerfRender.train_launches,
            NerfField.launches) == before
    assert type(fused_field_for(NeRFModel().to(dev))) is NerfField
    with pytest.raises(NotImplementedError, match="row 1"):
        fused_field_for(NeRFModel(hidden_dim=512).to(dev))


def test_occupancy_bake_on_card_matches_cpu(dev):
    """A 32^3 bake of a float32 NeRF at hidden 256 through the field
    kernel (one launch) against the same bake on the CPU through the plain
    version, thresholded in the widest gap of the densities near their
    median: the same grid."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
    from nerf_tpu_torch.ops.occupancy import bake_occupancy, lattice, sigma_field

    model = NeRFModel(generator=torch.Generator().manual_seed(6)).to(dev)
    cpu = NeRFModel()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    dom = (-2.75, -1.25)
    with torch.no_grad():
        s = torch.sort(sigma_field(NerfField(cpu).pack())(lattice(32, dom))).values
    mid = s.shape[0] // 2
    k = mid - 200 + int(torch.argmax(s[mid - 200:mid + 200].diff()))
    thresh = float(0.5 * (s[k] + s[k + 1]))
    before = NerfField.launches
    grid = bake_occupancy(sigma_field(NerfField(model).pack()), grid_res=32,
                          domain=dom, threshold=thresh, device=dev)
    assert NerfField.launches - before == 1
    ref = bake_occupancy(sigma_field(NerfField(cpu).pack()), grid_res=32,
                         domain=dom, threshold=thresh)
    assert torch.equal(grid.cpu(), ref)


# ---------------------------------------------------------------- SIREN and GaborNet fields


def _sg_model(family, cdt, dev, seed=3, **kw):
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.models.siren import SirenModel

    cls = {"siren": SirenModel, "gabor": GaborModel}[family]
    return cls(compute_dtype=cdt, generator=torch.Generator().manual_seed(seed),
               **kw).to(dev)


def _sg_wrapper(family):
    from nerf_tpu_torch.ops.cuda import fused_gabor, fused_siren

    if family == "siren":
        return (fused_siren.SirenField, fused_siren.siren_field_plain,
                fused_siren.siren_field_bwd_plain)
    return (fused_gabor.GaborField, fused_gabor.gabor_field_plain,
            fused_gabor.gabor_field_bwd_plain)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 16384])
@pytest.mark.parametrize("family", ["siren", "gabor"])
def test_siren_gabor_field_kernels_match_plain_versions(dev, family, cdt, n):
    """Both field kernels of the family against their plain versions on the
    card (a ragged chunk at 37 points, the distillation batch at 16,384):
    rgb within TOL and sigma within TOL of max(1, max |sigma|), every
    gradient (weights, the GaborNet's filter banks, points, directions)
    within GRAD_TOL of its max (the max floored at 1e-2 of the largest, as
    chip_smoke.py's grad_errors; a point's cotangent, whose ReLU masks can
    flip alone, at the 99.9th percentile); the SIREN in bfloat16 within
    chip_smoke.py's SG_TOL (1e-2 and 5e-2: w0 = 30 and sigma_mul = 10
    magnify a flipped bf16 rounding); one launch each."""
    wrapper, plain_fwd, plain_bwd = _sg_wrapper(family)
    model = _sg_model(family, cdt, dev)
    field = wrapper(model).pack()
    k = field.consts
    pts, dirs = _field_points(n, dev, seed=n)
    cot = torch.randn(n, 4, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    before = (wrapper.launches, wrapper.bwd_launches)
    with torch.no_grad():
        rgb, sigma = field._forward(field.packed, pts, dirs)
        got = field._backward(field.packed, pts, dirs, cot)
        ref_rgb, ref_sigma = plain_fwd(field.packed, pts, dirs, k)
        ref = plain_bwd(field.packed, pts, dirs, cot, k)
    torch.cuda.synchronize()
    assert (wrapper.launches - before[0], wrapper.bwd_launches - before[1]) == (1, 1)
    tol, gtol = ((1e-2, 5e-2) if (family, cdt) == ("siren", "bfloat16")
                 else (TOL[cdt], GRAD_TOL[cdt]))
    torch.testing.assert_close(rgb, ref_rgb, atol=tol, rtol=0)
    scale = max(1.0, float(ref_sigma.abs().max()))
    torch.testing.assert_close(sigma, ref_sigma, atol=tol * scale, rtol=0)
    floor = 1e-2 * max(float(g.abs().max()) for g in ref[:-2])
    for a, b in zip(got[:-2], ref[:-2]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= gtol * max(float(b.abs().max()), floor)
    for a, b in zip(got[-2:], ref[-2:]):
        e = (a - b).abs().max(dim=1).values / b.abs().max()
        assert float(torch.quantile(e, 0.999)) <= gtol


@pytest.mark.parametrize("family,kw", [("siren", {"hidden_dim": 128}),
                                       ("gabor", {"hidden_dim": 128}),
                                       ("gabor", {"num_layers": 4})])
def test_siren_gabor_field_kernels_refuse_unsupported_shapes(dev, family, kw):
    """Hidden 256 (and 8 GaborNet stages) only: NotImplementedError for a
    CUDA tensor before any launch (the plain versions take the shape on the
    CPU)."""
    wrapper, _, _ = _sg_wrapper(family)
    model = _sg_model(family, "float32", dev, **kw)
    pts, dirs = _field_points(100, dev)
    before = (wrapper.launches, wrapper.bwd_launches)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="hidden 256"):
        wrapper(model)(pts, dirs)
    p = pts.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="hidden 256"):
        wrapper(model)(p, dirs)
    assert (wrapper.launches, wrapper.bwd_launches) == before


@pytest.mark.parametrize("family", ["siren", "gabor"])
def test_occupancy_bake_of_siren_gabor_launches_the_field_forward(dev, family):
    """Serving with --occupancy 64 (serve.py::build_renderer) bakes a SIREN
    or a GaborNet at hidden 256 through its field forward kernel: 64^3
    points in four launches of 65,536, no backward."""
    from nerf_tpu_torch.serve import build_renderer
    from nerf_tpu_torch.train.loop import render_settings_from_config

    wrapper, _, _ = _sg_wrapper(family)
    cfg = Config(model_type=family, near=NEAR, far=FAR, num_samples=64,
                 num_fine_samples=0, compute_dtype="bfloat16")
    model = _sg_model(family, "bfloat16", dev)
    before = (wrapper.launches, wrapper.bwd_launches)
    renderer, _ = build_renderer(model, None, cfg, render_settings_from_config(cfg),
                                 occupancy=64, log=lambda *_: None)
    assert (wrapper.launches - before[0], wrapper.bwd_launches - before[1]) == (4, 0)
    assert renderer.occupancy.grid.shape == (64, 64, 64, 1)


# ---------------------------------------------------------------- voxel grids


def _grid_points(kind, n, dev, seed=0):
    """Points in [-1, 1]-ish: ``uniform`` over [-1.2, 1.2]^3 (a third clamp to
    the border), ``lines`` the lattice lines of an upsample."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "uniform":
        return torch.rand(n, 3, generator=g, device=dev) * 2.4 - 1.2
    lin = torch.linspace(-1.0, 1.0, 10, device=dev)
    return torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,kind,n", [(16, "uniform", 5000), (7, "uniform", 37),
                                      (2, "uniform", 1), (16, "lines", 1000)])
def test_grid_interp_kernel_matches_plain(dev, dtype, r, kind, n):
    """Row 17 against its plain version on the card: the same float32
    operations in the same order (no fused multiply-add), so to 1e-6 of
    the values (measured equal on the H100); one launch."""
    from nerf_tpu_torch.ops.cuda.fused_grid import (
        GridKernel, cells_of, grid_interp, interp_cells_plain, pack_grid)

    grid = torch.randn(r, r, r, 28, device=dev, generator=torch.Generator(device=dev).manual_seed(r))
    src = pack_grid(grid, dtype)
    src = grid if src is None else src
    pts = _grid_points(kind, n, dev, seed=n)
    before = GridKernel.launches
    got = grid_interp(src, pts)
    torch.cuda.synchronize()
    assert GridKernel.launches == before + 1
    ref = interp_cells_plain(src, cells_of(pts, r))
    assert got.shape == (pts.shape[0], 28) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["uniform", "runs", "one_id", "channels"])
def test_scatter_add_kernel_exact_and_deterministic(dev, case):
    """Row 19 against float64 sums: each row within (K + pieces) ulps of its
    sum of magnitudes (the kernel sums pieces of at most K = 256 rows, then
    the pieces in order); against the plain version within the two
    bounds; two runs equal bit for bit; untouched rows exactly zero; one
    launch. ``runs``: 3,000 rows of one id (12 chunks) among uniform ids;
    ``one_id``: every row one id; ``channels``: 1 and 32 channels."""
    from nerf_tpu_torch.ops.cuda.scatter_add import (
        ScatterKernel, scatter_add_plain, scatter_add_rows)

    g = torch.Generator(device=dev).manual_seed(3)
    m, rows = 20000, 5000
    for c in ((1, 32) if case == "channels" else (28,)):
        ids = torch.randint(0, rows, (m,), generator=g, device=dev)
        if case == "runs":
            ids[torch.randperm(m, generator=g, device=dev)[:3000]] = 17
        elif case == "one_id":
            ids[:] = 4321
        vals = torch.randn(m, c, generator=g, device=dev)
        before = ScatterKernel.launches
        a = scatter_add_rows(ids, vals, rows)
        b = scatter_add_rows(ids, vals, rows)
        torch.cuda.synchronize()
        assert ScatterKernel.launches == before + 2
        assert torch.equal(a, b)
        exact = torch.zeros(rows, c, dtype=torch.float64, device=dev).index_add_(
            0, ids, vals.double())
        mags = torch.zeros(rows, c, dtype=torch.float64, device=dev).index_add_(
            0, ids, vals.abs().double())
        counts = torch.bincount(ids, minlength=rows).double()[:, None]
        ulp = 2.0 ** -24
        assert bool(((a.double() - exact).abs() <= (256 + counts / 256 + 2) * ulp * mags).all())
        plain = scatter_add_plain(ids, vals, rows)
        assert bool(((plain.double() - exact).abs() <= (counts + 2) * ulp * mags).all())
        assert bool((a[counts[:, 0] == 0] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(100, 24), (37, 5), (64, 300), (1, 1)])
def test_grid_render_kernel_matches_plain(dev, dtype, shape):
    """Row 18 against its plain version on the card (a 16^3 x 28 grid over
    the default grid_domain, camera rays towards the origin): rgb, acc and
    weights within 1e-5, depth within 1e-4 (the plain version's cumprod and
    sums run in another order; expf and the division round alike); one
    launch; S = 300 spans ten 32-sample batches of t."""
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedGridRender, _expand_basis, grid_render_plain)
    from nerf_tpu_torch.models.plenoxels import sh_basis

    model = PlenoxelsModel(grid_res=16, interp_dtype=dtype, domain=(-2.75, -1.25)).to(dev)
    with torch.no_grad():
        model.grid.normal_(0.0, 0.7, generator=torch.Generator(device=dev).manual_seed(5))
    n, s = shape
    ro, rd, t = _inputs(n, s, dev, seed=n + s)
    rd = torch.nn.functional.normalize(-ro + 0.3 * rd, dim=-1)
    fr = FusedGridRender(model, NEAR, FAR)
    with torch.no_grad():
        pack = fr.pack(model)
        before = FusedGridRender.launches
        got = fr(pack, ro, rd, rd, t)
        torch.cuda.synchronize()
        assert FusedGridRender.launches == before + 1
        src = model.grid if pack.packed is None else pack.packed
        o_aff, d_aff = fr.affine(ro, rd, 16)
        ref = grid_render_plain(src, o_aff, d_aff, t, _expand_basis(sh_basis(rd, 2)), fr.sel)
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert got[k].shape == ref[i].shape and torch.isfinite(got[k]).all()
        torch.testing.assert_close(got[k], ref[i], atol=1e-4 if k == "depth" else 1e-5, rtol=0)


def test_grid_kernels_refuse_unsupported_shapes(dev):
    """More than 32 channels, or a grid of one cell a side: the three
    wrappers raise NotImplementedError naming their row, before any
    launch."""
    from nerf_tpu_torch.ops.cuda.fused_grid import GridKernel, grid_interp
    from nerf_tpu_torch.ops.cuda.scatter_add import ScatterKernel, scatter_add_rows
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender

    pts = torch.zeros(5, 3, device=dev)
    before = (GridKernel.launches, ScatterKernel.launches, FusedGridRender.launches)
    for r, c in ((4, 33), (1, 28)):
        with pytest.raises(NotImplementedError, match="row 17"):
            grid_interp(torch.zeros(r, r, r, c, device=dev), pts)
    with pytest.raises(NotImplementedError, match="row 19"):
        scatter_add_rows(torch.zeros(5, dtype=torch.long, device=dev),
                         torch.zeros(5, 33, device=dev), 10)
    model = PlenoxelsModel(grid_res=4, sh_degree=3).to(dev)        # 49 channels
    ro, rd, t = _inputs(4, 8, dev)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="row 18"):
        FusedGridRender(model, NEAR, FAR)(model, ro, rd, rd, t)
    assert before == (GridKernel.launches, ScatterKernel.launches, FusedGridRender.launches)


def test_plenoxels_train_step_and_eval_on_card_match_cpu(dev):
    """Two coarse-only 32-sample steps with TV of the same float32 Plenoxels
    state (grid 12, lr 0.01) on one batch (perturb off), on the card (one
    row-17 and one row-19 launch a step) and on the CPU (plain versions):
    loss and mse within 1e-5 relative; the grids within the Adam noise of
    near-zero gradients (0.05 lr); then a 16 x 8 eval render with tile
    order (bfloat16 interp) on both within 1e-5, two row-18 launches (chunk
    64)."""
    from nerf_tpu_torch.ops.cuda.fused_grid import GridKernel
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender
    from nerf_tpu_torch.ops.cuda.scatter_add import ScatterKernel
    from nerf_tpu_torch.train.loop import make_regularizer

    kw = dict(near=NEAR, far=FAR, num_samples=32, perturb=False, white_background=True)
    cfg = Config(model_type="plenoxels", grid_res=12, learning_rate=0.01, tv_lambda=1e-3,
                 tv_sh_lambda=1e-2, chunk_size=64, **kw)
    states = [create_train_state(cfg, device=d) for d in ("cpu", dev)]
    with torch.no_grad():
        noise = torch.randn(states[0].params.grid.shape, generator=torch.Generator().manual_seed(2))
        for st in states:
            st.params.grid.add_(0.5 * noise.to(st.params.grid.device))
    ro, rd, _ = _inputs(64, 1, "cpu", seed=9)
    rd = torch.nn.functional.normalize(-ro + 0.3 * rd, dim=-1)
    tgt = torch.rand(64, 3, generator=torch.Generator().manual_seed(8))
    metrics = []
    for st in states:
        _, train_on_batch = _make_step_body(st.params, RenderSettings(**kw), 64, 0,
                                            regularizer=make_regularizer(cfg, st.params))
        d = st.params.grid.device
        batch = RayBatch(*(x.to(d) for x in (ro, rd, tgt, rd)))
        before = (GridKernel.launches, ScatterKernel.launches)
        metrics.append([train_on_batch(st, batch) for _ in range(2)])
        n = 2 if d.type == "cuda" else 0
        assert (GridKernel.launches - before[0], ScatterKernel.launches - before[1]) == (n, n)
    for m_cpu, m_gpu in zip(*metrics):
        for k in ("loss", "mse"):
            torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-5, atol=0)
    torch.testing.assert_close(states[1].params.grid.detach().cpu(),
                               states[0].params.grid.detach(), atol=0.05 * 0.01, rtol=0)
    settings = RenderSettings(near=NEAR, far=FAR, num_samples=32, perturb=False, chunk_size=64)
    o = torch.tensor([[0.0, 0.0, 4.0]]).repeat(128, 1)
    jj, ii = torch.meshgrid(torch.arange(8.0), torch.arange(16.0), indexing="xy")
    d = torch.nn.functional.normalize(torch.stack([(jj - 4) / 20, -(ii - 8) / 20,
                                                   -torch.ones_like(ii)], -1).reshape(-1, 3), dim=-1)
    outs = []
    for st in states:
        dv = st.params.grid.device
        before = FusedGridRender.launches
        out = make_eval_render(st.params, settings)(st.params, None, o.to(dv), d.to(dv), hw=(16, 8))
        assert FusedGridRender.launches - before == (2 if dv.type == "cuda" else 0)
        outs.append(out)
    st_cpu = states[0].params
    st_cpu.grid.data.copy_(states[1].params.grid.detach().cpu())
    cpu_again = make_eval_render(st_cpu, settings)(st_cpu, None, o, d, hw=(16, 8))
    torch.testing.assert_close(outs[1].rgb.cpu(), cpu_again.rgb, atol=1e-5, rtol=0)
    torch.testing.assert_close(outs[1].acc.cpu(), cpu_again.acc, atol=1e-5, rtol=0)
