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


@pytest.mark.parametrize("family, shape", [
    ("nerf", (8192, 64)), ("nerf", (8192, 192)), ("nerf", (300, 37)),
    ("gabor", (1024, 256)), ("gabor", (1000, 256)), ("gabor", (1024, 37)),
    ("siren", (1024, 256)), ("siren", (1000, 256)), ("siren", (1024, 37))])
def test_bf16_fwd_tc_kernel_matches_plain_and_is_deterministic(dev, family, shape):
    """The bfloat16 forward renders on the tensor cores (fused_render_fwd_tc,
    fused_render_gabor_fwd_tc, fused_render_siren_fwd_tc) at lego.txt's
    serving chunk (8192 rays x 64 and 192 samples) and lego_siren.txt's
    (1024 x 256), a ragged ray count and an odd S (chunks span rays): within
    TOL of their plain versions, and two launches give the same bits."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import fused_gabor_render_plain
    from nerf_tpu_torch.ops.cuda.fused_render_siren import fused_siren_render_plain

    ro, rd, t = _inputs(*shape, dev, seed=6)
    with torch.no_grad():
        if family == "nerf":
            model = NeRFModel(compute_dtype="bfloat16",
                              generator=torch.Generator().manual_seed(2)).to(dev)
            fr = FusedNerfRender(model, NEAR, FAR)
            packed = fr.pack(model)
            o_aff, d_aff = fr.affine(ro, rd)
            args = (packed, o_aff, d_aff, rd, t)
            ref = fused_render_plain(packed, o_aff, d_aff, rd, t, 10, 4)
        elif family == "gabor":
            model, fr = _gabor("bfloat16", 2, dev)
            packed = fr.pack(model).packed
            args = (packed, _gabor_coeffs(fr, model, ro, rd), rd, t)
            ref = fused_gabor_render_plain(*args, fr.consts)
        else:
            model, fr = _siren("bfloat16", 2, dev)
            o_aff, d_aff = fr.affine(ro, rd)
            args = (fr.pack(model), o_aff, d_aff, rd, t)
            ref = fused_siren_render_plain(*args, fr.consts)
        assert fr.fwd_library().endswith("_tc")
        before = type(fr).launches
        got = fr._forward(*args)
        again = fr._forward(*args)
        torch.cuda.synchronize()
        assert type(fr).launches == before + 2
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert torch.equal(got[i], again[i]), k
        assert torch.isfinite(got[i]).all(), k
        scale = 10.0 if k == "depth" else 1.0
        err = float((got[i] - ref[i]).abs().max())
        assert err <= TOL["bfloat16"] * scale, (k, err)


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
@pytest.mark.parametrize("shape", [(300, 37), (5, 8), (133, 64), (64, 192), (64, 256)])
@pytest.mark.parametrize("white_bg", [True, False])
def test_train_kernel_matches_plain(dev, cdt, shape, white_bg):
    """Odd S (chunks span rays), a ray count that leaves CTAs idle, 133
    rays (one more than the SMs: two rays on some CTAs), and the full S of
    lego.txt's fine pass and of the headline step. bfloat16 runs on the
    tensor cores (fused_render_train_tc), float32 on the CUDA cores."""
    model = NeRFModel(compute_dtype=cdt,
                      generator=torch.Generator().manual_seed(4)).to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    assert fr.grad_library(True) == {"float32": "fused_render_train",
                                     "bfloat16": "fused_render_train_tc"}[cdt]
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


@pytest.mark.parametrize("shape", [(133, 64), (64, 256)])
def test_bf16_train_kernel_is_deterministic(dev, shape):
    """The tensor-core train pass adds its per-CTA partials in CTA order and
    nothing atomically: two launches on the same inputs give the same bits."""
    model = NeRFModel(compute_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(9)).to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    ro, rd, t = _inputs(*shape, dev, seed=4)
    tgt = torch.rand(shape[0], 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        a = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
        b = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
    for x, y in zip(a[:4] + a[4], b[:4] + b[4]):
        assert torch.equal(x, y)


def test_bf16_train_library_sizes(dev):
    """The tensor-core library's stash bytes a point are the host's
    TC_BYTES_PER_POINT (tests/test_torch_port_kernel_plans.py), its
    partials and outputs those of the CUDA-core train pass."""
    from nerf_tpu_torch.ops.cuda.fused_render import (
        TC_BYTES_PER_POINT, _library, grad_sizes)

    tc = grad_sizes(_library("fused_render_train_tc").fused_render_train_tc_sizes)
    old = grad_sizes(_library("fused_render_train").fused_render_grad_sizes)
    assert tc[0] == TC_BYTES_PER_POINT
    assert tc[1:] == old[1:]


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


@pytest.mark.parametrize("shape", [(133, 64), (64, 192), (300, 37)])
def test_bf16_render_backward_tc_matches_plain_and_recomputes_row_3(dev, shape):
    """Row 4 in bfloat16 on the tensor cores (fused_render_bwd_tc): within
    GRAD_TOL of the plain version, from a cotangent whose acc column is
    zero on half the rays; two launches give the same bits; one backward
    launch; and the compositing weights it recomputes equal the bf16
    forward render's (row 3) bit for bit, since both run one chain and
    composite with the same expressions."""
    model = NeRFModel(compute_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(12)).to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    assert fr.grad_library(False) == "fused_render_train_tc"
    ro, rd, t = _inputs(*shape, dev, seed=13)
    g_ray = torch.randn(shape[0], 8, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(14))
    g_ray[:, 5:] = 0
    g_ray[::2, 3] = 0
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        before = FusedNerfRender.bwd_launches
        got = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
        again = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
        torch.cuda.synchronize()
        assert FusedNerfRender.bwd_launches == before + 2
        ref = fused_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, 10, 4)
        grads, loss, rgb, acc, weights = fr._launch_grad(
            packed, o_aff, d_aff, rd, t, g_ray, False, False, True)
        fwd = fr._forward(packed, o_aff, d_aff, rd, t)
        torch.cuda.synchronize()
    _assert_grads(got, ref, "bfloat16")
    for x, y, z in zip(got, again, grads):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert float(loss) == 0.0 and rgb is None and acc is None
    assert torch.equal(weights, fwd[3]), float((weights - fwd[3]).abs().max())


def test_cuda_core_render_grad_refuses_bf16(dev):
    """The CUDA-core library's entry refuses bfloat16 (-2) for the train
    pass and the render backward alike, naming the tensor-core entries."""
    from nerf_tpu_torch.ops.cuda.fused_render import _library

    lib = _library("fused_render_train")
    for train in (1, 0):
        code = lib.fused_render_grad(*[None] * 7, 0, 0, 1, train, None, 0.0, 0.0,
                                     1, 1, 1, 64, 63, 27, *[None] * 7)
        assert code == -2
    assert "fused_render_bwd_tc" in lib.fused_render_grad_error(-2).decode()


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


@pytest.mark.parametrize("shape", [(1024, 256), (133, 64)])
def test_bf16_siren_train_tc_kernel_matches_plain_and_is_deterministic(dev, shape):
    """The bfloat16 SIREN train pass on the tensor cores
    (fused_render_siren_train_tc) at lego_siren.txt's step (1024 x 256) and
    a ragged 133 x 64 (two rays on some CTAs): loss, rgb, acc and weights
    within TOL, every gradient within GRAD_TOL of its max (floored at 1e-2
    of the largest), and two launches give the same bits."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_train_plain, grad_views)

    model, fr = _siren("bfloat16", 4, dev)
    assert fr.grad_library(True) == "fused_render_siren_train_tc"
    ro, rd, t = _inputs(*shape, dev, seed=1)
    tgt = torch.rand(shape[0], 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        before = FusedSirenRender.train_launches
        got = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
        again = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
        torch.cuda.synchronize()
        assert FusedSirenRender.train_launches == before + 2
        ref = fused_siren_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, fr.consts)
    for x, y in zip(got[:4] + got[4], again[:4] + again[4]):
        assert torch.equal(x, y)
    g, r = grad_views(*got[4], 256), grad_views(*ref[4], 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert torch.isfinite(g[k]).all(), k
        scale = max(float(r[k].abs().max()), floor)
        err = float((g[k] - r[k]).abs().max())
        assert err <= GRAD_TOL["bfloat16"] * scale, (k, err, scale)
    torch.testing.assert_close(got[0], ref[0], rtol=TOL["bfloat16"], atol=0)
    for i in (1, 2, 3):
        torch.testing.assert_close(got[i], ref[i], atol=TOL["bfloat16"], rtol=0)


def test_bf16_siren_render_and_train_pass_run_one_chain(dev):
    """The bfloat16 SIREN forward render (fused_render_siren_fwd_tc) and
    train pass (fused_render_siren_train_tc) share their forward chain: on
    one 1024 x 64 batch their rgb, acc and compositing weights are equal
    bit for bit."""
    model, fr = _siren("bfloat16", 3, dev)
    ro, rd, t = _inputs(1024, 64, dev, seed=8)
    tgt = torch.rand(1024, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        rgb, acc, _, weights = fr._forward(packed, o_aff, d_aff, rd, t)
        _, rgb_t, acc_t, weights_t, _ = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
    assert torch.equal(rgb, rgb_t) and torch.equal(acc, acc_t)
    assert torch.equal(weights, weights_t)


def test_bf16_siren_train_library_sizes(dev):
    """The SIREN tensor-core library's stash bytes a point are the host's
    TC_BYTES_PER_POINT (tests/test_torch_port_kernel_plans.py), its
    partials and outputs those of the CUDA-core train pass."""
    from nerf_tpu_torch.ops.cuda.fused_render import grad_sizes
    from nerf_tpu_torch.ops.cuda.fused_render_siren import TC_BYTES_PER_POINT, _library

    tc = grad_sizes(_library("fused_render_siren_train_tc").fused_siren_train_tc_sizes)
    old = grad_sizes(_library("fused_render_siren_train").fused_siren_grad_sizes)
    assert tc[0] == TC_BYTES_PER_POINT
    assert tc[1:] == old[1:]


@pytest.mark.parametrize("shape", [(1024, 256), (1024, 37), (133, 64)])
def test_bf16_siren_render_backward_tc_matches_plain_and_recomputes_row_6(dev, shape):
    """Row 7 in bfloat16 on the tensor cores (fused_siren_render_bwd_tc):
    every gradient within GRAD_TOL of its max (floored at 1e-2 of the
    largest) against the plain version, from a cotangent whose acc column
    is zero on half the rays; two launches give the same bits; and the
    compositing weights it recomputes equal the bf16 forward render's (row
    6) bit for bit, since both run one chain and composite with the same
    expressions."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_render_bwd_plain, grad_views)

    model, fr = _siren("bfloat16", 12, dev)
    assert fr.grad_library(False) == "fused_render_siren_train_tc"
    ro, rd, t = _inputs(*shape, dev, seed=13)
    g_ray = 1e-3 * torch.randn(shape[0], 8, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(14))
    g_ray[:, 5:] = 0
    g_ray[::2, 3] = 0
    with torch.no_grad():
        packed = fr.pack(model)
        o_aff, d_aff = fr.affine(ro, rd)
        before = FusedSirenRender.bwd_launches
        got = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
        again = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
        torch.cuda.synchronize()
        assert FusedSirenRender.bwd_launches == before + 2
        ref = fused_siren_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, fr.consts)
        grads, loss, rgb, acc, weights = fr._launch_grad(
            packed, o_aff, d_aff, rd, t, g_ray, False, False, True)
        fwd = fr._forward(packed, o_aff, d_aff, rd, t)
        torch.cuda.synchronize()
    g, r = grad_views(*got, 256), grad_views(*ref, 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert torch.isfinite(g[k]).all(), k
        scale = max(float(r[k].abs().max()), floor)
        err = float((g[k] - r[k]).abs().max())
        assert err <= GRAD_TOL["bfloat16"] * scale, (k, err, scale)
    for x, y, z in zip(got, again, grads):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert float(loss) == 0.0 and rgb is None and acc is None
    assert torch.equal(weights, fwd[3]), float((weights - fwd[3]).abs().max())


def test_cuda_core_siren_grad_refuses_bf16(dev):
    """The SIREN CUDA-core library's entry refuses bfloat16 (-2) for the
    train pass and the render backward alike, naming the tensor-core
    entries."""
    from nerf_tpu_torch.ops.cuda.fused_render_siren import _library

    lib = _library("fused_render_siren_train")
    for train in (1, 0):
        code = lib.fused_siren_grad(*[None] * 7, 0, 0, 1, train, None, 0.0, 0.0,
                                    1, 1, 1, 64, 27, 30.0, 30.0, 1.0, 1.0, *[None] * 7)
        assert code == -2
    assert "fused_siren_render_bwd_tc" in lib.fused_siren_grad_error(-2).decode()


def test_eval_cli_renders_a_lego_frame_through_the_kernel(dev, tmp_path):
    """The port's eval CLI on the card (its default device): one orbit
    frame of a seeded configs/lego.txt model at 400 x 400 is 2 x
    ceil(160000 / 8192) = 40 launches of the bf16 forward render (row 3),
    written as a 400 x 400 PNG of finite values."""
    import json
    import os

    from nerf_tpu_torch.cli.eval_cli import main as eval_main
    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.registry import model_from_config
    from nerf_tpu_torch.utils.checkpoint import save_checkpoint
    from nerf_tpu_torch.utils.png import read_png, write_png

    scene = tmp_path / "scene"
    (scene / "test").mkdir(parents=True)
    write_png(str(scene / "test" / "r_0.png"), np.full((400, 400, 4), 255, np.uint8))
    (scene / "transforms_test.json").write_text(json.dumps({
        "camera_angle_x": 0.6911112070083618,
        "frames": [{"file_path": "./test/r_0", "transform_matrix": np.eye(4).tolist()}]}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "lego.txt")) as f:
        text = f.read()
    cfg_path = tmp_path / "lego.txt"
    cfg_path.write_text(text + f"\ndataset_path = {scene}\nnum_render_poses = 1\n")
    cfg = parse_config_file(str(cfg_path))
    gen = torch.Generator().manual_seed(cfg.seed)
    ckpt = save_checkpoint(model_from_config(cfg, generator=gen),
                           model_from_config(cfg, generator=gen), str(tmp_path / "models"),
                           "nerf", 0)
    before = FusedNerfRender.launches
    eval_main(["--config", str(cfg_path), "--checkpoint", ckpt,
               "--output", str(tmp_path / "frames")], log=lambda *a: None)
    assert FusedNerfRender.launches == before + 40
    frame = read_png(str(tmp_path / "frames" / "frame_0000.png"))
    assert frame.shape == (400, 400, 3)


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
@pytest.mark.parametrize("shape", [(5, 13), (7, 37), (300, 37), (1024, 256), (1000, 256),
                                   (1024, 37)])
@pytest.mark.parametrize("white_bg", [True, False])
def test_gabor_train_kernel_matches_plain(dev, cdt, shape, white_bg):
    """Loss, rgb, acc, weights, the 23 weight gradients and dA..dR; few
    rays (idle CTAs), chunks that span rays (S = 13, 37), lego_siren.txt's
    step (1024 x 256) and a ragged ray count (1000 x 256). The bfloat16
    pass runs on the tensor cores (fused_render_gabor_train_tc), and two
    launches of it give the same bits."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_train_plain, grad_views)

    model, fr = _gabor(cdt, 4, dev)
    tc = cdt == "bfloat16"
    assert fr.grad_library(True) == ("fused_render_gabor_train_tc" if tc
                                     else "fused_render_gabor_train")
    ro, rd, t = _inputs(*shape, dev, seed=1)
    tgt = torch.rand(shape[0], 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    coeffs = _gabor_coeffs(fr, model, ro, rd)
    with torch.no_grad():
        packed = fr.pack(model).packed
        before = FusedGaborRender.train_launches
        got = fr._train(packed, coeffs, rd, t, tgt, white_bg)
        if tc:
            again = fr._train(packed, coeffs, rd, t, tgt, white_bg)
        torch.cuda.synchronize()
        assert FusedGaborRender.train_launches == before + (2 if tc else 1)
        if tc:
            for x, y in zip(got[:4] + got[4] + got[5:], again[:4] + again[4] + again[5:]):
                assert torch.equal(x, y)
            del again
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


def test_bf16_gabor_render_and_train_pass_run_one_chain(dev):
    """The bfloat16 GaborNet forward render (fused_render_gabor_fwd_tc) and
    train pass (fused_render_gabor_train_tc) share their forward chain: on
    one 1024 x 64 batch their rgb, acc and compositing weights are equal bit
    for bit."""
    model, fr = _gabor("bfloat16", 3, dev)
    ro, rd, t = _inputs(1024, 64, dev, seed=8)
    tgt = torch.rand(1024, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    coeffs = _gabor_coeffs(fr, model, ro, rd)
    with torch.no_grad():
        packed = fr.pack(model).packed
        rgb, acc, _, weights = fr._forward(packed, coeffs, rd, t)
        _, rgb_t, acc_t, weights_t, _, _ = fr._train(packed, coeffs, rd, t, tgt, True)
    assert torch.equal(rgb, rgb_t) and torch.equal(acc, acc_t)
    assert torch.equal(weights, weights_t)


@pytest.mark.parametrize("n", [65536, 16384, 1000, 37])
def test_bf16_gabor_field_fwd_tc_matches_plain_and_is_deterministic(dev, n):
    """The bfloat16 GaborNet field forward on the tensor cores
    (fused_gabor_fwd_tc) at a bake's 65,536 points, the distillation batch
    and two ragged chunks: rgb within TOL and sigma within TOL of max(1,
    max |sigma|) of its plain version (chip_smoke.py's phase 20), and two
    launches give the same bits."""
    from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField, gabor_field_plain

    model = _sg_model("gabor", "bfloat16", dev)
    field = GaborField(model).pack()
    assert field.fwd_library() == "fused_gabor_fwd_tc"
    pts, dirs = _field_points(n, dev, seed=n + 1)
    before = GaborField.launches
    with torch.no_grad():
        rgb, sigma = field._forward(field.packed, pts, dirs)
        rgb2, sigma2 = field._forward(field.packed, pts, dirs)
        ref_rgb, ref_sigma = gabor_field_plain(field.packed, pts, dirs, field.consts)
    torch.cuda.synchronize()
    assert GaborField.launches - before == 2
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(sigma).all())
    torch.testing.assert_close(rgb, ref_rgb, atol=TOL["bfloat16"], rtol=0)
    scale = max(1.0, float(ref_sigma.abs().max()))
    torch.testing.assert_close(sigma, ref_sigma, atol=TOL["bfloat16"] * scale, rtol=0)


@pytest.mark.parametrize("n", [65536, 16384, 1000, 37])
@pytest.mark.parametrize("family", ["nerf", "siren"])
def test_bf16_nerf_siren_field_fwd_tc_matches_plain_and_is_deterministic(dev, family, n):
    """The bfloat16 NeRF and SIREN field forwards on the tensor cores
    (fused_nerf_fwd_tc, fused_siren_fwd_tc) at a bake's 65,536 points, the
    distillation batch and two ragged chunks: two launches of the
    tensor-core library give the same bits, and rgb and sigma are within
    chip_smoke.py's phase-17 / phase-20 tolerances of their plain versions
    (NeRF: TOL absolute; SIREN: SG_TOL's 1e-2, sigma over max(1, max
    |sigma|))."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField, nerf_field_plain
    from nerf_tpu_torch.ops.cuda.fused_siren import SirenField, siren_field_plain

    if family == "nerf":
        model = NeRFModel(compute_dtype="bfloat16",
                          generator=torch.Generator().manual_seed(3)).to(dev)
        wrapper, tol, scaled = NerfField, TOL["bfloat16"], False
        field = wrapper(model).pack()
        plain = lambda p, d: nerf_field_plain(field.packed, p, d, 10, 4)  # noqa: E731
    else:
        model = _sg_model("siren", "bfloat16", dev)
        wrapper, tol, scaled = SirenField, 1e-2, True
        field = wrapper(model).pack()
        plain = lambda p, d: siren_field_plain(field.packed, p, d, field.consts)  # noqa: E731
    assert field.fwd_library() == f"fused_{family}_fwd_tc"
    pts, dirs = _field_points(n, dev, seed=n + 1)
    before = wrapper.launches
    with torch.no_grad():
        rgb, sigma = field._forward(field.packed, pts, dirs)
        rgb2, sigma2 = field._forward(field.packed, pts, dirs)
        ref_rgb, ref_sigma = plain(pts, dirs)
    torch.cuda.synchronize()
    assert wrapper.launches - before == 2
    assert torch.equal(rgb, rgb2) and torch.equal(sigma, sigma2)
    assert bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(sigma).all())
    torch.testing.assert_close(rgb, ref_rgb, atol=tol, rtol=0)
    scale = max(1.0, float(ref_sigma.abs().max())) if scaled else 1.0
    torch.testing.assert_close(sigma, ref_sigma, atol=tol * scale, rtol=0)


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


# A bf16 pre-activation within this share of the sum of its terms'
# magnitudes of 0 lies within reach of bf16 roundings flipped upstream (each
# moves its term by one bf16 step, at most 2^-7 of it): the tensor-core
# kernel's sums, which round otherwise than the plain version's float32
# ones, may give it either sign.
KILO_BF16_TIE = 2.0 ** -7


def _kilo_bf16_mask_flips(wc, disp, masks):
    """Where the bf16 backward kernel's ReLU masks ``masks`` (its debug
    output, point order) differ from the plain version's: ``(flips, ties)``,
    bool (n, 97) in sorted order over the units of x1, x2, the density and
    y, ``ties`` the units whose plain pre-activation lies within
    KILO_BF16_TIE of its terms' magnitudes of 0."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import PLAIN_TILE, _acts, _tiles, unit_masks

    tiles = _tiles(disp, PLAIN_TILE)
    a = _acts(wc, disp, tiles, 32, 10, 4)
    v = a["w"]

    def r(x):
        return x.to(torch.bfloat16).float()

    def b(k, cols=slice(None)):
        return v[k][:, None, cols]

    x1r, fr, wt, wr1 = r(a["x1"]), r(a["feat"]), v["trunk.w"], v["rgb1.w"]
    pre = torch.cat([a["penc"] @ v["l1.w"] + b("l1.b"), x1r @ v["l2.w"] + b("l2.b"),
                     a["sigma_pre"][..., None],
                     fr @ wr1[:, :32] + a["denc"] @ wr1[:, 32:] + b("rgb1.b")], dim=-1)
    mag = torch.cat([a["penc"].abs() @ v["l1.w"].abs() + b("l1.b").abs(),
                     x1r @ v["l2.w"].abs() + b("l2.b").abs(),
                     a["x2"] @ wt[:, :, 32:].abs() + b("trunk.b", slice(32, None)).abs(),
                     fr.abs() @ wr1[:, :32].abs() + a["denc"].abs() @ wr1[:, 32:].abs()
                     + b("rgb1.b").abs()], dim=-1)
    plain = torch.cat([a["m1"], a["m2"], a["msig"][..., None], a["my"]], dim=-1)
    m1, m2, my, msig = unit_masks(masks[disp.order], 32)
    kernel = torch.cat([m1, m2, msig[:, None], my], dim=-1)
    flips = plain.reshape(-1, KILO_UNITS)[tiles.pos] != kernel
    ties = (pre.abs() <= KILO_BF16_TIE * mag).reshape(-1, KILO_UNITS)[tiles.pos]
    return flips, ties


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
    1024 x 256 serving/training count; one launch each. The bf16 backward
    runs on the tensor cores, whose sums round otherwise than the plain
    version's float32 ones: at a bf16 tie (KILO_BF16_TIE) a ReLU mask may
    flip, and one flip at a point of large activations moves its network's
    gradient by up to 1.2e-2 of the max (the camera set). So its gradient
    is held to the plain version's at the kernel's own masks (its debug
    output), and every mask it flips must lie at a tie, on at most 0.1% of
    the points."""
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
    # the cotangent row by row in sorted order, as the backward kernel reads
    # it, handed over in point order (the field's convention)
    cot_sorted = torch.randn(n, 4, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
    cot = torch.empty_like(cot_sorted).index_copy_(0, disp.order, cot_sorted)
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
    if cdt == "bfloat16":
        masks = torch.empty(n, 4, dtype=torch.int32, device=dev)
        with torch.no_grad():
            assert torch.equal(field._launch_bwd(wc, disp, cot, masks=masks), grad)
            flips, ties = _kilo_bf16_mask_flips(wc, disp, masks)
            at_masks = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4, masks=masks)
        print(f"\nrow 16 bf16 {kind} {n}: {int(flips.sum())} ReLU masks unlike the plain "
              f"version's at {int(flips.any(1).sum())} points, {int((flips & ~ties).sum())} "
              f"away from a tie; error over max |g| against the plain version "
              f"{max(_kilo_grad_errors(grad, ref_g).values()):.3e}, at the kernel's masks "
              f"{max(_kilo_grad_errors(grad, at_masks).values()):.3e}")
        assert not bool((flips & ~ties).any())
        assert int(flips.any(1).sum()) <= 0.001 * n
        ref_g = at_masks
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


# float32 KiloNeRF units whose float64 pre-activation lies within this many
# ulps of the sum of its terms' magnitudes from 0: a float32 chain in any
# summation order may give either sign there, and so either ReLU mask
KILO_TIE_ULPS = 256
KILO_UNITS = 32 + 32 + 1 + 32           # l1, l2, the density, rgb1


def _kilo_chain64(v, penc, denc, g, flip=None):
    """The float32 chain of ``kilonerf_bwd_plain`` in float64, a point at a
    time: ``v`` each point's network's weights (m, ...), ``g`` its (m, 4)
    cotangent. Returns the (m, R) gradient of each point, its (m, 97)
    pre-activations and the sums of their terms' magnitudes. ``flip``
    (m, 97) bool inverts those units' ReLU masks in the backward (their
    forward values, within rounding of 0, stay)."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import layer_shapes

    h = 32

    def mv(x, w):                                   # (m, i) @ (m, i, j)
        return torch.einsum("mi,mij->mj", x, w)

    def mvt(dz, w):                                 # (m, j) @ (m, i, j)^T
        return torch.einsum("mj,mij->mi", dz, w)

    def outer(x, dz):
        return x[:, :, None] * dz[:, None, :]

    wt, bt, wr1 = v["trunk.w"], v["trunk.b"], v["rgb1.w"]
    a1 = mv(penc, v["l1.w"]) + v["l1.b"]
    s1 = mv(penc.abs(), v["l1.w"].abs()) + v["l1.b"].abs()
    x1 = torch.relu(a1)
    a2 = mv(x1, v["l2.w"]) + v["l2.b"]
    s2 = mv(x1, v["l2.w"].abs()) + v["l2.b"].abs()
    x2 = torch.relu(a2)
    asig = (x2 * wt[:, :, h]).sum(-1, keepdim=True) + bt[:, h:]
    ssig = (x2 * wt[:, :, h].abs()).sum(-1, keepdim=True) + bt[:, h:].abs()
    feat = mv(x2, wt[..., :h]) + bt[:, :h]
    a3 = mv(feat, wr1[:, :h]) + mv(denc, wr1[:, h:]) + v["rgb1.b"]
    s3 = (mv(feat.abs(), wr1[:, :h].abs()) + mv(denc.abs(), wr1[:, h:].abs())
          + v["rgb1.b"].abs())
    y = torch.relu(a3)
    rgb = torch.sigmoid(mv(y, v["rgb2.w"]) + v["rgb2.b"])
    pre = torch.cat([a1, a2, asig, a3], dim=1)
    mask = (pre > 0) if flip is None else (pre > 0) ^ flip
    m1, m2, msig, m3 = mask.double().split([h, h, 1, h], dim=1)
    gr = {}
    dzr2 = g[:, :3] * rgb * (1.0 - rgb)
    gr["rgb2.w"], gr["rgb2.b"] = outer(y, dzr2), dzr2
    dzy = mvt(dzr2, v["rgb2.w"]) * m3
    gr["rgb1.w"], gr["rgb1.b"] = outer(torch.cat([feat, denc], dim=1), dzy), dzy
    dfeat = mvt(dzy, wr1[:, :h])
    dsig = g[:, 3:] * msig
    gr["trunk.w"] = torch.cat([outer(x2, dfeat), (x2 * dsig)[..., None]], dim=2)
    gr["trunk.b"] = torch.cat([dfeat, dsig], dim=1)
    dz2 = (mvt(dfeat, wt[..., :h]) + dsig * wt[:, :, h]) * m2
    gr["l2.w"], gr["l2.b"] = outer(x1, dz2), dz2
    dz1 = mvt(dz2, v["l2.w"]) * m1
    gr["l1.w"], gr["l1.b"] = outer(penc, dz1), dz1
    grad = torch.cat([gr[k].reshape(g.shape[0], -1) for k, _ in layer_shapes(h, 63, 27)],
                     dim=1)
    return grad, pre, torch.cat([s1, s2, ssig, s3], dim=1)


class _KiloExact:
    """The float64 gradient ``g64`` of the float32 KiloNeRF backward's
    inputs (the encodings as the plain version makes them), with every
    point's pre-activations ``pre`` and ``ties``: the (sorted point, unit)
    pairs within ``KILO_TIE_ULPS`` of 0."""

    def __init__(self, wc, disp, cot):
        from nerf_tpu_torch.ops.cuda.fused_kilonerf import unpack
        from nerf_tpu_torch.ops.cuda.fused_render import _encode

        dev = wc.device
        g3 = disp.counts.shape[0]
        self.nid = torch.repeat_interleave(torch.arange(g3, device=dev), disp.counts)
        pay = disp.sorted_pay
        self.penc = _encode(pay[:, :3], 10, 63, torch.sin).double()
        self.denc = _encode(pay[:, 4:7], 4, 27, torch.sin).double()
        self.g = cot[disp.order].double()
        self.w = unpack(wc.double(), 32, 63, 27)
        self.g64 = torch.zeros(g3, wc.shape[1], dtype=torch.float64, device=dev)
        pre, ties = [], []
        for lo in range(0, disp.n, 8192):
            rows = torch.arange(lo, min(lo + 8192, disp.n), device=dev)
            grad, p, scale = self.chain(rows)
            self.g64.index_add_(0, self.nid[rows], grad)
            near = (p.abs() <= KILO_TIE_ULPS * 2.0 ** -24 * scale).nonzero()
            ties.append(torch.stack([rows[near[:, 0]], near[:, 1]], dim=1))
            pre.append(p)
        self.pre, self.ties = torch.cat(pre), torch.cat(ties)

    def chain(self, rows, flip=None):
        v = {k: x[self.nid[rows]] for k, x in self.w.items()}
        return _kilo_chain64(v, self.penc[rows], self.denc[rows], self.g[rows], flip)

    def with_flips(self, pairs):
        """``g64`` with the ReLU masks of the (point, unit) ``pairs``
        inverted, a point's flips applied together."""
        out = self.g64.clone()
        if len(pairs):
            pts, inv = torch.unique(pairs[:, 0], return_inverse=True)
            flip = torch.zeros(pts.shape[0], KILO_UNITS, dtype=torch.bool, device=out.device)
            flip[inv, pairs[:, 1]] = True
            out.index_add_(0, self.nid[pts], self.chain(pts, flip)[0] - self.chain(pts)[0])
        return out

    def fit_flips(self, got):
        """The tie flips that explain ``got``, network by network: each
        tie's flip moves one point's gradient by its unit's whole
        contribution; the flip that lowers the residual's norm most is
        taken while it at least halves it."""
        ties = self.ties
        flip = torch.zeros(ties.shape[0], KILO_UNITS, dtype=torch.bool, device=got.device)
        flip[torch.arange(ties.shape[0], device=got.device), ties[:, 1]] = True
        delta = self.chain(ties[:, 0], flip)[0] - self.chain(ties[:, 0])[0]
        resid = got.double() - self.g64
        net_of = self.nid[ties[:, 0]]
        chosen = []
        for net in torch.unique(net_of).tolist():
            idx = (net_of == net).nonzero()[:, 0]
            r = resid[net]
            while len(idx):
                norms = (r - delta[idx]).norm(dim=1)
                best = int(norms.argmin())
                if float(norms[best]) > 0.5 * float(r.norm()):
                    break
                r = r - delta[idx[best]]
                chosen.append(int(idx[best]))
                idx = torch.cat([idx[:best], idx[best + 1:]])
        return ties[chosen]


@pytest.mark.parametrize("pairing", ["sorted seed 1", "point seed 1", "point seed 2",
                                     "point seed 3"])
def test_kilonerf_bwd_kernel_gap_is_relu_ties(dev, pairing):
    """Row 16 in float32 at the 262,144-point camera set, with random
    cotangents drawn in sorted order (the parent's pairing, as
    test_kilonerf_kernels_match_plain) or in point order under three
    seeds, against the float64 gradient of the same inputs: the plain
    version's ReLU masks differ from float64's only at ties, and with
    those flips applied float64 meets it within KILO_GRAD_TOL; the kernel's
    masks are not visible, so its flips are fitted among the ties
    (``_KiloExact.fit_flips``) and with them float64 meets it within
    KILO_GRAD_TOL too. Prints the counts."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        PLAIN_TILE, KiloNeRFField, _acts, _tiles, cast_packed, dispatch, kilonerf_bwd_plain,
        pack_f32)

    n = 262144
    model = _kilo("float32", 3, dev)
    field = KiloNeRFField(model)
    pts, dirs = _kilo_points("camera", n, dev, seed=n)
    disp = dispatch(model, pts, dirs)
    wc = cast_packed(pack_f32(model), model.cdt)
    how, seed = pairing.split(" seed ")
    cot = torch.randn(n, 4, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(int(seed)))
    if how == "sorted":
        cot = torch.empty_like(cot).index_copy_(0, disp.order, cot)
    with torch.no_grad():
        got = field._backward(wc, disp, cot)
        ref = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4)
        tiles = _tiles(disp, PLAIN_TILE)
        a = _acts(wc, disp, tiles, 32, 10, 4)
        pre32 = torch.cat([a["x1"], a["x2"], a["sigma_pre"][..., None], a["y"]],
                          dim=-1).reshape(-1, KILO_UNITS)[tiles.pos]
        ex = _KiloExact(wc, disp, cot)
        own = ((pre32 > 0) ^ (ex.pre > 0)).nonzero()
        kernel_flips = ex.fit_flips(got)
        explained = {"kernel": ex.with_flips(kernel_flips), "plain": ex.with_flips(own)}
    on_tie = {tuple(p) for p in ex.ties.tolist()}
    own_set = {tuple(p) for p in own.tolist()}
    kernel_set = {tuple(p) for p in kernel_flips.tolist()}
    before = {"kernel": max(_kilo_grad_errors(got.double(), ex.g64).values()),
              "plain": max(_kilo_grad_errors(ref.double(), ex.g64).values()),
              "kernel vs plain": max(_kilo_grad_errors(got, ref).values())}
    after = {k: max(_kilo_grad_errors(x.double(), explained[k]).values())
             for k, x in (("kernel", got), ("plain", ref))}
    print(f"\nrow 16 float32 {n} points, cotangent drawn in {how} order, seed {seed}: "
          f"{len(on_tie)} tie units of {n * KILO_UNITS}; plain masks unlike float64's "
          f"{len(own_set)}, kernel flips fitted {len(kernel_set)}, kernel/plain mask "
          f"differences {len(kernel_set ^ own_set)}; error over max |g| against float64 "
          f"{before}, with the flips {after}")
    assert own_set <= on_tie, "a plain ReLU mask unlike float64's away from a tie"
    assert max(after.values()) <= KILO_GRAD_TOL["float32"], after


@pytest.mark.parametrize("kind,n", [("uniform", 1000), ("uniform", 37), ("voxel", 700),
                                    ("camera", 5003), ("camera", 262144)])
def test_bf16_kilonerf_bwd_tc_matches_plain_recomputes_row_15(dev, kind, n):
    """Row 16 in bfloat16 on the tensor cores (fused_kilonerf_bwd_tc) at
    test_kilonerf_kernels_match_plain's point sets with other points and
    cotangents: the gradient within KILO_GRAD_TOL of the plain version's at
    the kernel's own ReLU masks (its masks unlike the plain version's only
    at bf16 ties, on at most 0.1% of the points; see
    test_kilonerf_kernels_match_plain), networks without points exactly 0,
    two launches bit-identical, the payload and the cotangent read through
    the sort (no sorted copy made), and the (rgb, sigma) it recomputes,
    from its debug output, row 15's output bit for bit."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        KiloNeRFField, cast_packed, dispatch, kilonerf_bwd_plain, pack_f32)

    model = _kilo("bfloat16", 3, dev)
    field = KiloNeRFField(model)
    assert field.bwd_library() == "fused_kilonerf_bwd_tc"
    pts, dirs = _kilo_points(kind, n, dev, seed=n + 1)
    disp = dispatch(model, pts, dirs)
    wc = cast_packed(pack_f32(model), model.cdt)
    cot = torch.randn(n, 4, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    rec = torch.full((n, 4), float("nan"), device=dev)
    masks = torch.empty(n, 4, dtype=torch.int32, device=dev)
    with torch.no_grad():
        out = field._forward(wc, disp)
        grad = field._backward(wc, disp, cot)
        again = field._launch_bwd(wc, disp, cot, rec=rec, masks=masks)
        torch.cuda.synchronize()
        assert "sorted_pay" not in vars(disp)
        ref_g = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4, masks=masks)
        flips, ties = _kilo_bf16_mask_flips(wc, disp, masks)
    assert torch.isfinite(grad).all()
    assert torch.equal(grad, again)
    assert torch.equal(rec, out)
    assert not bool((flips & ~ties).any())
    assert int(flips.any(1).sum()) <= 0.001 * n
    errs = _kilo_grad_errors(grad, ref_g)
    assert max(errs.values()) <= KILO_GRAD_TOL["bfloat16"], errs
    assert bool((grad[disp.counts == 0] == 0).all())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_kilonerf_fwd_kernel_reads_through_the_order_deterministically(dev, cdt):
    """The forward kernel (bfloat16 on the tensor cores, float32 on the CUDA
    cores) reads the payload through the sort and writes point order: two
    launches are bit-identical, and the same points handed over already
    sorted (the sort then the identity) give the same rows bit for bit, as
    each point's products depend on its own row alone."""
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        KiloNeRFField, cast_packed, dispatch, pack_f32)

    model = _kilo(cdt, 4, dev)
    field = KiloNeRFField(model)
    pts, dirs = _kilo_points("camera", 20000, dev, seed=4)
    with torch.no_grad():
        wc = cast_packed(pack_f32(model), model.cdt)
        disp = dispatch(model, pts, dirs)
        out, again = field._forward(wc, disp), field._forward(wc, disp)
        pre = dispatch(model, pts[disp.order], dirs[disp.order])
        assert torch.equal(pre.order, torch.arange(20000, device=dev))
        sorted_out = field._forward(wc, pre)
        torch.cuda.synchronize()
    assert "sorted_pay" not in vars(disp)          # the forward gathered nothing
    assert torch.equal(out, again)
    assert torch.equal(sorted_out, out[disp.order])


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


def _nerf_cotangents_f64(packed, pts, dirs, cot):
    """The point and direction cotangents of nerf_field_bwd_plain with
    its rounding points (every product operand rounded to bf16) but every
    sum in float64: the reference the tensor-core NeRF backward's
    cotangents are held to. Tensor-core sums of bf16 products round
    otherwise than IEEE float32 sums, so near-zero pre-activations take
    other ReLU masks in the kernel than in the float32 plain version, and
    the two then lie about twice as far apart as either lies from this
    reference (the CUDA-core kernel, IEEE float32 sums too, agreed with
    the plain version to 1e-7 at the 99.9th percentile)."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import _encode_bwd
    from nerf_tpu_torch.ops.cuda.fused_render import DP, PP, _encode, fast_sin

    def r(x):
        return x.to(torch.bfloat16).double()

    m = {k: v.double() for k, v in packed.mats.items()}
    v = {k: x.double() for k, x in packed.vecs.items()}
    penc = r(_encode(pts, 10, PP, fast_sin))
    denc = r(_encode(dirs, 4, DP, fast_sin))
    h, x = {}, penc
    for i in range(1, 9):
        z = x @ m["w6h" if i == 6 else f"w{i}"] + v[f"b{i}"]
        x = h[i] = r(torch.relu(z + penc @ m["w6p"] if i == 6 else z))
    h9 = torch.relu(x @ m["w9"] + v["b9"])
    y = r(torch.relu(r(r(h9) @ m["w10f"] + v["b10f"]) @ m["wr0f"] + denc @ m["wr0d"]
                     + v["br0"]))
    rgb = torch.sigmoid(y @ m["wr1"] + v["br1"])[:, :3]
    sigma_pre = h9 @ v["w10s"] + v["b10s"]
    cot = cot.double()
    dsig = torch.where(sigma_pre > 0, cot[:, 3], torch.zeros_like(sigma_pre))[:, None]
    dz = (r(cot[:, :3] * rgb * (1.0 - rgb)) @ m["wr1"][:, :3].T) * (y > 0)
    ddenc = r(dz) @ m["wr0d"].T
    dz = (r(r(dz) @ m["wr0f"].T) @ m["w10f"].T + dsig * v["w10s"]) * (h9 > 0)
    for i in range(9, 1, -1):
        if i == 6:
            dpenc = r(dz) @ m["w6p"].T
        dz = (r(dz) @ m["w6h" if i == 6 else f"w{i}"].T) * (h[i - 1] > 0)
    dpenc = dpenc + r(dz) @ m["w1"].T
    return _encode_bwd(dpenc.float(), pts, 10), _encode_bwd(ddenc.float(), dirs, 4)


@pytest.mark.parametrize("n", [65536, 16384, 1000, 37])
@pytest.mark.parametrize("family", ["nerf", "gabor", "siren"])
def test_bf16_nerf_gabor_field_bwd_tc_matches_plain_and_is_deterministic(dev, family, n):
    """The bfloat16 NeRF, GaborNet and SIREN field backwards on the tensor
    cores (fused_nerf_bwd_tc, fused_gabor_bwd_tc, fused_siren_bwd_tc) at a
    bake's 65,536 points, the distillation batch and two ragged chunks:
    every gradient (weights, the GaborNet's filter banks) within GRAD_TOL
    of its max (floored at 1e-2 of the largest) of the plain version's; the
    point and direction cotangents within chip_smoke.py's FIELD_PT_TOL
    (5e-3 of the max at the 99.9th percentile, at most 0.1% of the points
    beyond it: a point whose ReLU mask flips moves alone) of the plain
    version's (GaborNet and SIREN, whose chains have no ReLU but the
    density's) or of its float64-sum twin (_nerf_cotangents_f64: NeRF); two
    launches give the same bits; and the forward the backward recomputes,
    read from its stash, is the forward kernel's output bit for bit."""
    from nerf_tpu_torch.ops.cuda import fused_gabor, fused_nerf, fused_siren

    if family == "nerf":
        model = NeRFModel(compute_dtype="bfloat16",
                          generator=torch.Generator().manual_seed(3)).to(dev)
        mod, wrapper, sigma_mul = fused_nerf, fused_nerf.NerfField, 1.0
        field = wrapper(model).pack()
        plain = lambda p, d, c: fused_nerf.nerf_field_bwd_plain(  # noqa: E731
            field.packed, p, d, c, 10, 4)
    else:
        mod = fused_gabor if family == "gabor" else fused_siren
        wrapper, _, plain_bwd = _sg_wrapper(family)
        field = wrapper(_sg_model(family, "bfloat16", dev)).pack()
        sigma_mul = field.consts.sigma_mul
        plain = lambda p, d, c: plain_bwd(field.packed, p, d, c, field.consts)  # noqa: E731
    assert field.bwd_library() == f"fused_{family}_bwd_tc"
    pts, dirs = _field_points(n, dev, seed=n + 2)
    cot = torch.randn(n, 4, device=dev, generator=torch.Generator(device=dev).manual_seed(n))
    before = wrapper.bwd_launches
    stash = {}
    with torch.no_grad():
        out = field._forward(field.packed, pts, dirs)
        got = field._backward(field.packed, pts, dirs, cot)
        again = field._backward(field.packed, pts, dirs, cot, stash=stash)
        ref = plain(pts, dirs, cot)
        ref_cot = (_nerf_cotangents_f64(field.packed, pts, dirs, cot) if family == "nerf"
                   else ref[-2:])
    torch.cuda.synchronize()
    assert wrapper.bwd_launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    floor = 1e-2 * max(float(g.abs().max()) for g in ref[:-2])
    for a, b in zip(got[:-2], ref[:-2]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= GRAD_TOL["bfloat16"] * max(
            float(b.abs().max()), floor)
    def pt_err(a, b):
        e = (a - b).abs().max(dim=1).values / b.abs().max()
        return float(torch.quantile(e, 0.999)), int((e > 5e-3).sum())

    for name, a, b, c in zip(("points", "dirs"), got[-2:], ref_cot, ref[-2:]):
        assert bool(torch.isfinite(a).all())
        q, beyond = pt_err(a, b)
        if family == "nerf":
            # with -s: the kernel's and the float32 plain version's distance
            # from the float64-sum reference, and from each other
            print(f"\nnerf {name} cotangent at {n} points, 99.9%% / points beyond 5e-3: "
                  "kernel vs float64 sums %.3e / %d, plain vs float64 sums %.3e / %d, "
                  "kernel vs plain %.3e / %d" % (q, beyond, *pt_err(c, b), *pt_err(a, c)))
        assert q <= 5e-3 and beyond <= 0.001 * n
    run, grid, per_point = stash["run"], stash["grid"], stash["per_point"]
    at = mod.TC_BWD_COLS_AT
    cols = stash["scratch"].view(grid, per_point * run)[:, at * run:(at + 4) * run]
    cols = cols.reshape(grid, 4, run)
    assert torch.equal(torch.clamp_min(cols[:, 0].reshape(-1)[:n], 0.0) * sigma_mul, out[1])
    assert torch.equal(cols[:, 1:4].permute(0, 2, 1).reshape(-1, 3)[:n], out[0])


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
                                      (2, "uniform", 1), (16, "lines", 1000),
                                      (32, "uniform", 70001), (9, "offset", 300)])
@pytest.mark.parametrize("c", [1, 5, 25, 28, 32])
def test_grid_interp_kernel_matches_plain(dev, dtype, r, kind, n, c):
    """Row 17 against its plain version on the card, bit for bit: a thread
    a point does the same float32 operations in the same order (no fused
    multiply-add). Every C the dispatch covers at its ends and in use (25:
    the baked FastNeRF cache, 28: Plenoxels), batches that are no whole
    number of 128-point CTAs, and points that start 12 bytes past a 16-byte
    boundary ("offset": the positions read one float a thread); one
    launch."""
    from nerf_tpu_torch.ops.cuda.fused_grid import (
        GridKernel, cells_of, grid_interp, interp_cells_plain, pack_grid)

    grid = torch.randn(r, r, r, c, device=dev, generator=torch.Generator(device=dev).manual_seed(r))
    src = pack_grid(grid, dtype)
    src = grid if src is None else src
    if kind == "offset":
        pts = _grid_points("uniform", n + 1, dev, seed=n)[1:]
        assert pts.data_ptr() % 16 != 0
    else:
        pts = _grid_points(kind, n, dev, seed=n)
    before = GridKernel.launches
    got = grid_interp(src, pts)
    torch.cuda.synchronize()
    assert GridKernel.launches == before + 1
    ref = interp_cells_plain(src, cells_of(pts, r))
    assert got.shape == (pts.shape[0], c) and torch.isfinite(got).all()
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("case", ["uniform", "runs", "one_id", "channels", "few_rows",
                                  "outside", "long_run", "int64_big"])
def test_scatter_add_kernel_exact_and_deterministic(dev, case):
    """Row 19 against float64 sums: each row within (K + pieces) ulps of its
    sum of magnitudes (the kernel sums pieces of at most K = 256 rows, then
    the pieces in order); against the plain version within the two
    bounds; two runs equal bit for bit; untouched rows exactly zero; one
    launch. ``runs``: 3,000 rows of one id (12 chunks) among uniform ids;
    ``one_id``: every row one id; ``channels``: 1, 5 and 32 channels;
    ``few_rows``: M = 100 < K int32 ids; ``outside``: ids below 0 and past
    num_rows (skipped); ``long_run``: 20,000 rows of one id (79 chunks, a
    run over more than 64 chunks); ``int64_big``: int64 ids >= 2^24 (4
    radix passes)."""
    from nerf_tpu_torch.ops.cuda.scatter_add import (
        ScatterKernel, scatter_add_plain, scatter_add_rows)

    g = torch.Generator(device=dev).manual_seed(3)
    m, rows, lo = 20000, 5000, 0
    if case == "few_rows":
        m = 100
    elif case == "long_run":
        m = 40000
    elif case == "int64_big":
        rows, lo = 2 ** 24 + 3000, 2 ** 24
    for c in ((1, 5, 32) if case == "channels" else (28,)):
        ids = torch.randint(lo, rows, (m,), generator=g, device=dev)
        if case == "runs":
            ids[torch.randperm(m, generator=g, device=dev)[:3000]] = 17
        elif case == "long_run":
            ids[torch.randperm(m, generator=g, device=dev)[:20000]] = 17
        elif case == "one_id":
            ids[:] = 4321
        elif case == "outside":
            ids = torch.randint(-50, rows + 50, (m,), generator=g, device=dev)
        elif case == "few_rows":
            ids = ids.int()
        vals = torch.randn(m, c, generator=g, device=dev)
        before = ScatterKernel.launches
        a = scatter_add_rows(ids, vals, rows)
        b = scatter_add_rows(ids, vals, rows)
        torch.cuda.synchronize()
        assert ScatterKernel.launches == before + 2
        assert torch.equal(a, b)
        kept = (ids >= 0) & (ids < rows)
        ik, vk = ids[kept].long(), vals[kept]
        exact = torch.zeros(rows, c, dtype=torch.float64, device=dev).index_add_(
            0, ik, vk.double())
        mags = torch.zeros(rows, c, dtype=torch.float64, device=dev).index_add_(
            0, ik, vk.abs().double())
        counts = torch.bincount(ik, minlength=rows).double()[:, None]
        ulp = 2.0 ** -24
        assert bool(((a.double() - exact).abs() <= (256 + counts / 256 + 2) * ulp * mags).all())
        plain = scatter_add_plain(ik, vk, rows)
        assert bool(((plain.double() - exact).abs() <= (counts + 2) * ulp * mags).all())
        assert bool((a[counts[:, 0] == 0] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(100, 24), (37, 5), (64, 300), (1, 1)])
def test_grid_render_kernel_matches_plain(dev, dtype, shape):
    """Row 18 against its plain version on the card (a 16^3 x 28 grid over
    the default grid_domain, camera rays towards the origin): rgb, acc and
    weights within 1e-5, depth within 1e-4 (the plain version's cumprod and
    sums run in another order than the kernel's scans; expf and the
    division round alike); one launch; S = 300 spans two 256-sample blocks,
    carrying T from one to the next."""
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedGridRender, _expand_basis, cells_affine, grid_render_plain)
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
        o_aff, d_aff = cells_affine(ro, rd, *fr.affine(16))
        ref = grid_render_plain(src, o_aff, d_aff, t, _expand_basis(sh_basis(rd, 2)), fr.sel)
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert got[k].shape == ref[i].shape and torch.isfinite(got[k]).all()
        torch.testing.assert_close(got[k], ref[i], atol=1e-4 if k == "depth" else 1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_grid_render_kernel_is_deterministic_at_every_sh_degree(dev, dtype, degree):
    """Row 18 at SH degree 0, 1 and 2 (4, 13 and 28 channels: rows read as
    16-, 4- or 2-byte and 16- or 8-byte vectors) against its plain version
    within the same bounds, two launches bit-identical; then a grid of
    empty space (density channel -200: softplus 0 in float32, 1 - alpha
    exactly 1) gives weights, acc, rgb and depth of exactly 0, as the plain
    version does."""
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, sh_basis
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedGridRender, _expand_basis, cells_affine, grid_render_plain)

    model = PlenoxelsModel(grid_res=16, sh_degree=degree, interp_dtype=dtype,
                           domain=(-2.75, -1.25)).to(dev)
    with torch.no_grad():
        model.grid.normal_(0.0, 0.7, generator=torch.Generator(device=dev).manual_seed(6))
    ro, rd, t = _inputs(300, 270, dev, seed=degree)
    rd = torch.nn.functional.normalize(-ro + 0.3 * rd, dim=-1)
    fr = FusedGridRender(model, NEAR, FAR)
    keys = ("rgb", "acc", "depth", "weights")
    with torch.no_grad():
        for empty in (False, True):
            if empty:
                model.grid[..., 0] = -200.0
            pack = fr.pack(model)
            src = model.grid if pack.packed is None else pack.packed
            got, again = fr(pack, ro, rd, rd, t), fr(pack, ro, rd, rd, t)
            o_aff, d_aff = cells_affine(ro, rd, *fr.affine(16))
            ref = grid_render_plain(src, o_aff, d_aff, t,
                                    _expand_basis(sh_basis(rd, degree)), fr.sel)
            torch.cuda.synchronize()
            assert all(torch.equal(got[k], again[k]) for k in keys)
            for i, k in enumerate(keys):
                torch.testing.assert_close(got[k], ref[i], atol=1e-4 if k == "depth" else 1e-5,
                                           rtol=0)
                if empty:
                    assert bool((got[k] == 0).all()) and bool((ref[i] == 0).all()), k


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


def _factor_cache(dev, num_factors=8, r=16, packed=True):
    """A baked FastNeRF cache on the card: a seeded FastNeRF (hidden 32)
    over the default grid_domain baked at r^3 / dir_res 8, with its
    bfloat16 copy or without (the float32 mode)."""
    from nerf_tpu_torch.models.fastnerf import BakedFastNeRF, FastNeRFModel

    model = FastNeRFModel(hidden_dim=32, num_factors=num_factors, domain=(-2.75, -1.25),
                          generator=torch.Generator().manual_seed(num_factors)).to(dev)
    with torch.no_grad():
        cache = model.bake(grid_res=r, dir_res=8)
    if packed:
        return cache
    return BakedFastNeRF(cache.pos_grid, cache.beta_grid, num_factors, domain=cache.domain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1024, 256), (1000, 37)])
def test_factor_render_kernel_matches_plain(dev, dtype, shape):
    """Row 18's factor form (a baked FastNeRF cache of 16^3 x 25, D = 8)
    against its plain version on the card, camera rays towards the origin:
    rgb, acc and weights within 1e-5, depth within 1e-4 (the SH form's
    bounds: the same scans and sums in another order than the plain
    version's); one launch; two launches bit-identical."""
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedFactorRender, _expand_basis, cells_affine, grid_render_plain)

    cache = _factor_cache(dev, packed=dtype == "bfloat16")
    n, s = shape
    ro, rd, t = _inputs(n, s, dev, seed=n + s)
    rd = torch.nn.functional.normalize(-ro + 0.3 * rd, dim=-1)
    fr = FusedFactorRender(cache, NEAR, FAR)
    with torch.no_grad():
        before = FusedFactorRender.launches
        got = fr(cache, ro, rd, rd, t)
        again = fr(cache, ro, rd, rd, t)
        torch.cuda.synchronize()
        assert FusedFactorRender.launches == before + 2
        _, src = fr.grids(cache)
        assert src.dtype == getattr(torch, dtype)
        o_aff, d_aff = cells_affine(ro, rd, *fr.affine(16))
        bexp = _expand_basis(cache.beta(rd), repeat_block=False)
        ref = grid_render_plain(src, o_aff, d_aff, t, bexp, fr.sel, relu_sigma=True)
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert got[k].shape == ref[i].shape and torch.isfinite(got[k]).all()
        assert torch.equal(got[k], again[k]), k
        torch.testing.assert_close(got[k], ref[i], atol=1e-4 if k == "depth" else 1e-5, rtol=0)


def test_factor_render_refuses_unsupported_shapes(dev):
    """The factor form on the card: 11 factors (34 channels) or a grid of
    one cell a side raise NotImplementedError naming row 18 before any
    launch; make_fused_grid_render gives such a cache no render (None)."""
    from nerf_tpu_torch.models.fastnerf import BakedFastNeRF
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedFactorRender, make_fused_grid_render)

    wide = _factor_cache(dev, num_factors=11, r=4, packed=False)
    one = BakedFastNeRF(torch.zeros(1, 1, 1, 25, device=dev), torch.zeros(8, 16, 8, device=dev), 8)
    ro, rd, t = _inputs(4, 8, dev)
    before = FusedFactorRender.launches
    for cache in (wide, one):
        with torch.no_grad(), pytest.raises(NotImplementedError, match="row 18"):
            FusedFactorRender(cache, NEAR, FAR)(cache, ro, rd, rd, t)
    assert FusedFactorRender.launches == before
    assert make_fused_grid_render(wide, NEAR, FAR) is None


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


# ---------------------------------------------------------------- LLFF / NDC and NGP


def _ndc_inputs(num_rays, num_samples, dev, seed=0):
    """fern.txt's kernel inputs: world rays of seeded forward-facing cameras
    (504 x 378 pixels, focal 407.6, centres within 0.3 of the origin looking
    down -z), warped to NDC; their world directions as view directions; t
    stratified in [0, 1], every 4th ray's last sample at exactly 1."""
    from nerf_tpu_torch.ops.ndc import ndc_rays

    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (num_rays, 2)), np.zeros((num_rays, 1))], -1)
    u, v = rng.uniform(0, 504, num_rays), rng.uniform(0, 378, num_rays)
    d = np.stack([u - 252.0, -(v - 189.0), -np.full(num_rays, 407.6)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    ro, rd = ndc_rays(378, 504, 407.6, 1.0, o, d)
    t = (np.arange(num_samples) + rng.uniform(size=(num_rays, num_samples))) / num_samples
    t[::4, -1] = 1.0
    return tuple(x.to(dev) for x in (ro, rd, d, torch.from_numpy(t.astype(np.float32))))


@pytest.mark.parametrize("white_bg", [False, True])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1024, 128), (257, 64)])
def test_ndc_render_and_train_kernels_match_plain(dev, cdt, shape, white_bg):
    """Rows 3 and 5 in fern.txt's mode: normalize off (NDC rays passed
    through), world view directions, t in [0, 1]; the forward render
    within TOL of its plain version (depth 10 x), the train pass's loss,
    rgb and acc within TOL and each gradient within GRAD_TOL of its max,
    with a black or a white background."""
    model = NeRFModel(compute_dtype=cdt, generator=torch.Generator().manual_seed(20)).to(dev)
    fr = FusedNerfRender(model, 0.0, 1.0, normalize=False)
    ro, rd, vd, t = _ndc_inputs(*shape, dev, seed=shape[1])
    tgt = torch.rand(shape[0], 3, generator=torch.Generator().manual_seed(3)).to(dev)
    with torch.no_grad():
        packed = fr.pack(model)
        assert fr.affine(ro, rd) == (ro, rd)
        got = fr(packed, ro, rd, vd, t)
        ref = fused_render_plain(packed, ro, rd, vd, t, 10, 4)
        loss, rgb, acc, _, grads = fr._train(packed, ro, rd, vd, t, tgt, white_bg)
        ref_t = fused_train_plain(packed, ro, rd, vd, t, tgt, white_bg, 10, 4)
        torch.cuda.synchronize()
    tol = TOL[cdt]
    for i, k in enumerate(("rgb", "acc", "depth", "weights")):
        assert torch.isfinite(got[k]).all()
        torch.testing.assert_close(got[k], ref[i], atol=tol * (10 if k == "depth" else 1),
                                   rtol=0)
    torch.testing.assert_close(loss, ref_t[0], rtol=tol, atol=0)
    torch.testing.assert_close(rgb, ref_t[1], atol=tol, rtol=0)
    torch.testing.assert_close(acc, ref_t[2], atol=tol, rtol=0)
    g, r = grad_views(*grads, 256), grad_views(*ref_t[4], 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    for k in r:
        assert torch.isfinite(g[k]).all(), k
        err = float((g[k] - r[k]).abs().max()) / max(float(r[k].abs().max()), floor)
        assert err <= GRAD_TOL[cdt], (k, err)


def test_ngp_hash_rows_on_card_equal_cpu(dev):
    """Every corner row of 65,536 points at all 16 levels (2^19 tables: 5
    direct, 11 hashed) equal on the card and on the CPU, and the encoding
    within 1e-10 (a few ulps of the +-1e-4 features)."""
    from nerf_tpu_torch.models.ngp import NGPModel

    m = NGPModel(domain=(-2.75, -1.25), generator=torch.Generator().manual_seed(0))
    p = torch.rand(65536, 3, generator=torch.Generator().manual_seed(1)) * 1.6 - 2.8
    cpu = torch.stack([r for r, _ in m._cells(p)])
    card = torch.stack([r for r, _ in m._cells(p.to(dev))])
    assert torch.equal(cpu, card.cpu())
    with torch.no_grad():
        enc_cpu = m.encode(p)
        enc_card = m.to(dev).encode(p.to(dev)).cpu()
    torch.testing.assert_close(enc_card, enc_cpu, atol=1e-10, rtol=0)


def _write_scenes(root, kind):
    """A small scene written with the port's PNG writer: ``llff`` (12
    forward-facing 32 x 40 views and poses_bounds.npy) or ``blender`` (one
    24 x 24 frame a split)."""
    import json
    import os

    from nerf_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(4)
    os.makedirs(root, exist_ok=True)
    if kind == "llff":
        os.makedirs(os.path.join(root, "images"))
        rows = []
        for i in range(12):
            img = (rng.uniform(size=(32, 40, 3)) * 64 + 96).astype(np.uint8)
            img[8:24, 12:28] = (200, 60, 40)
            write_png(os.path.join(root, "images", f"img_{i:03d}.png"), img)
            t = np.array([*rng.uniform(-0.4, 0.4, 2), 4.0])
            m = np.stack([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], t], 1)
            rows.append(np.concatenate([np.concatenate([m, [[32], [40], [35.0]]], 1)
                                        .reshape(-1), [2.5, 5.5]]))
        np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
        return root
    for split, theta in (("train", 0.3), ("val", 1.9), ("test", 3.5)):
        os.makedirs(os.path.join(root, split))
        img = np.zeros((24, 24, 4), np.uint8)
        img[6:18, 6:18] = (220, 80, 50, 255)
        write_png(os.path.join(root, split, "r_0.png"), img)
        c, s = np.cos(theta), np.sin(theta)
        c2w = [[c, 0.0, s, 4.0 * s], [0.0, 1.0, 0.0, 0.0], [-s, 0.0, c, 4.0 * c],
               [0.0, 0.0, 0.0, 1.0]]
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": [
                {"file_path": f"./{split}/r_0", "transform_matrix": c2w}]}, f)
    return root


def _losses(log_dir):
    import os

    out = {}
    (run,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, run, "train.log")) as f:
        for line in f:
            if line.startswith("scalar loss "):
                _, _, step, value = line.split()
                out[int(step)] = float(value)
    return out


@pytest.mark.parametrize("config", ["fern.txt", "ngp_synthetic.txt"])
def test_short_fit_resumes_bit_for_bit(dev, config, tmp_path):
    """fern.txt (LLFF, NDC, bf16 kernels; 2 train launches a step) and
    ngp_synthetic.txt (its occupancy prior rebaked at the checkpoint's
    step; one scatter-add launch a step) trained 6 iterations on small
    scenes with a save at 3; the run resumed from it repeats the first
    run's mse at iterations 4 and 5 bit for bit."""
    import dataclasses
    import os

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.ops.cuda.scatter_add import ScatterKernel
    from nerf_tpu_torch.train.loop import fit

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    llff = config == "fern.txt"
    scene = _write_scenes(str(tmp_path / "scene"), "llff" if llff else "blender")
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(repo, "configs", config)), dataset_path=scene,
        num_iters=6, save_interval=3, log_interval=1, val_interval=1000,
        save_path=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"),
        **({"llff_factor": 1} if llff else {"num_random_rays": 256, "num_samples": 16,
                                            "occupancy_interval": 3}))
    before = (FusedNerfRender.train_launches, ScatterKernel.launches)
    fit(cfg, device=dev, log=lambda *a: None)
    launched = (FusedNerfRender.train_launches - before[0], ScatterKernel.launches - before[1])
    assert launched == ((12, 0) if llff else (0, 6))
    first = _losses(cfg.log_dir)
    cfg2 = dataclasses.replace(cfg, log_dir=str(tmp_path / "logs2"),
                               save_path=str(tmp_path / "models2"))
    fit(cfg2, resume_path=os.path.join(cfg.save_path, f"{cfg.model_type}_model_000003"),
        device=dev, log=lambda *a: None)
    again = _losses(cfg2.log_dir)
    assert sorted(first) == list(range(6)) and sorted(again) == [3, 4, 5]
    assert all(np.isfinite(list(first.values())))
    assert again[3] == first[4] and again[4] == first[5]


def test_multiscene_fit_equals_independent_scene_steps(dev, tmp_path):
    """fit_multiscene of lego.txt's model (bf16 train kernel, 64 + 128) over
    two small scenes, 3 iterations: each scene's final state equals three
    steps of its own one-scene step seeded with scene_seed, from the same
    initial state, bit for bit (2 train launches a scene a step)."""
    import dataclasses
    import os

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.parallel.multiscene import scene_seed
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.multiscene_loop import fit_multiscene
    from nerf_tpu_torch.train.step import make_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scenes = [_write_scenes(str(tmp_path / f"scene{i}"), "blender") for i in range(2)]
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(repo, "configs", "lego.txt")), num_iters=3,
        num_random_rays=256, log_interval=1, val_interval=1000, save_interval=1000,
        save_path=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"))
    before = FusedNerfRender.train_launches
    states = fit_multiscene(cfg, scenes, device=dev, log=lambda *a: None)
    assert FusedNerfRender.train_launches - before == 2 * 2 * 3
    for i, (scene, got) in enumerate(zip(scenes, states)):
        pool = load_scene(dataclasses.replace(cfg, dataset_path=scene), device=dev).pool
        cfg_i = dataclasses.replace(cfg, near=2.0, far=6.0)
        st = create_train_state(cfg_i, seed=scene_seed(cfg.seed, i), device=dev)
        step = make_train_step(st.params, render_settings_from_config(cfg_i),
                               cfg.num_random_rays, scene_seed(cfg.seed, i))
        for _ in range(3):
            step(st, pool)
        assert st.step == got.step == 3
        for a, b in zip(list(st.params.parameters()) + list(st.fine_params.parameters())
                        + st.optimizer.mu + st.optimizer.nu,
                        list(got.params.parameters()) + list(got.fine_params.parameters())
                        + got.optimizer.mu + got.optimizer.nu):
            assert torch.equal(a, b)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_nccl_world_one_fit_equals_undistributed(dev, tmp_path):
    """fit with multihost = true in an NCCL group of one rank (every step's
    gradients through one all_reduce) equals the same fit without a group
    bit for bit: the losses and the final parameters."""
    import dataclasses
    import os

    import torch.distributed as dist

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.parallel.multihost import init_distributed
    from nerf_tpu_torch.train.loop import fit

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = _write_scenes(str(tmp_path / "scene"), "blender")
    base = dataclasses.replace(
        parse_config_file(os.path.join(repo, "configs", "lego.txt")), dataset_path=scene,
        num_iters=4, num_random_rays=256, log_interval=1, val_interval=1000,
        save_interval=1000)
    runs = {}
    for name in ("plain", "nccl"):
        cfg = dataclasses.replace(base, multihost=name == "nccl",
                                  save_path=str(tmp_path / name / "models"),
                                  log_dir=str(tmp_path / name / "logs"))
        if name == "nccl":
            init_distributed(f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                             backend="nccl")
        try:
            state = fit(cfg, device=dev, log=lambda *a: None)
            if name == "nccl":
                assert dist.get_backend() == "nccl"
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        runs[name] = (state, _losses(cfg.log_dir))
    (a, la), (b, lb) = runs["plain"], runs["nccl"]
    assert la == lb and sorted(la) == [0, 1, 2, 3]
    for x, y in zip(list(a.params.parameters()) + list(a.fine_params.parameters()),
                    list(b.params.parameters()) + list(b.fine_params.parameters())):
        assert torch.equal(x, y)


def test_interchange_round_trip_of_a_card_state(dev, tmp_path):
    """A lego.txt train state on the card, saved, exported to a reference
    .pth (coarse and fine) and imported back: the models equal the card's
    bit for bit, the step is kept, and the .pth's tensors lie on the CPU."""
    import os

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint, save_train_state
    from nerf_tpu_torch.utils.torch_export import export_torch_checkpoint
    from nerf_tpu_torch.utils.torch_import import import_torch_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = parse_config_file(os.path.join(repo, "configs", "lego.txt"))
    state = create_train_state(cfg, device=dev)
    for p in state.optimizer.mu:
        p.normal_()
    state.step = 11
    ckpt = save_train_state(state, str(tmp_path / "m"), "nerf", 10)
    for fine, model in ((False, state.params), (True, state.fine_params)):
        pth = export_torch_checkpoint(ckpt, cfg, str(tmp_path / f"{fine}.pth"), use_fine=fine)
        sd = torch.load(pth, weights_only=True)
        assert sd["step"] == 11
        assert all(v.device.type == "cpu" for v in sd["model_state_dict"].values())
        back = load_checkpoint(import_torch_checkpoint(pth, cfg, str(tmp_path / f"i{fine}")))
        assert back["train_step"] == 11
        for k, v in model.state_dict().items():
            assert torch.equal(back["params"][k], v.cpu())
            assert torch.equal(back["fine_params"][k], v.cpu())
