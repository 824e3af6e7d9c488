"""The plain versions of the port's KiloNeRF field kernels
(``ops/cuda/fused_kilonerf.py``: ``kilonerf_fwd_plain``,
``kilonerf_bwd_plain`` behind ``KiloNeRFField``) against nerf_tpu's Pallas
kernels (``make_fused_kilonerf_apply``) in interpret mode on the CPU, at
one expert per step and at the default (128 // hidden experts per step),
in both compute dtypes; and the dispatch glue.

The kernels themselves run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py); the CPU route of the wrapper is the plain version, which
repeats their arithmetic. Inputs come from numpy seeds. The tolerances are
the JAX tests' own where they have one (tests/test_fused_kilonerf.py: rgb
1e-5, sigma 1e-4); gradients are held to a share of each tensor's max.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.kilonerf import KiloNeRFModel as JaxKilo
from nerf_tpu.ops.pallas.fused_kilonerf import make_fused_kilonerf_apply

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
    BWD_RUN,
    FWD_RUN,
    KiloNeRFField,
    cast_packed,
    dispatch,
    kilonerf_bwd_plain,
    kilonerf_fwd_plain,
    pack_f32,
    packed_size,
    run_end,
    unpack,
)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cdt, grid=3, hidden=16, lp=4, ld=2, seed=0):
    kw = dict(grid_res=grid, hidden_dim=hidden, pos_encoding_dim=lp,
              dir_encoding_dim=ld, compute_dtype=cdt)
    jm = JaxKilo(**kw)
    params = jm.init(jax.random.key(seed))
    tm = KiloNeRFModel(**kw)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _data(n, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return pts, d, rng


# shapes: (grid, hidden, L_pos, L_dir); 128 // 16 = 8 experts per step at
# hidden 16 on a 4^3 grid, 4 at hidden 32 on the 8^3 grid
_CASES = [(3, 16, 4, 2), (4, 16, 4, 2), (8, 32, 10, 4)]


@pytest.mark.parametrize("experts", [1, None])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CASES)
def test_forward_matches_pallas(case, cdt, experts):
    """150 points uniform over [-1, 1]^3 (every voxel of the small grids
    touched, a few hundred networks of the 8^3 one): rgb within 1e-5 and
    sigma within 1e-4, the JAX tests' tolerances (measured 6e-8 on both in
    float32). bfloat16: the Pallas kernel selects rgb by a hi/lo bf16 dot,
    ~2^-16 from the float32 sigmoid the port keeps (measured 3.8e-6 on rgb,
    6e-8 on sigma, at both expert counts). (27 networks are no multiple of 8, so the default takes one expert per
    step there, as ``make_fused_kilonerf_apply`` does.)"""
    grid, hidden, lp, ld = case
    jm, params, tm = _pair(cdt, grid, hidden, lp, ld, seed=grid)
    pts, d, _ = _data(150, grid)
    fused = make_fused_kilonerf_apply(jm, tile_fwd=16, tile_bwd=16, interpret=True,
                                      experts_per_step=experts)
    rgb_j, sig_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    before = KiloNeRFField.launches
    with torch.no_grad():
        rgb_t, sig_t = KiloNeRFField(tm)(_t(pts), _t(d))
    assert KiloNeRFField.launches == before                  # CPU: plain
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=1e-4)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_forward_skewed_matches_pallas(cdt):
    """Every point in one voxel: one network's segment holds them all (the
    forward's runs and the plain version's tiles of one network)."""
    jm, params, tm = _pair(cdt, seed=1)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.99, -0.68, (200, 3)).astype(np.float32)
    _, d, _ = _data(200, 1)
    vid, _ = tm.voxel_of(_t(pts))
    assert bool((vid == vid[0]).all())
    fused = make_fused_kilonerf_apply(jm, tile_fwd=8, tile_bwd=8, interpret=True)
    rgb_j, sig_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    with torch.no_grad():
        rgb_t, sig_t = KiloNeRFField(tm)(_t(pts), _t(d))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=1e-4)


# gradients: atol = tol * max|g| per tensor. float32: sums over the same
# points in another order (measured 2.9e-7 of the max). bfloat16: every
# matrix gradient is a product of bf16-rounded activations and cotangents
# on both sides, and XLA's and torch's sines differ by an ulp, which flips
# a rounding now and then (measured 1.6e-4 of the max; 8.1e-4 at grid 3,
# hidden 16 and another seed): 1e-6 / 5e-3.
_GTOL = {"float32": 1e-6, "bfloat16": 5e-3}


@pytest.mark.parametrize("experts", [1, None])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CASES[1:])
def test_gradients_match_pallas_with_exact_zeros(case, cdt, experts):
    """dL/dparams of mean((rgb - target)^2) + 1e-3 mean(sigma) through the
    port's field (the backward's plain version, behind autograd) and through
    the Pallas kernels' VJP, 120 points in a corner of the cube so that
    many networks get none: those networks' gradients are exactly 0 on
    both sides, every other tensor within _GTOL of its max."""
    grid, hidden, lp, ld = case
    jm, params, tm = _pair(cdt, grid, hidden, lp, ld, seed=10 + grid)
    pts, d, rng = _data(120, 10 + grid, -1.0, 0.1)
    tgt = rng.uniform(size=(120, 3)).astype(np.float32)
    fused = make_fused_kilonerf_apply(jm, tile_fwd=16, tile_bwd=16, interpret=True,
                                      experts_per_step=experts)

    def loss(pr):
        rgb, sigma = fused(pr, jnp.asarray(pts), jnp.asarray(d))
        return jnp.mean((rgb - jnp.asarray(tgt)) ** 2) + 1e-3 * jnp.mean(sigma)

    g_j = jax.grad(loss)(params)
    rgb, sigma = KiloNeRFField(tm)(_t(pts), _t(d))
    (torch.mean((rgb - _t(tgt)) ** 2) + 1e-3 * torch.mean(sigma)).backward()
    g_t = export_jax_grads(tm)
    vid, _ = tm.voxel_of(_t(pts))
    touched = np.zeros(tm.num_networks, bool)
    touched[vid.numpy()] = True
    assert 0 < touched.sum() < tm.num_networks
    for name in g_t:
        for leaf in ("w", "b"):
            a, b = g_t[name][leaf], np.asarray(g_j[name][leaf])
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=_GTOL[cdt] * np.abs(b).max(),
                                       err_msg=f"{name}.{leaf}")
            assert np.all(a[~touched] == 0.0) and np.all(b[~touched] == 0.0)
            assert np.any(a[touched] != 0.0)


def test_backward_plain_matches_autograd_of_forward_plain():
    """The backward's plain version against torch autograd through the
    forward's plain version, float32 (in bfloat16 the backward rounds each
    cotangent before its product, which autograd of the forward does not
    do; the Pallas comparisons above cover that dtype): the same function,
    to 1e-5 of each tensor's max."""
    cdt = "float32"
    _, _, tm = _pair(cdt, 4, 16, 4, 2, seed=7)
    pts, d, rng = _data(200, 7)
    field = KiloNeRFField(tm)
    disp = dispatch(tm, _t(pts), _t(d))
    wc = cast_packed(pack_f32(tm), tm.cdt)
    cot = _t(rng.normal(size=(200, 4)).astype(np.float32))
    got = kilonerf_bwd_plain(wc, disp, cot, 16, 4, 2)
    w = wc.float().clone().requires_grad_(True)
    out = kilonerf_fwd_plain(w, disp, 16, 4, 2)
    (ref,) = torch.autograd.grad(torch.sum(out * cot), w)
    for name, a in unpack(got, 16, 27, 15).items():
        b = unpack(ref, 16, 27, 15)[name]
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()),
                                   msg=name)
    assert field.supported() is False           # hidden 16: the card raises


def test_dispatch_glue():
    """One stable sort by network id (ties in point order), the int32
    segment offsets, the payload in point order (the forward kernels read it
    through the sort), its sorted copy made only when first asked for (the
    backward's), and the runs the kernels' CTAs take (128-point forward
    runs, 512-point backward pieces)."""
    tm = KiloNeRFModel(grid_res=2, hidden_dim=8, pos_encoding_dim=1, dir_encoding_dim=1)
    pts, d, _ = _data(700, 3)
    pts[:600] = np.clip(pts[:600], -0.9, -0.1)          # 600 points in network 0
    disp = dispatch(tm, _t(pts), _t(d))
    vid, local = tm.voxel_of(_t(pts))
    assert torch.equal(vid[disp.order], torch.sort(vid).values)
    for g in range(8):
        idx = disp.order[disp.offsets[g]:disp.offsets[g + 1]]
        assert bool((idx[1:] > idx[:-1]).all()) and bool((vid[idx] == g).all())
    assert torch.equal(torch.sort(disp.order).values, torch.arange(700))
    assert disp.offsets.dtype == torch.int32 and int(disp.offsets[-1]) == 700
    assert torch.equal(disp.pay[:, :3], local)
    assert torch.equal(disp.pay[:, 4:7], _t(d))
    assert bool((disp.pay[:, 3] == 0).all() and (disp.pay[:, 7] == 0).all())
    assert "sorted_pay" not in vars(disp)
    assert torch.equal(disp.sorted_pay, disp.pay[disp.order])
    assert disp.sorted_pay is disp.sorted_pay and disp.sorted_pay.is_contiguous()
    counts = disp.counts
    assert int(counts[0]) >= 600
    want_f = np.cumsum([-(-int(c) // FWD_RUN) for c in counts])
    want_b = np.cumsum([-(-int(c) // BWD_RUN) for c in counts])
    np.testing.assert_array_equal(run_end(counts, FWD_RUN).numpy(), want_f)
    np.testing.assert_array_equal(run_end(counts, BWD_RUN).numpy(), want_b)
    assert run_end(counts, FWD_RUN).dtype == torch.int32


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_point_order_forward_matches_pallas(cdt):
    """The forward's plain version as the kernels now give it, in point
    order from the unsorted payload, on 160 shuffled points of which 100 lie
    in one voxel (a long segment among short ones): rgb within 1e-5 and sigma
    within 1e-4 of nerf_tpu's Pallas kernels in interpret mode, point by
    point; the same points handed over already sorted give the same rows,
    bit for bit, in sorted order."""
    jm, params, tm = _pair(cdt, seed=4)
    pts, d, rng = _data(160, 4)
    pts[:100] = rng.uniform(-0.99, -0.7, (100, 3)).astype(np.float32)
    perm = rng.permutation(160)
    pts, d = pts[perm], d[perm]
    fused = make_fused_kilonerf_apply(jm, tile_fwd=16, tile_bwd=16, interpret=True)
    rgb_j, sig_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    disp = dispatch(tm, _t(pts), _t(d))
    wc = cast_packed(pack_f32(tm), tm.cdt)
    with torch.no_grad():
        out = kilonerf_fwd_plain(wc, disp, 16, 4, 2)
    assert out.shape == (160, 4)
    assert not torch.equal(disp.order, torch.arange(160))
    np.testing.assert_allclose(out[:, :3].numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(out[:, 3].numpy(), np.asarray(sig_j), atol=1e-4)
    order = disp.order.numpy()
    pre = dispatch(tm, _t(pts[order]), _t(d[order]))     # already sorted
    assert torch.equal(pre.order, torch.arange(160))
    with torch.no_grad():
        assert torch.equal(kilonerf_fwd_plain(wc, pre, 16, 4, 2), out[disp.order])


def test_packing_layout_and_sizes():
    """The packed block is every parameter of each network in the kernels'
    order; R = 6,212 floats at hidden 32, L = 10/4; bf16 rounds the whole
    block, biases included."""
    tm = KiloNeRFModel(grid_res=2, compute_dtype="bfloat16")
    assert packed_size(32, 10, 4) == 6212
    wp = pack_f32(tm)
    assert tuple(wp.shape) == (8, 6212)
    views = unpack(wp, 32, 63, 27)
    for name in ("l1", "l2", "trunk", "rgb1", "rgb2"):
        assert torch.equal(views[f"{name}.w"], tm.layer(name).w)
        assert torch.equal(views[f"{name}.b"], tm.layer(name).b)
    wc = cast_packed(wp, tm.cdt)
    assert wc.dtype == torch.bfloat16
    assert torch.equal(unpack(wc.float(), 32, 63, 27)["trunk.b"],
                       tm.trunk.b.detach().bfloat16().float())


def test_empty_and_single_point_batches():
    """No points: empty outputs, zero gradients. One point: one network."""
    _, _, tm = _pair("float32")
    field = KiloNeRFField(tm)
    rgb, sigma = field(torch.zeros(0, 3), torch.zeros(0, 3))
    assert rgb.shape == (0, 3) and sigma.shape == (0,)
    (torch.sum(rgb) + torch.sum(sigma)).backward()
    assert all(float(p.grad.abs().max()) == 0.0 for p in tm.parameters())
    rgb, sigma = field(torch.full((1, 3), 0.5), torch.tensor([[0.0, 0.0, 1.0]]))
    rgb_p, sigma_p = tm.apply_pointwise(torch.full((1, 3), 0.5),
                                        torch.tensor([[0.0, 0.0, 1.0]]))
    torch.testing.assert_close(rgb, rgb_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(sigma, sigma_p, atol=1e-6, rtol=0)
