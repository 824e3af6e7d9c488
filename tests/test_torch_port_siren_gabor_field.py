"""The plain versions of the port's SIREN and GaborNet field kernels
(``ops/cuda/fused_siren.py``: ``siren_field_plain`` and
``siren_field_bwd_plain`` behind ``SirenField``; ``ops/cuda/fused_gabor.py``:
``gabor_field_plain`` and ``gabor_field_bwd_plain`` behind ``GaborField``)
against nerf_tpu's Pallas kernels (``make_fused_siren_apply``,
``make_fused_gabor_apply``) in interpret mode on the CPU, in both compute
dtypes.

The kernels themselves run only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py); the CPU route of a wrapper is the plain version, which
repeats their arithmetic. Hidden 256 and 8 layers / stages are the shapes
the port's kernels take; 300 points are no tile multiple (tiles of 128).
One interpret-mode run per family and dtype (forward and VJP), in a
module-scoped fixture; the GaborNet's filter-bank gradients reach omega,
phi, mu and gamma through autograd of ``pack_filters``, as nerf_tpu's reach
them through its ``pack_params``. Inputs come from numpy seeds.

Tolerances, from runs at three seeds (3, 5, 9). float32: rgb 1e-5 and sigma
1e-4 (values up to 15; measured 2.4e-7 and 1.1e-5), every gradient (weights,
filter banks, points, directions) 1e-4 of its max (measured 3.5e-6).
bfloat16: both sides round at the same points, but XLA evaluates the
degree-11 sine with other roundings than the port, and a flipped bf16
rounding of an activation is carried on. The SIREN magnifies it (w0 = 30 on
the first layer, sigma_mul = 10): rgb moved by up to 8.8e-4 and sigma by
3.0e-3 of its max, the gradients by 8.5e-3 of their max (the point
cotangent; weights 2.9e-3) and 3.0e-3 in relative Frobenius norm, so rgb
1e-2, sigma 1e-2 of its max, gradients 0.05 of their max and 0.02
Frobenius. The GaborNet's layers are products, not sines of w0 z: rgb 3.2e-5,
sigma 2.1e-5 of its max, gradients 2.3e-3 of their max and 1.3e-3
Frobenius, so 1e-3, 1e-3, 0.02 and 0.01.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.gabor import GaborModel as JaxGabor
from nerf_tpu.models.siren import SirenModel as JaxSiren
from nerf_tpu.ops.pallas.fused_gabor import make_fused_gabor_apply
from nerf_tpu.ops.pallas.fused_siren import make_fused_siren_apply

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.convert import export_jax_grads, load_jax_params
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_gabor import (
    GaborField,
    filter_views,
    gabor_field_bwd_plain,
    gabor_field_plain,
    pack_filters,
)
from nerf_tpu_torch.ops.cuda.fused_siren import (
    SirenField,
    siren_field_bwd_plain,
    siren_field_plain,
)

N = 300
_FAMILIES = {"siren": (JaxSiren, SirenModel, make_fused_siren_apply, SirenField),
             "gabor": (JaxGabor, GaborModel, make_fused_gabor_apply, GaborField)}
# (rgb atol, sigma atol over max |sigma|, gradient atol over max |g|,
#  relative Frobenius)
TOL = {("siren", "float32"): (1e-5, 1e-4 / 15, 1e-4, None),
       ("siren", "bfloat16"): (1e-2, 1e-2, 0.05, 0.02),
       ("gabor", "float32"): (1e-5, 1e-4 / 15, 1e-4, None),
       ("gabor", "bfloat16"): (1e-3, 1e-3, 0.02, 0.01)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=[("siren", "float32"), ("siren", "bfloat16"),
                                        ("gabor", "float32"), ("gabor", "bfloat16")],
                ids=lambda p: "-".join(p))
def case(request):
    """One forward and one VJP of a family's Pallas field kernels
    (interpret mode) and of the port's field on the CPU, same weights,
    points, directions and cotangent, for the loss sum(cot * [rgb,
    sigma])."""
    family, cdt = request.param
    jcls, tcls, make, field = _FAMILIES[family]
    jm = jcls(hidden_dim=256, compute_dtype=cdt)
    params = jm.init(jax.random.key(3))
    tm = tcls(hidden_dim=256, compute_dtype=cdt)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cot = rng.normal(size=(N, 4)).astype(np.float32)
    fused = make(jm, tile_fwd=128, tile_bwd=128, interpret=True)

    def loss(p, x, dd):
        r, s = fused(p, x, dd)
        return jnp.sum(r * cot[:, :3]) + jnp.sum(s * cot[:, 3])

    rgb_j, sig_j = fused(params, jnp.asarray(pts), jnp.asarray(d))
    g_j = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pts), jnp.asarray(d))

    before = (field.launches, field.bwd_launches)
    x, dd = _t(pts).requires_grad_(True), _t(d).requires_grad_(True)
    rgb_t, sig_t = field(tm)(x, dd)
    (torch.sum(rgb_t * _t(cot)[:, :3]) + torch.sum(sig_t * _t(cot)[:, 3])).backward()
    assert (field.launches, field.bwd_launches) == before   # CPU: plain
    return dict(tol=TOL[(family, cdt)],
                jax=(np.asarray(rgb_j), np.asarray(sig_j),
                     jax.tree.map(np.asarray, g_j[0]), np.asarray(g_j[1]),
                     np.asarray(g_j[2])),
                port=(rgb_t.detach().numpy(), sig_t.detach().numpy(),
                      export_jax_grads(tm), x.grad.numpy(), dd.grad.numpy()))


def _assert_grad(a, b, tol, what):
    _, _, rel, fro = tol
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * float(np.abs(b).max()),
                               err_msg=what)
    if fro is not None:
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err < fro, (what, err)


def test_field_forward_matches_pallas_interpret(case):
    rgb, sig = case["port"][:2]
    rgb_j, sig_j = case["jax"][:2]
    tol_rgb, tol_sig = case["tol"][:2]
    assert rgb.shape == (N, 3) and sig.shape == (N,)
    np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=tol_rgb)
    np.testing.assert_allclose(sig, sig_j, rtol=0,
                               atol=tol_sig * float(np.abs(sig_j).max()))


def test_field_weight_gradients_match_pallas_interpret(case):
    """Every weight and bias gradient, and for the GaborNet every filter
    bank's (omega, phi, mu, gamma) after autograd through the packing."""
    got = jax.tree_util.tree_flatten_with_path(case["port"][2])[0]
    ref = jax.tree_util.tree_flatten_with_path(case["jax"][2])[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        _assert_grad(np.asarray(g), np.asarray(r), case["tol"],
                     jax.tree_util.keystr(path))


def test_field_input_gradients_match_pallas_interpret(case):
    """The VJP's point and direction cotangents: SIREN's dz1 w1^T, the
    GaborNet's filter terms, and the direction encoding's backward of dzr0
    wr0d^T with the exact cosine."""
    _assert_grad(case["port"][3], case["jax"][3], case["tol"], "points")
    _assert_grad(case["port"][4], case["jax"][4], case["tol"], "directions")


def _small(family, cdt):
    """A narrow model of the family (the plain versions take any width, the
    GaborNet's any depth)."""
    g = torch.Generator().manual_seed(5)
    if family == "siren":
        return SirenModel(hidden_dim=64, compute_dtype=cdt, generator=g)
    return GaborModel(hidden_dim=64, num_layers=3, compute_dtype=cdt, generator=g)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["siren", "gabor"])
def test_plain_versions_agree_with_the_wrapper(family, cdt):
    """The wrapper's CPU route is the plain versions: a field over a leading
    shape (20, 3) that it flattens, under autograd, gives exactly the
    outputs of the forward's plain version and the point, direction and
    packed-weight gradients of the backward's (60 points)."""
    tm = _small(family, cdt)
    field = _FAMILIES[family][3]
    rng = np.random.default_rng(6)
    pts = _t(rng.uniform(-1.2, 1.2, (60, 3)).astype(np.float32))
    d = _t(rng.normal(size=(60, 3)).astype(np.float32))
    cot = _t(rng.normal(size=(60, 4)).astype(np.float32))
    x = pts.reshape(20, 3, 3).clone().requires_grad_(True)
    dd = d.reshape(20, 3, 3).clone().requires_grad_(True)
    rgb2, sig2 = field(tm)(x, dd)
    assert rgb2.shape == (20, 3, 3) and sig2.shape == (20, 3)
    (torch.sum(rgb2.reshape(60, 3) * cot[:, :3])
     + torch.sum(sig2.reshape(60) * cot[:, 3])).backward()
    packed = field(tm).pack().packed
    k = field(tm).consts
    with torch.no_grad():
        if family == "siren":
            rgb, sig = siren_field_plain(packed, pts, d, k)
            *grads, dpts, ddirs = siren_field_bwd_plain(packed, pts, d, cot, k)
        else:
            rgb, sig = gabor_field_plain(packed, pts, d, k)
            *grads, dpts, ddirs = gabor_field_bwd_plain(packed, pts, d, cot, k)
    assert torch.equal(rgb2.detach().reshape(60, 3), rgb)
    assert torch.equal(sig2.detach().reshape(60), sig)
    assert torch.equal(x.grad.reshape(60, 3), dpts)
    assert torch.equal(dd.grad.reshape(60, 3), ddirs)
    first = tm.base[0] if family == "siren" else tm.linears[0]
    assert torch.equal(first.bias.grad, grads[1][:64])
    if family == "gabor":
        assert torch.equal(tm.filters[0].phi.grad, grads[2][3 * 64:4 * 64])


def test_pack_filters_layout_and_its_gradient_reaches_mu():
    """The banks stage by stage: omega (3 rows), phi, mu^T (3 rows), |mu|^2
    and gamma; a cotangent on |mu|^2 reaches mu as 2 mu through autograd."""
    tm = _small("gabor", "float32")
    fpack = pack_filters(tm)
    assert fpack.shape == (3 * 9 * 64,) and fpack.dtype == torch.float32
    views = filter_views(fpack, 3)
    f = tm.filters[2]
    assert torch.equal(views[2]["om"], f.omega)
    assert torch.equal(views[2]["ph"], f.phi)
    assert torch.equal(views[2]["muT"], f.mu.T)
    assert torch.allclose(views[2]["m2"], torch.sum(f.mu ** 2, dim=-1))
    assert torch.equal(views[2]["gam"], f.gamma)
    views[2]["m2"].sum().backward()
    assert torch.allclose(f.mu.grad, 2.0 * f.mu)
    assert tm.filters[0].mu.grad is None or not tm.filters[0].mu.grad.any()


@pytest.mark.parametrize("family", ["siren", "gabor"])
def test_packed_field_gives_points_their_gradient(family):
    """A packed field (fixed weights, as an occupancy bake or a teacher)
    still differentiates in the points and directions, and leaves the
    model's parameters without a gradient."""
    tm = _small(family, "float32")
    rng = np.random.default_rng(4)
    x = _t(rng.uniform(-1, 1, (40, 3)).astype(np.float32)).requires_grad_(True)
    d = _t(rng.normal(size=(40, 3)).astype(np.float32))
    rgb, sig = _FAMILIES[family][3](tm).pack()(x, d)
    (rgb.sum() + sig.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is None for p in tm.parameters())
