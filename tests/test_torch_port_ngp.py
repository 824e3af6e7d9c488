"""The Instant NGP slice of nerf_tpu_torch against nerf_tpu on the CPU:
``level_resolutions``, the hash encoding (every corner's table row, the
encoding), the field in float32 and bfloat16, the table and MLP gradients
against ``jax.grad``, the weight maps of ``models/convert.py``, and
``fit`` on configs/ngp_synthetic.txt with its occupancy prior, then a
service of the checkpoint.

Inputs come from numpy seeds and go through both packages; each test
states its tolerance.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.common import remap_domain as jax_remap_domain
from nerf_tpu.models.ngp import NGPModel as JaxNGP
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import parse_config_file
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_grads,
    export_jax_params,
    load_jax_params,
)
from nerf_tpu_torch.models.ngp import NGPModel
from nerf_tpu_torch.models.registry import create_model
from nerf_tpu_torch.serve import RenderService
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.step import _kernel_route, fused_field_for, train_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = (-2.75, -1.25)     # grid_domain of the default config
QUIET = dict(log=lambda *a: None)


def _pair(cdt="float32", seed=0, **kw):
    """A JAX NGP (its init from ``seed``) and a port model holding the same
    tables and weights."""
    jm = JaxNGP(compute_dtype=cdt, domain=DOMAIN, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tm = NGPModel(compute_dtype=cdt, domain=DOMAIN, **kw)
    load_jax_params(tm, params)
    return jm, params, tm


def _points(rng, n):
    """Points over the domain cube and a little beyond it (clamped)."""
    lo, hi = DOMAIN
    return rng.uniform(lo - 0.05, hi + 0.05, (n, 3)).astype(np.float32)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(num_levels=1), dict(num_levels=5, base_res=4,
                                                              max_res=300)])
def test_level_resolutions_match_nerf_tpu(kw):
    got = NGPModel(log2_table=4, **kw).level_resolutions()
    want = JaxNGP(**kw).level_resolutions()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("log2_table", [12, 19])
def test_hash_rows_and_encoding_match_nerf_tpu(log2_table):
    """Every corner's table row at every level equal to nerf_tpu's
    ``_corner_index`` (at 2^12 rows every level hashes; at 2^19 the five
    levels up to resolution 58 index directly and the other eleven hash,
    their products wrapping past 2^32), and the encoding of 2,000 points
    within 1e-10 of nerf_tpu's: a few float32 ulps of features of +-1e-4
    (the corner weights' products in another order; measured 2.2e-11)."""
    jm, params, tm = _pair(log2_table=log2_table)
    p = _points(np.random.default_rng(log2_table), 2000)
    x01 = jnp.clip((jax_remap_domain(jnp.asarray(p), DOMAIN) + 1.0) * 0.5, 0.0, 1.0)
    offs = jnp.asarray(np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                                -1).reshape(8, 3), jnp.uint32)
    cells = tm._cells(torch.from_numpy(p))
    hashed = 0
    for (rows, f), res in zip(cells, jm.level_resolutions()):
        res = int(res)
        x = x01 * res
        x0 = jnp.minimum(jnp.floor(x), res - 1)
        want = jm._corner_index(x0.astype(jnp.uint32)[:, None, :] + offs[None], res)
        assert rows.dtype == torch.int64
        assert np.array_equal(rows.numpy(), np.asarray(want).astype(np.int64)), res
        np.testing.assert_array_equal(f.numpy(), np.asarray(x - x0))
        hashed += (res + 1) ** 3 > (1 << log2_table)
    assert hashed == (16 if log2_table == 12 else 11)
    got = tm.encode(torch.from_numpy(p)).detach().numpy()
    want = np.asarray(jm.encode(params["tables"], jnp.asarray(p)))
    assert got.shape == want.shape == (2000, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# float32: the same products summed in another order (1e-5 relative on
# sigma, which exp makes large); bfloat16: a float32 sum that differs in
# its last bit can round an activation to the other bf16 neighbour (2^-8
# relative), as the other families' tests state (their _TOL). Measured
# 6.0e-8 on rgb and 6.8e-8 relative on sigma in both dtypes.
_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5e-3, 2e-2)}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_forward_matches_nerf_tpu(cdt):
    """rgb and sigma of 500 points with unit directions against nerf_tpu's
    apply with the same tables and weights (2^12-row tables): rgb within
    _TOL[cdt][0] absolute, sigma within _TOL[cdt][1] relative."""
    jm, params, tm = _pair(cdt, seed=1, log2_table=12)
    rng = np.random.default_rng(2)
    p, d = _points(rng, 500), _unit(rng, 500)
    rj, sj = jm.apply(params, jnp.asarray(p), jnp.asarray(d))
    with torch.no_grad():
        rt, st = tm(torch.from_numpy(p).reshape(50, 10, 3),
                    torch.from_numpy(d).reshape(50, 10, 3))
    assert rt.shape == (50, 10, 3) and st.shape == (50, 10)
    np.testing.assert_allclose(rt.reshape(-1, 3).numpy(), np.asarray(rj), rtol=0,
                               atol=_TOL[cdt][0])
    np.testing.assert_allclose(st.reshape(-1).numpy(), np.asarray(sj), rtol=_TOL[cdt][1])


def test_gradients_match_jax_grad():
    """The table gradients (touched rows only: the others are zero in both)
    and the MLP gradients of sum(c_rgb * rgb) + sum(c_sigma * sigma) over
    500 points against jax.grad, float32: within 1e-5 of each tensor's
    largest magnitude (the scatter-add sums a row's corner terms in sorted
    order, XLA in its own)."""
    jm, params, tm = _pair(seed=3, log2_table=12)
    rng = np.random.default_rng(4)
    p, d = _points(rng, 500), _unit(rng, 500)
    c_rgb = rng.normal(size=(500, 3)).astype(np.float32)
    c_sig = rng.normal(size=(500,)).astype(np.float32) * 0.1

    def loss(params):
        rgb, sigma = jm.apply(params, jnp.asarray(p), jnp.asarray(d))
        return jnp.sum(rgb * c_rgb) + jnp.sum(sigma * c_sig)

    want = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
    rgb, sigma = tm(torch.from_numpy(p), torch.from_numpy(d))
    (torch.sum(rgb * torch.from_numpy(c_rgb)) + torch.sum(sigma * torch.from_numpy(c_sig))
     ).backward()
    got = export_jax_grads(tm)
    touched = 0
    for g, w in zip(got["tables"], want["tables"]):
        rows = np.flatnonzero(np.abs(w).sum(-1) + np.abs(g).sum(-1))
        touched += len(rows)
        np.testing.assert_allclose(g[rows], w[rows], rtol=0, atol=1e-5 * np.abs(w).max())
        assert not np.any(np.delete(g, rows, axis=0))
    assert touched > 16 * 500
    for name in ("density", "color"):
        for lg, lw in zip(got[name], want[name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(lg[k], lw[k], rtol=0,
                                           atol=1e-5 * np.abs(lw[k]).max())


def test_weight_maps_and_routes():
    """export_jax_params inverts load_jax_params; the Adam-moment order of a
    tree is the module's parameter order; the registry builds ngp with
    nerf_tpu's knobs (hidden_dim from the config, as nerf_tpu's create_model
    passes it) and the density guard; the route is the module's."""
    jm, params, tm = _pair(seed=5, log2_table=10)
    back = export_jax_params(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)
    order = _flat_in_param_order(params)
    assert [x.shape for x in order] == [tuple(q.shape) for q in tm.parameters()]
    m = create_model("ngp", generator=torch.Generator().manual_seed(0), hidden_dim=32,
                     pos_encoding_dim=10, domain=DOMAIN)
    assert isinstance(m, NGPModel) and m.hidden_dim == 32 and m.domain == DOMAIN
    assert len(m.tables) == 16 and m.tables[0].shape == (1 << 19, 2)
    assert float(m.tables[3].abs().max()) <= 1e-4 and float(m.density[1].bias[0]) == 0.5
    from nerf_tpu_torch.render.renderer import RenderSettings

    assert _kernel_route(m, RenderSettings(), True)[1] is fused_field_for
    assert fused_field_for(m) is m and train_field(m, RenderSettings(), True) is m


def test_fit_ngp_synthetic_with_occupancy_then_serve(tmp_path):
    """configs/ngp_synthetic.txt on a 24 x 24 synthetic Blender scene (256
    rays, 16 samples a step; its occupancy_res 32 kept, the prior baked
    through the module before the first step and rebaked after the second):
    two finite steps, an NGP checkpoint, and a service of it rendering a
    finite image."""
    root = make_synthetic_blender_scene(str(tmp_path / "scene"), h=24, w=24, num_train=2,
                                        num_val=1, num_test=1)
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(REPO, "configs", "ngp_synthetic.txt")),
        dataset_path=root, num_iters=2, num_random_rays=256, num_samples=16,
        occupancy_interval=2, log_interval=1, val_interval=1000, chunk_size=4096,
        save_path=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"))
    assert (cfg.model_type, cfg.occupancy_res, cfg.learning_rate) == ("ngp", 32, 0.01)
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    assert isinstance(state.params, NGPModel) and state.step == 2
    assert state.params.hidden_dim == cfg.hidden_dim
    mses = [float(line.split("MSE: ")[1].split()[0]) for line in lines if "MSE:" in line]
    assert len(mses) == 2 and np.isfinite(mses).all()
    ckpt = os.path.join(cfg.save_path, "ngp_model_000002")
    svc = RenderService.from_checkpoint(cfg, ckpt, device="cpu", **QUIET)
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
