"""nerf_tpu_torch against nerf_tpu: config, encoding, the NeRF model and the
weight converter. Inputs come from numpy seeds and go through both
packages; the JAX side runs on the CPU as the JAX package's tests run it."""

from __future__ import annotations

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import parse_config_file as jax_parse_config_file
from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.models.encoding import positional_encoding as jax_pe
from nerf_tpu.utils.torch_export import nerf_state_dict_entries

from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.models.common import linear, linear_init
from nerf_tpu_torch.models.convert import export_jax_params, load_jax_params
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.registry import create_model, model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.txt")))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_parse_equal(path):
    import dataclasses

    mine = dataclasses.asdict(parse_config_file(path))
    ref = dataclasses.asdict(jax_parse_config_file(path))
    assert mine == ref


def test_config_fields_match_reference():
    import dataclasses

    from nerf_tpu.config import Config as JaxConfig

    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding_matches(num_freqs):
    x = np.random.default_rng(0).uniform(-2, 2, (5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_pe(jnp.asarray(x), num_freqs))
    got = positional_encoding(torch.from_numpy(x), num_freqs).numpy()
    assert got.shape == ref.shape == (5, 7, encoded_dim(3, num_freqs))
    # identical formula; sin/cos of arguments up to 2^9*2 differ by ~1 ulp
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _model_pair(hidden, cdt, seed=0):
    jm = JaxNeRF(hidden_dim=hidden, compute_dtype=cdt)
    params = jm.init(jax.random.key(seed))
    tm = NeRFModel(hidden_dim=hidden, compute_dtype=cdt)
    load_jax_params(tm, _np_tree(params))
    return jm, params, tm


# float32: the same products summed in another order (2e-5 on rgb in [0,1],
# as the JAX package's own torch parity test allows; sigma grows to ~10 so
# 2e-4). bfloat16: inputs round identically, but a float32 sum that differs
# in its last bit can land on the other side of a bf16 rounding boundary and
# move one activation by 2^-8 relative, so 5e-4 / 5e-3 (measured 2e-5 /
# 8e-6 at hidden 256).
_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (5e-4, 5e-3)}


@pytest.mark.parametrize("hidden", [32, 256])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_nerf_forward_matches_jax(hidden, cdt):
    jm, params, tm = _model_pair(hidden, cdt)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (96, 3)).astype(np.float32)
    dirs = rng.normal(size=(96, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb_j, sig_j = jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    with torch.no_grad():
        rgb_t, sig_t = tm(torch.from_numpy(pts), torch.from_numpy(dirs))
    tol_rgb, tol_sigma = _TOL[cdt]
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=tol_rgb)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=tol_sigma)


def test_export_round_trips():
    _, params, tm = _model_pair(32, "float32", seed=3)
    back = export_jax_params(tm)
    ref = _np_tree(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    tm2 = NeRFModel(hidden_dim=32, generator=torch.Generator().manual_seed(9))
    load_jax_params(tm2, back)
    for (k, v), (k2, v2) in zip(tm.state_dict().items(), tm2.state_dict().items()):
        assert k == k2
        assert torch.equal(v, v2)


def test_load_rejects_wrong_width():
    _, params, _ = _model_pair(32, "float32")
    with pytest.raises(ValueError):
        load_jax_params(NeRFModel(hidden_dim=64), _np_tree(params))


def test_state_dict_layout_is_the_reference_layout():
    _, params, tm = _model_pair(32, "float32")
    want = {f"{prefix}.{p}" for prefix, _ in nerf_state_dict_entries(params)
            for p in ("weight", "bias")}
    assert set(tm.state_dict()) == want
    # torch (out, in) against the pytree's (in, out)
    for prefix, lyr in nerf_state_dict_entries(_np_tree(params)):
        np.testing.assert_array_equal(
            tm.state_dict()[f"{prefix}.weight"].numpy(), lyr["w"].T)


def test_init_is_seeded_and_keeps_density_bias():
    a = NeRFModel(hidden_dim=32, generator=torch.Generator().manual_seed(5))
    b = NeRFModel(hidden_dim=32, generator=torch.Generator().manual_seed(5))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert float(a.block2[8].bias.detach()[-1]) == 0.5
    ref = NeRFModel(hidden_dim=32, reference_init=True,
                    generator=torch.Generator().manual_seed(5))
    assert float(ref.block2[8].bias.detach()[-1]) != 0.5
    bound = 1.0 / np.sqrt(a.pos_in)
    assert float(a.block1[0].weight.detach().abs().max()) <= bound


def test_linear_init_law_and_compute_dtype():
    lyr = linear_init(64, 16, torch.Generator().manual_seed(0))
    assert lyr.weight.shape == (16, 64)
    assert float(lyr.weight.detach().abs().max()) <= 1 / 8
    assert float(lyr.bias.detach().abs().max()) <= 1 / 8
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    y32 = linear(lyr, x, torch.float32)
    torch.testing.assert_close(y32, x @ lyr.weight.T + lyr.bias)
    ybf = linear(lyr, x, torch.bfloat16)
    want = (x.bfloat16().float() @ lyr.weight.bfloat16().float().T) + lyr.bias
    torch.testing.assert_close(ybf, want)
    assert ybf.dtype == torch.float32


def test_model_from_config():
    cfg = Config(hidden_dim=32, pos_encoding_dim=4, dir_encoding_dim=2,
                 compute_dtype="bfloat16")
    m = model_from_config(cfg)
    assert (m.hidden_dim, m.pos_in, m.dir_in) == (32, 27, 15)
    assert m.cdt == torch.bfloat16


@pytest.mark.parametrize("family", ["fastnerf", "plenoctree", "ngp"])
def test_unported_families_raise(family):
    from nerf_tpu.models.registry import MODEL_REGISTRY

    assert family in MODEL_REGISTRY
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(family)


@pytest.mark.parametrize("family", ["nerf", "siren", "gabor", "kilonerf", "plenoxels"])
def test_ported_families_build_from_a_config(family):
    """Each ported family builds from a config by name (the JAX registry's
    names), knobs it does not take dropped, and renders a batch."""
    from nerf_tpu.models.registry import MODEL_REGISTRY

    assert family in MODEL_REGISTRY
    grid_res = 8 if family == "plenoxels" else 0     # 0: the family's default
    m = model_from_config(Config(model_type=family, hidden_dim=32, grid_res=grid_res),
                          generator=torch.Generator().manual_seed(0))
    assert type(m).__name__.lower().startswith(family)
    pts = torch.rand(5, 7, 3) * 2 - 1
    dirs = torch.nn.functional.normalize(torch.randn(5, 7, 3), dim=-1)
    with torch.no_grad():
        rgb, sigma = m(pts, dirs)
    assert rgb.shape == (5, 7, 3) and sigma.shape == (5, 7)
    assert torch.isfinite(rgb).all() and torch.isfinite(sigma).all()


def test_unknown_family_raises():
    with pytest.raises(ValueError):
        create_model("nope")
