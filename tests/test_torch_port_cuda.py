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

from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.fused_render import (
    FusedNerfRender,
    fused_render_plain,
)
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.step import make_eval_render

pytestmark = pytest.mark.cuda

NEAR, FAR = 2.0, 6.0
# kernel vs plain on the same card (see chip_smoke.py for the reasoning):
# float32 sums in another order; bfloat16 rounding flips after such sums
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


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


def test_kernel_refuses_grad(dev):
    model = NeRFModel().to(dev)
    fr = FusedNerfRender(model, NEAR, FAR)
    ro, rd, t = _inputs(4, 8, dev)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fr(model, ro, rd, rd, t)


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
