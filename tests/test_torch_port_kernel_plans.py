"""Host-side plans and routes of the port's kernels, checked on the CPU.

* The bfloat16 train passes of NeRF and SIREN (PERF.md rows 5 and 8) run
  on the tensor cores (``csrc/fused_render_train_tc.cu``,
  ``csrc/fused_render_siren_train_tc.cu``); the float32 train passes and
  the render backwards (rows 4 and 7) stay on ``csrc/fused_render_train.cu``
  and ``csrc/fused_render_siren_train.cu``. Their launch plan and the bytes
  of their stashes are computed here, on the host.
* The bfloat16 forward renders of NeRF, SIREN and GaborNet (rows 3, 6 and
  11) run on the tensor cores (``csrc/fused_render_fwd_tc.cu``,
  ``csrc/fused_render_siren_fwd_tc.cu``,
  ``csrc/fused_render_gabor_fwd_tc.cu``) at two CTAs an SM; the float32
  ones stay on the CUDA-core kernels at one.
* The scatter-add (row 19) sorts its keys by a radix sort whose passes and
  digit width follow from the number of rows.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).
"""

from __future__ import annotations

import pytest
import torch

from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda import build, fused_render, fused_render_gabor, fused_render_siren
from nerf_tpu_torch.ops.cuda.fused_render import (
    TC_BYTES_PER_POINT, FusedNerfRender, FusedRender, fwd_rays_per_cta, launch_plan)
from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
from nerf_tpu_torch.ops.cuda.scatter_add import radix_plan

# the float32 stash of csrc/fused_render_train.cu: floats_per_point<2>() of
# fused_render_common.cuh (9 x 256 + 256 + 128 + 2 x 64 + 2 x 256 + 12)
F32_STASH_BYTES = 4 * (9 * 256 + 256 + 128 + 2 * 64 + 2 * 256 + 12)
# the SIREN's, FLOATS_PER_POINT of fused_render_siren_common.cuh
# (2 x 8 x 256 + 256 + 2 x 128 + 64 + 2 x 256 + 16)
SIREN_F32_STASH_BYTES = 4 * (2 * 8 * 256 + 256 + 2 * 128 + 64 + 2 * 256 + 16)


@pytest.mark.parametrize("shape, plan", [
    ((1024, 256), (8, 128, 2048)),   # bench.py's headline step
    ((1024, 64), (8, 128, 512)),     # lego.txt's coarse pass
    ((1024, 192), (8, 128, 1536)),   # and its fine pass
    ((5, 8), (1, 5, 64)),            # CTAs left idle
    ((133, 64), (2, 67, 128)),       # two rays on a CTA
    ((300, 37), (3, 100, 128)),      # chunks that span rays
])
def test_train_launch_plan_and_stash_bytes(shape, plan):
    """The rays split over 132 SMs, each CTA's stash its points rounded up
    to 64-point chunks; the tensor-core pass keeps 7,664 bytes a point,
    0.57 of the float32 stash's."""
    num_rays, s = shape
    rays_per_cta, grid, cap = launch_plan(num_rays, s, 132)
    assert (rays_per_cta, grid, cap) == plan
    assert grid * rays_per_cta >= num_rays > (grid - 1) * rays_per_cta
    assert cap % 64 == 0 and cap >= rays_per_cta * s > cap - 64
    assert TC_BYTES_PER_POINT == 7664
    assert TC_BYTES_PER_POINT / F32_STASH_BYTES == pytest.approx(0.5737, abs=1e-4)
    if shape == (1024, 256):
        assert grid * cap * TC_BYTES_PER_POINT == 2_009_071_616


def test_siren_train_stash_bytes():
    """The SIREN tensor-core pass keeps 15,744 bytes a point (its cosines
    c1..c8 float32: a bf16 copy would move a rounding point), 0.757 of the
    CUDA-core kernel's float32 stash; 4.1 GB at lego_siren.txt's 1024 x 256
    on 132 SMs."""
    assert fused_render_siren.TC_BYTES_PER_POINT == 15_744
    assert fused_render_siren.TC_BYTES_PER_POINT % 16 == 0
    assert fused_render_siren.TC_BYTES_PER_POINT / SIREN_F32_STASH_BYTES == pytest.approx(
        0.7569, abs=1e-4)
    _, grid, cap = launch_plan(1024, 256, 132)
    assert grid * cap * fused_render_siren.TC_BYTES_PER_POINT == 4_127_195_136


@pytest.mark.parametrize("num_rows, plan", [
    (1, (1, 1)), (2, (1, 2)), (255, (1, 8)), (256, (2, 5)), (5000, (2, 7)),
    (128 ** 3, (3, 8)), (2 ** 24 + 3000, (4, 7)), (2 ** 31 - 2, (4, 8)),
])
def test_scatter_radix_plan(num_rows, plan):
    """The keys are the row ids and num_rows (skipped ids): bit_length(
    num_rows) bits in the fewest passes of at most 8 bits, split evenly
    (3 passes at the plenoxels grid's 128^3 rows, where a 32-bit sort
    takes 4)."""
    passes, bits = radix_plan(num_rows)
    assert (passes, bits) == plan
    need = num_rows.bit_length()
    assert passes * bits >= need and bits <= 8
    assert (passes - 1) * 8 < need


@pytest.mark.parametrize("cdt, family", [
    pytest.param("float32", "nerf", id="float32"),
    pytest.param("bfloat16", "nerf", id="bfloat16"),
    pytest.param("float32", "siren", id="siren-float32"),
    pytest.param("bfloat16", "siren", id="siren-bfloat16")])
def test_bf16_train_pass_routes_to_the_tensor_core_library(cdt, family, monkeypatch):
    """Only the bfloat16 train pass goes to the tensor-core library
    (fused_render_train_tc, fused_render_siren_train_tc); the float32 train
    pass and the render backward (both dtypes) keep the CUDA-core one. The
    dispatch of _launch_grad is checked with both launchers replaced (no
    card here)."""
    gen = torch.Generator().manual_seed(0)
    if family == "nerf":
        cls, lib = FusedNerfRender, "fused_render_train"
        fr = cls(NeRFModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
    else:
        cls, lib = FusedSirenRender, "fused_render_siren_train"
        fr = cls(SirenModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
    tc = cdt == "bfloat16"
    assert fr.grad_library(True) == (lib + "_tc" if tc else lib)
    assert fr.grad_library(False) == lib
    assert lib + "_tc" in build.LIBS and lib in build.LIBS
    calls = []
    monkeypatch.setattr(cls, "_launch_train_tc", lambda self, *a: calls.append("tc"))
    monkeypatch.setattr(FusedRender, "_launch_grad_cuda_core",
                        lambda self, *a: calls.append("cuda-core"))
    x = torch.zeros(2, 3)
    for train in (True, False):
        fr._launch_grad(None, x, x, x, torch.zeros(2, 4), x, train, True)
    assert calls == (["tc", "cuda-core"] if tc else ["cuda-core", "cuda-core"])


@pytest.mark.parametrize("shape, plan", [
    ((8192, 64), (32, 256, 32)),     # lego.txt's coarse pass (chunk 8192)
    ((8192, 192), (32, 256, 96)),    # and its fine pass
    ((1024, 256), (4, 256, 16)),     # a GaborNet request's chunk
    ((1000, 256), (4, 250, 16)),     # a ragged ray count
    ((300, 37), (2, 150, 2)),        # chunks that span rays
])
def test_fwd_launch_plan_at_two_ctas_an_sm(shape, plan):
    """The tensor-core forward renders split the rays over two CTAs on each
    of 132 SMs (every CTA resident at once), a CTA walking its rays' samples
    in 64-point chunks: (rays a CTA, CTAs, chunks a CTA). The CUDA-core
    kernels take one CTA an SM."""
    num_rays, s = shape
    rays_per_cta = fwd_rays_per_cta(num_rays, 132, 2)
    grid, chunks = -(-num_rays // rays_per_cta), -(-rays_per_cta * s // 64)
    assert (rays_per_cta, grid, chunks) == plan
    assert grid <= 2 * 132
    assert grid * rays_per_cta >= num_rays > (grid - 1) * rays_per_cta
    assert fwd_rays_per_cta(num_rays, 132, 1) == -(-num_rays // 132)


class _FakeLib:
    """Stands for a loaded library: each attribute names its entry point."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, entry):
        return f"{self.name}:{entry}"


@pytest.mark.parametrize("family", ["nerf", "gabor", "siren"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_fwd_library_routes_bf16_to_the_tensor_cores(family, cdt, monkeypatch):
    """The bfloat16 forward render goes to the tensor-core library at two
    CTAs an SM, the float32 one to the CUDA-core library at one; the entry
    the launch takes is checked with the libraries replaced (no card
    here)."""
    gen = torch.Generator().manual_seed(0)
    if family == "nerf":
        fr = FusedNerfRender(NeRFModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
        module, lib, entry = fused_render, "fused_render_fwd", "fused_render_fwd"
    elif family == "gabor":
        fr = FusedGaborRender(GaborModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
        module, lib, entry = fused_render_gabor, "fused_render_gabor_fwd", "fused_gabor_fwd"
    else:
        fr = FusedSirenRender(SirenModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
        module, lib, entry = fused_render_siren, "fused_render_siren_fwd", "fused_siren_fwd"
    tc = cdt == "bfloat16"
    if tc:
        lib, entry = lib + "_tc", entry + "_tc"
    assert fr.fwd_library() == lib
    monkeypatch.setattr(module, "_library", _FakeLib)
    fn, err, ctas_per_sm = fr._fwd_entry()
    assert (fn, err) == (f"{lib}:{entry}", f"{lib}:{entry}_error")
    assert ctas_per_sm == (2 if tc else 1)


def test_build_lists_the_tensor_core_forward_renders():
    """Twenty-two libraries, one per .cu source, the three tensor-core
    forward renders and the SIREN's tensor-core train pass beside the
    CUDA-core ones they took bfloat16 from."""
    assert len(build.LIBS) == len(set(build.LIBS)) == 22
    for name in ("fused_render_fwd_tc", "fused_render_gabor_fwd_tc",
                 "fused_render_siren_fwd_tc", "fused_render_siren_train_tc",
                 "fused_render_fwd", "fused_render_gabor_fwd",
                 "fused_render_siren_fwd", "fused_render_siren_train"):
        assert name in build.LIBS
    sources = {p.stem for p in build._CSRC.glob("*.cu")}
    assert sources == set(build.LIBS)
