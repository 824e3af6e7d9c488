"""Host-side plans and routes of the port's kernels, checked on the CPU.

* The bfloat16 train passes of NeRF, SIREN and GaborNet (PERF.md rows 5, 8
  and 12) and the bfloat16 NeRF and SIREN render backwards (rows 4 and 7)
  run on the tensor cores (``csrc/fused_render_train_tc.cu``,
  ``csrc/fused_render_siren_train_tc.cu``,
  ``csrc/fused_render_gabor_train_tc.cu``); the float32 train passes and
  render backwards stay on ``csrc/fused_render_train.cu``,
  ``csrc/fused_render_siren_train.cu`` and
  ``csrc/fused_render_gabor_train.cu``. Their launch plan and the bytes of
  their stashes are computed here, on the host.
* The bfloat16 forward renders of NeRF, SIREN and GaborNet (rows 3, 6 and
  11) run on the tensor cores (``csrc/fused_render_fwd_tc.cu``,
  ``csrc/fused_render_siren_fwd_tc.cu``,
  ``csrc/fused_render_gabor_fwd_tc.cu``) at two CTAs an SM; the float32
  ones stay on the CUDA-core kernels at one.
* The NeRF, SIREN and GaborNet field forwards and backwards (rows 1, 9, 13,
  2, 10 and 14) run in bfloat16 on the tensor cores
  (``csrc/fused_{nerf,siren,gabor}_{fwd,bwd}_tc.cu``) and in float32 on
  the CUDA cores.
* The scatter-add (row 19) sorts its keys by a radix sort whose passes and
  digit width follow from the number of rows.
* The KiloNeRF forward and backward (rows 15 and 16) run in bfloat16 on
  the tensor cores (``csrc/fused_kilonerf_{fwd,bwd}_tc.cu``) and in float32
  on the CUDA cores, over 128-point (forward) and 512-point (backward) runs
  of one network whose plan follows from the counts.
* The grid render (row 18) takes two affine scalars computed on the host;
  they are held against nerf_tpu's ``FusedGridRender._cells``.
* The NeRF kernels (rows 1-5) take hidden 256, 512, 768 and 1024 with the
  encodings padded to 64 or 128 / 32 or 64 columns: each shape's plan
  (``ops/cuda/nerf_plan.py``) fits an H100's 227 KB of shared memory in
  every kernel, its stash bytes are the sources' formulas, and outside
  those shapes the plan and the wrappers raise, naming ROADMAP.md's queue.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.plenoxels import PlenoxelsModel as JaxPlenoxels
from nerf_tpu.ops.pallas.fused_grid_render import make_fused_grid_render as jax_grid_render

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda import (
    build, fused_gabor, fused_nerf, fused_render, fused_render_gabor, fused_render_siren,
    fused_siren, gabor_plan, nerf_plan, siren_plan)
from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender, cells_affine
from nerf_tpu_torch.ops.cuda import fused_kilonerf
from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
    BWD_RUN, FWD_RUN, KiloNeRFField, dispatch, run_plan)
from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
from nerf_tpu_torch.ops.cuda.fused_render import (
    TC_BYTES_PER_POINT, FusedNerfRender, FusedRender, fwd_rays_per_cta, launch_plan,
    pack_params)
from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
from nerf_tpu_torch.ops.cuda.scatter_add import radix_plan

# the float32 stash of csrc/fused_render_train.cu: floats_per_point<2>() of
# fused_render_common.cuh (9 x 256 + 256 + 128 + 2 x 64 + 2 x 256 + 12)
F32_STASH_BYTES = 4 * (9 * 256 + 256 + 128 + 2 * 64 + 2 * 256 + 12)
# the SIREN's, FLOATS_PER_POINT of fused_render_siren_common.cuh
# (2 x 8 x 256 + 256 + 2 x 128 + 64 + 2 x 256 + 16)
SIREN_F32_STASH_BYTES = 4 * (2 * 8 * 256 + 256 + 2 * 128 + 64 + 2 * 256 + 16)
# the GaborNet's, floats_per_point<2>() of fused_render_gabor_common.cuh
# (8 x 256 + 7 x 256 + 256 + 128 + 64 + 2 x 256 + 16)
GABOR_F32_STASH_BYTES = 4 * (8 * 256 + 7 * 256 + 256 + 128 + 64 + 2 * 256 + 16)


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


def test_gabor_train_stash_bytes():
    """The GaborNet tensor-core pass keeps 14,208 bytes a point (u2..u8 and
    z8 float32: the filter cotangent's factor and the ws gradient; the
    filters evaluated again, not stashed), 0.738 of the CUDA-core kernel's
    float32 stash; 3.7 GB at lego_siren.txt's 1024 x 256 on 132 SMs."""
    assert fused_render_gabor.TC_BYTES_PER_POINT == 14_208
    assert fused_render_gabor.TC_BYTES_PER_POINT % 16 == 0
    assert fused_render_gabor.TC_BYTES_PER_POINT / GABOR_F32_STASH_BYTES == pytest.approx(
        0.7375, abs=1e-4)
    _, grid, cap = launch_plan(1024, 256, 132)
    assert grid * cap * fused_render_gabor.TC_BYTES_PER_POINT == 3_724_541_952


@pytest.mark.parametrize("n, run, grid", [
    (16384, 128, 128),     # a distillation step's batch
    (65536, 512, 128),     # a bake's chunk
    (1000, 64, 16),        # ragged
    (37, 64, 1),
])
def test_field_bwd_tc_plan_and_stash_bytes(n, run, grid):
    """The tensor-core field backwards (rows 2, 10 and 14 in bfloat16) take
    about one run of points an SM on 132 SMs, whole 64-point chunks, as the
    CUDA-core ones; a CTA's stash holds its run: the NeRF's 7,920 bytes a
    point (the train pass's 7,664 and dz6 w6p^T in float32), the SIREN's
    15,744 (the train pass's: the point cotangent needs no column) and the
    GaborNet's 14,208 (the train pass's, the point cotangent among its
    columns); 130 MB / 258 MB / 233 MB at the distillation batch. Each CTA
    writes one gradient partial (2.65 MB / 2.3 MB / 2.33 MB)."""
    from nerf_tpu_torch.ops.cuda.field import bwd_runs

    assert bwd_runs(n, 132) == (run, grid)
    assert run % 64 == 0 and grid * run >= n > (grid - 1) * run
    assert fused_nerf.TC_BWD_BYTES_PER_POINT == TC_BYTES_PER_POINT + 4 * 64 == 7920
    assert fused_gabor.TC_BWD_BYTES_PER_POINT == fused_render_gabor.TC_BYTES_PER_POINT == 14_208
    assert fused_siren.TC_BWD_BYTES_PER_POINT == fused_render_siren.TC_BYTES_PER_POINT == 15_744
    assert fused_nerf.TC_BWD_COLS_AT * 4 == 7920 - 4 * 64 - 4 * 12
    assert fused_gabor.TC_BWD_COLS_AT * 4 == 14_208 - 4 * 16
    assert fused_siren.TC_BWD_COLS_AT * 4 == 15_744 - 4 * 16
    stash = {"nerf": grid * run * fused_nerf.TC_BWD_BYTES_PER_POINT,
             "siren": grid * run * fused_siren.TC_BWD_BYTES_PER_POINT,
             "gabor": grid * run * fused_gabor.TC_BWD_BYTES_PER_POINT}
    if n == 16384:
        assert stash == {"nerf": 129_761_280, "siren": 257_949_696, "gabor": 232_783_872}
    if n == 65536:
        assert stash == {"nerf": 519_045_120, "siren": 1_031_798_784,
                         "gabor": 931_135_488}


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
    pytest.param("bfloat16", "siren", id="siren-bfloat16"),
    pytest.param("float32", "gabor", id="gabor-float32"),
    pytest.param("bfloat16", "gabor", id="gabor-bfloat16")])
def test_bf16_train_pass_routes_to_the_tensor_core_library(cdt, family, monkeypatch):
    """The bfloat16 train pass goes to the tensor-core library
    (fused_render_train_tc, fused_render_siren_train_tc,
    fused_render_gabor_train_tc), and so do the bfloat16 NeRF and SIREN
    render backwards (fused_render_train_tc, fused_render_siren_train_tc);
    the float32 train pass and render backward keep the CUDA-core one, and
    a GaborNet has no render backward. The dispatch of _launch_grad is checked with both
    launchers replaced, and the entry the GaborNet's _launch_train takes
    with the libraries replaced (no card here)."""
    gen = torch.Generator().manual_seed(0)
    if family == "gabor":
        cls, lib = FusedGaborRender, "fused_render_gabor_train"
        model = GaborModel(compute_dtype=cdt, generator=gen)
        fr = cls(model, 2.0, 6.0)
        tc = cdt == "bfloat16"
        assert fr.grad_library(True) == (lib + "_tc" if tc else lib)
        with pytest.raises(NotImplementedError, match="no backward"):
            fr.grad_library(False)
        assert lib + "_tc" in build.LIBS and lib in build.LIBS
        monkeypatch.setattr(fused_render_gabor, "_library", _FakeLib)
        lib, entry = (lib + "_tc", "fused_gabor_train_tc") if tc else (lib, "fused_gabor_train")
        assert fr._train_entry() == (f"{lib}:{entry}", f"{lib}:{entry}_error",
                                     f"{lib}:{entry}_sizes", tc)
        return
    if family == "nerf":
        cls, lib = FusedNerfRender, "fused_render_train"
        fr = cls(NeRFModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
    else:
        cls, lib = FusedSirenRender, "fused_render_siren_train"
        fr = cls(SirenModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
    tc = cdt == "bfloat16"
    assert fr.grad_library(True) == (lib + "_tc" if tc else lib)
    assert fr.grad_library(False) == (lib + "_tc" if tc else lib)
    assert lib + "_tc" in build.LIBS and lib in build.LIBS
    calls = []
    monkeypatch.setattr(cls, "_launch_train_tc", lambda self, *a: calls.append("tc"))
    monkeypatch.setattr(FusedRender, "_launch_grad_cuda_core",
                        lambda self, *a: calls.append("cuda-core"))
    x = torch.zeros(2, 3)
    for train in (True, False):
        fr._launch_grad(None, x, x, x, torch.zeros(2, 4), x, train, True)
    assert calls == ["tc" if tc else "cuda-core"] * 2


class _Recorded(Exception):
    """Raised by a replaced buffer plan, once a launch has picked its entry."""


@pytest.mark.parametrize("cdt, family, want", [
    pytest.param("bfloat16", "nerf", "fused_render_train_tc:fused_render_bwd_tc",
                 id="nerf-bfloat16"),
    pytest.param("float32", "nerf", "fused_render_train:fused_render_grad",
                 id="nerf-float32"),
    pytest.param("bfloat16", "siren",
                 "fused_render_siren_train_tc:fused_siren_render_bwd_tc", id="siren-bfloat16"),
    pytest.param("float32", "siren", "fused_render_siren_train:fused_siren_grad",
                 id="siren-float32")])
def test_render_backward_takes_its_entry(cdt, family, want, monkeypatch):
    """The entry point a render backward launches, with the libraries
    replaced (no card here): the bfloat16 NeRF's is fused_render_bwd_tc
    and the bfloat16 SIREN's fused_siren_render_bwd_tc, each beside the
    tensor-core train pass in its library (rows 4 and 7); the float32
    ones the CUDA-core fused_*_grad. Each library is one of LIBS."""
    gen = torch.Generator().manual_seed(0)
    if family == "nerf":
        cls, mod = FusedNerfRender, fused_render
        fr = cls(NeRFModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
    else:
        cls, mod = FusedSirenRender, fused_render_siren
        fr = cls(SirenModel(compute_dtype=cdt, generator=gen), 2.0, 6.0)
    for m in {mod, fused_render}:
        monkeypatch.setattr(m, "_library", _FakeLib)
        monkeypatch.setattr(m, "grad_sizes", lambda sizes: sizes)
    picked = []
    for attr in ("_grad_entry", "_train_tc_entry", "_bwd_tc_entry"):
        if hasattr(cls, attr):
            entry = getattr(cls, attr)
            monkeypatch.setattr(cls, attr, lambda self, entry=entry: (
                picked.append(entry(self)[0]), entry(self))[1])

    def buffers(self, t, sizes, stash_dtype):
        raise _Recorded

    monkeypatch.setattr(FusedRender, "_grad_buffers", buffers)
    monkeypatch.setattr(FusedRender, "_check", lambda self, packed, named: None)
    x, t, g = torch.zeros(2, 3), torch.zeros(2, 4), torch.zeros(2, 8)
    with pytest.raises(_Recorded):
        fr._launch_grad(None, x, x, x, t, g, False, False)
    assert picked == [want]
    lib = want.split(":")[0]
    assert fr.grad_library(False) == lib
    assert lib in build.LIBS


@pytest.mark.parametrize("cdt, want", [
    pytest.param("bfloat16", "fused_render_siren_train_tc", id="bfloat16"),
    pytest.param("float32", "fused_render_siren_train", id="float32")])
def test_siren_render_backward_library(cdt, want):
    """Row 7's library: in bfloat16 the SIREN render backward shares the
    tensor-core train pass's library (its own entry there), in float32 it
    stays on the CUDA-core one; both are built (LIBS)."""
    fr = FusedSirenRender(SirenModel(compute_dtype=cdt,
                                     generator=torch.Generator().manual_seed(0)), 2.0, 6.0)
    assert fr.grad_library(False) == fr.grad_library(True) == want
    assert want in build.LIBS


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

    def __init__(self, name, shape=None):
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
    """Thirty-one libraries, one per .cu source, the three tensor-core
    forward renders, the SIREN's and GaborNet's tensor-core train passes,
    and the KiloNeRF, NeRF, SIREN and GaborNet tensor-core field forwards
    and backwards beside the CUDA-core ones they took bfloat16 from."""
    assert len(build.LIBS) == len(set(build.LIBS)) == 31
    for name in ("fused_render_fwd_tc", "fused_render_gabor_fwd_tc",
                 "fused_render_siren_fwd_tc", "fused_render_siren_train_tc",
                 "fused_render_gabor_train_tc", "fused_kilonerf_fwd_tc",
                 "fused_nerf_fwd_tc", "fused_siren_fwd_tc",
                 "fused_gabor_fwd_tc", "fused_kilonerf_fwd",
                 "fused_render_fwd", "fused_render_gabor_fwd",
                 "fused_render_siren_fwd", "fused_render_siren_train",
                 "fused_render_gabor_train", "fused_nerf_fwd", "fused_siren_fwd",
                 "fused_gabor_fwd", "fused_nerf_bwd_tc", "fused_gabor_bwd_tc",
                 "fused_nerf_bwd", "fused_gabor_bwd", "fused_siren_bwd_tc",
                 "fused_kilonerf_bwd_tc", "fused_siren_bwd", "fused_kilonerf_bwd"):
        assert name in build.LIBS
    sources = {p.stem for p in build._CSRC.glob("*.cu")}
    assert sources == set(build.LIBS)


# the field kernels' (family, module, wrapper, model, C entry of the
# CUDA-core forward library, of the backward's); the GaborNet's cases keep
# their ids of one parameter
_FIELD_FWD = {"nerf": (fused_nerf, "NerfField", NeRFModel, "fused_nerf_fwd", "fused_nerf_bwd"),
              "siren": (fused_siren, "SirenField", SirenModel, "siren_field_fwd",
                        "siren_field_bwd"),
              "gabor": (fused_gabor, "GaborField", GaborModel, "gabor_field_fwd",
                        "gabor_field_bwd")}


@pytest.mark.parametrize("family,cdt", [
    pytest.param(f, c, id=c if f == "gabor" else f"{f}-{c}")
    for f in ("nerf", "siren", "gabor") for c in ("float32", "bfloat16")])
def test_gabor_field_fwd_routes_bf16_to_the_tensor_cores(family, cdt, monkeypatch):
    """The NeRF, SIREN and GaborNet field forwards go to fused_{nerf,siren,
    gabor}_fwd_tc in bfloat16 and to fused_{nerf,siren,gabor}_fwd in float32
    (one C signature, the entry named after the library's); the backwards
    to fused_{nerf,siren,gabor}_bwd_tc in bfloat16 and to
    fused_{nerf,siren,gabor}_bwd in float32. The launches' entries are
    checked with the libraries replaced (no card here)."""
    module, wrapper, model_cls, entry, bwd_entry = _FIELD_FWD[family]
    field = getattr(module, wrapper)(model_cls(compute_dtype=cdt,
                                               generator=torch.Generator().manual_seed(0)))
    tc = cdt == "bfloat16"
    lib = f"fused_{family}_fwd" + ("_tc" if tc else "")
    entry += "_tc" if tc else ""
    assert field.fwd_library() == lib and lib in build.LIBS
    bwd_lib = f"fused_{family}_bwd" + ("_tc" if tc else "")
    bwd_entry += "_tc" if tc else ""
    assert field.bwd_library() == bwd_lib and bwd_lib in build.LIBS
    monkeypatch.setattr(module, "_library", _FakeLib)
    assert field._fwd_entry() == (f"{lib}:{entry}", f"{lib}:{entry}_error")
    assert field._bwd_entry() == tuple(f"{bwd_lib}:{bwd_entry}{s}"
                                       for s in ("", "_error", "_sizes"))


@pytest.mark.parametrize("counts, ends, ctas", [
    ([300, 0, 128, 1], [3, 3, 4, 5], 8),          # ragged, empty and one-point runs
    ([0, 0, 0, 37], [0, 0, 0, 1], 5),             # 37 points, one network
    ([5000, 0, 0, 0], [40, 40, 40, 40], 44),      # every point in one voxel
])
def test_kilonerf_fwd_launch_plan(counts, ends, ctas):
    """Row 15's plan: the running count of 128-point runs of one network
    (a CTA's run, find_run), and a grid of ceil(n / 128) + G^3 CTAs that
    covers any placement of n points without reading the counts back."""
    counts = torch.tensor(counts)
    got_ends, got_ctas = run_plan(counts, int(counts.sum()), FWD_RUN)
    assert got_ends.dtype == torch.int32 and got_ends.tolist() == ends
    assert got_ctas == ctas >= ends[-1]


def test_kilonerf_fwd_launch_plan_at_the_camera_set():
    """At 262,144 points of a 1024 x 256 camera set over the 512 networks of
    the kilonerf config, the forward's plan holds at most 2,048 + 512 runs
    and the backward's (512-point runs) at most 512 + 512; the bfloat16
    forward and backward go to the tensor-core libraries, float32 to the
    CUDA-core ones."""
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand(262144, 3, generator=gen) * 2.0 - 1.0
    pts[:200000] = pts[:200000] * 0.1 - 0.5                # a skewed scene
    model = KiloNeRFModel(grid_res=8, hidden_dim=32, compute_dtype="bfloat16")
    disp = dispatch(model, pts, torch.nn.functional.normalize(pts, dim=-1))
    ends, ctas = run_plan(disp.counts, disp.n, FWD_RUN)
    assert ctas == 2048 + 512
    runs = int(ends[-1])
    assert runs == sum(-(-int(c) // FWD_RUN) for c in disp.counts) <= ctas
    ends, ctas = run_plan(disp.counts, disp.n, BWD_RUN)
    assert ctas == 512 + 512
    assert int(ends[-1]) == sum(-(-int(c) // BWD_RUN) for c in disp.counts) <= ctas
    assert int(ends[-1]) < runs
    assert KiloNeRFField(model).fwd_library() == "fused_kilonerf_fwd_tc"
    assert KiloNeRFField(model).bwd_library() == "fused_kilonerf_bwd_tc"
    f32 = KiloNeRFField(KiloNeRFModel(grid_res=2))
    assert (f32.fwd_library(), f32.bwd_library()) == ("fused_kilonerf_fwd",
                                                       "fused_kilonerf_bwd")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_kilonerf_bwd_routes_bf16_to_the_tensor_cores(cdt, monkeypatch):
    """The KiloNeRF backward (row 16) goes to fused_kilonerf_bwd_tc in
    bfloat16 (whose entry reads the point-order payload and cotangent
    through the sort) and to fused_kilonerf_bwd in float32, each with its
    partial-size entry; checked with the libraries replaced (no card
    here)."""
    model = KiloNeRFModel(grid_res=2, hidden_dim=32, compute_dtype=cdt)
    field = KiloNeRFField(model)
    lib = "fused_kilonerf_bwd" + ("_tc" if cdt == "bfloat16" else "")
    assert field.bwd_library() == lib and lib in build.LIBS
    monkeypatch.setattr(fused_kilonerf, "_library", _FakeLib)
    floats = lib + "_partial_floats" if lib.endswith("_tc") else "fused_kilonerf_partial_floats"
    assert field._bwd_entry() == (f"{lib}:{lib}", f"{lib}:{lib}_error", f"{lib}:{floats}")


@pytest.mark.parametrize("normalize", [True, False])
def test_grid_render_affine_scalars_match_nerf_tpu_cells(normalize):
    """The two scalars FusedGridRender.affine computes on the host, applied
    as the kernel applies them (scale * o + off, scale * d, then + d' t and
    the clamp), give nerf_tpu's _cells at every sample: 16 rays x 24 samples
    over lego_siren.txt's grid domain at R = 16, with and without the
    [near, far] normalisation."""
    domain, near, far, r = (-2.75, -1.25), 2.0, 6.0, 16
    rng = np.random.default_rng(3)
    o = rng.normal(size=(16, 3)).astype(np.float32) * 2.0
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(near, far, (16, 24)).astype(np.float32), axis=-1)
    jfr = jax_grid_render(JaxPlenoxels(grid_res=r, domain=domain), near, far,
                          normalize=normalize, interpret=True, force=True)
    want = np.stack([np.asarray(x) for x in jfr._cells(jnp.asarray(o), jnp.asarray(d),
                                                        jnp.asarray(t))], axis=-1)
    fr = FusedGridRender(PlenoxelsModel(grid_res=r, domain=domain), near, far, normalize)
    scale, off = fr.affine(r)
    assert isinstance(scale, float) and isinstance(off, float)
    o_aff, d_aff = cells_affine(torch.from_numpy(o), torch.from_numpy(d), scale, off)
    got = (o_aff[:, None, :] + d_aff[:, None, :] * torch.from_numpy(t)[..., None]).clamp(
        0.0, r - 1.0)
    assert bool(((got > 0.0) & (got < r - 1.0)).any())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * np.spacing(np.float32(r)))


@pytest.mark.parametrize("h, p_pad, d_pad", list(itertools.product(
    nerf_plan.WIDTHS, nerf_plan.P_PADS, nerf_plan.D_PADS)))
def test_plan_fits_shared_memory(h, p_pad, d_pad):
    """Every kernel of the shape under 227 KB of shared memory; the bf16
    forward kernels two CTAs an SM at hidden 256 (one tile) and one wider
    (two tiles); chunks that divide each other and the backward's 32-point
    k-tiles; stash bytes a point as the sources count them."""
    pl = nerf_plan.plan(h, p_pad, d_pad)
    assert max(pl.smem().values()) <= nerf_plan.SMEM_LIMIT
    assert pl.fwd_ctas_per_sm == (2 if h == 256 else 1)
    assert pl.tc_p % pl.tc_pb == 0 and pl.tc_p % 32 == 0 and pl.tc_pb % 16 == 0
    assert pl.p * 8 >= 16 and (h * (pl.p + 4)) >= 2 * 16 * (64 + 256)
    hr = h // 2
    assert pl.tc_bytes_per_point == 2 * (12 * h + hr + p_pad + d_pad) + 4 * (h + 12)
    assert pl.field_tc_bytes_per_point == pl.tc_bytes_per_point + 4 * p_pad
    assert pl.f32_floats_per_point(2) == 10 * h + hr + 2 * p_pad + 2 * h + 12
    assert pl.tc_bytes_per_point % 16 == 0 and pl.f32_floats_per_point(3) % 4 == 0
    assert pl.default == ((h, p_pad, d_pad) == (256, 64, 32))
    assert (pl.defines == ()) == pl.default
    assert pl.tag == f"h{h}p{p_pad}d{d_pad}"
    if pl.default:
        # the hidden-256 kernels: 7,664 stash bytes a point
        # (fused_render_train_tc.cu), 3,340 floats (fused_render_train.cu)
        assert (pl.tc_bytes_per_point, pl.f32_floats_per_point(2)) == (7664, 3340)
        assert (pl.p, pl.tc_p, pl.tc_pb) == (64, 64, 64)


@pytest.mark.parametrize("h, lp, ld", [(1280, 10, 4), (384, 10, 4), (512, 21, 4),
                                       (512, 10, 11), (2048, 10, 4)])
def test_plan_refuses_other_shapes(h, lp, ld):
    """Hidden above 1024 (or not a multiple of 256), more than 128 position
    or 64 direction columns: no plan, and the wrappers refuse before any
    launch, naming ROADMAP.md's queue 2."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        nerf_plan.plan(h, *nerf_plan.enc_pads(lp, ld))
    model = NeRFModel(hidden_dim=h, pos_encoding_dim=lp, dir_encoding_dim=ld)
    fr, field = FusedNerfRender(model, 2.0, 6.0), NerfField(model)
    x, t = torch.zeros(2, 3), torch.zeros(2, 4)
    for wrapper, launch in ((fr, lambda: fr._launch_fwd(None, x, x, x, t)),
                            (field, lambda: field._launch_fwd(None, x, x))):
        assert not wrapper.supported()
        assert "ROADMAP.md queue 2" in wrapper._unsupported()
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
            launch()


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_nerf_wrappers_count_launches_by_shape(cdt):
    """Each count of the NeRF wrappers also goes to ``shape_launches`` under
    (counter, plan tag, dtype): the split by shape that phase 35 of
    chip_smoke.py reads."""
    model = NeRFModel(hidden_dim=512, pos_encoding_dim=12, dir_encoding_dim=6,
                      compute_dtype=cdt)
    for cls, wrapper, counters in (
            (FusedNerfRender, FusedNerfRender(model, 2.0, 6.0),
             ("launches", "train_launches", "bwd_launches")),
            (NerfField, NerfField(model), ("launches", "bwd_launches"))):
        for counter in counters:
            key = (counter, "h512p128d64", cdt)
            before = (getattr(cls, counter), cls.shape_launches[key])
            wrapper._count(counter)
            assert (getattr(cls, counter), cls.shape_launches[key]) == (
                before[0] + 1, before[1] + 1)


def test_enc_pads_follow_nerf_tpu():
    """nerf_tpu pads the encodings to multiples of 64 and 32 columns
    (make_fused_nerf_apply's p_pad and d_pad): L = 10 / 4 gives 64 / 32,
    L = 12 / 6 gives 128 / 64, L = 20 / 10 the widest the kernels take."""
    assert nerf_plan.enc_pads(10, 4) == (64, 32)
    assert nerf_plan.enc_pads(12, 6) == (128, 64)
    assert nerf_plan.enc_pads(20, 10) == (128, 64)
    assert nerf_plan.enc_pads(21, 11) == (192, 96)
    packed = pack_params(NeRFModel(hidden_dim=512, pos_encoding_dim=12, dir_encoding_dim=6))
    assert packed.mats["w1"].shape == (128, 512) and packed.mats["wr0d"].shape == (64, 256)
    with torch.no_grad():
        assert float(packed.mats["w1"][75:].abs().max()) == 0.0
        assert float(packed.mats["wr0d"][39:].abs().max()) == 0.0


# ---------------------------------------------------------------- SIREN plan


def _source_consts(defines: dict, family: str = "siren") -> dict:
    """Every ``constexpr int`` and ``constexpr bool`` of a family's kernel
    headers, in include order (render_common.cuh, fused_render_common.cuh,
    render_tc.cuh, fused_render_{family}_common.cuh,
    fused_render_{family}_tc_common.cuh), evaluated as the compiler does
    under the -D values ``defines`` (NERF_* and GABOR_* -> value): the plan
    the sources' static_asserts hold."""
    import re

    env = dict(defines)
    for name in ("render_common.cuh", "fused_render_common.cuh", "render_tc.cuh",
                 f"fused_render_{family}_common.cuh", f"fused_render_{family}_tc_common.cuh"):
        text = (build._CSRC / name).read_text()
        text = re.sub(r"//[^\n]*", "", text)
        for m in re.finditer(r"^#define ((?:NERF|GABOR)_\w+) (\d+)$", text, re.M):
            env.setdefault(m.group(1), int(m.group(2)))
        for m in re.finditer(r"^constexpr (?:int|bool) (\w+ =[^;]*);", text, re.M):
            for decl in m.group(1).split(","):
                key, expr = (x.strip() for x in decl.split("=", 1))
                expr = re.sub(r"^(.*?) \? (.*?) : (.*)$", r"(\2) if (\1) else (\3)",
                              " ".join(expr.split()))
                env[key] = eval(expr.replace("/", "//"), {}, env)  # noqa: S307
    return env


def _siren_defines(pl) -> dict:
    return {f"NERF_{k}": v for k, v in (("H", pl.h), ("DP", pl.d_pad), ("P", pl.p),
                                        ("TC_P", pl.tc_p), ("TC_PB", pl.tc_pb))}


@pytest.mark.parametrize("h, dp", list(itertools.product(siren_plan.WIDTHS,
                                                         siren_plan.D_PADS)))
def test_siren_plan_fits_shared_memory(h, dp):
    """Every SIREN kernel of the shape under 227 KB of shared memory, and
    each sum the sources' own (SMEM_BYTES, SB_END, SMEM_BWD, the stash
    bytes a point TC_BYTES_PER_POINT and FLOATS_PER_POINT, evaluated from
    the headers under the shape's -D flags); the bf16 forward two CTAs an
    SM at hidden 256 with d_pad 32 and one otherwise; chunks that divide
    each other and the backward's 32-point k-tiles; the NeRF family's chunk
    rule; at hidden 1024 about 62.6 KB a point (31.4 KB at 512)."""
    pl = siren_plan.plan(h, dp)
    assert max(pl.smem().values()) <= nerf_plan.SMEM_LIMIT
    src = _source_consts(_siren_defines(pl))
    assert (src["H"], src["DP"], src["P"], src["TC_P"], src["TC_PB"]) == (
        h, dp, pl.p, pl.tc_p, pl.tc_pb)
    assert pl.smem() == {"f32": src["SMEM_BYTES"], "fwd_tc": src["SB_END"],
                         "bwd_tc": src["SMEM_BWD"]}
    assert pl.tc_bytes_per_point == src["TC_BYTES_PER_POINT"]
    assert pl.f32_floats_per_point == src["FLOATS_PER_POINT"]
    assert src["TC_P"] * src["H"] <= 1 << 16          # a near tie's position in 16 bits
    assert pl.tie_ulps == src["TIE_ULPS"] == (32 if h == 256 else h // 8)
    assert pl.fwd_ctas_per_sm == (2 if (h, dp) == (256, 32) else 1)
    assert pl.tc_p % pl.tc_pb == 0 and pl.tc_p % 32 == 0 and pl.tc_pb % 16 == 0
    np_ = nerf_plan.plan(h, 64, dp)
    assert (pl.p, pl.tc_p, pl.tc_pb) == (np_.p, np_.tc_p, np_.tc_pb)
    assert pl.default == ((h, dp) == (256, 32)) and (pl.defines == ()) == pl.default
    assert pl.tag == f"h{h}d{dp}"
    assert [b[0] for b in pl.builds] == list(siren_plan.LIBS)
    assert set(siren_plan.LIBS) <= set(build.LIBS)
    if pl.default:
        # the hidden-256 kernels: 15,744 stash bytes a point
        # (fused_render_siren_train_tc.cu), 5,200 floats (fused_render_siren_train.cu)
        assert (pl.tc_bytes_per_point, 4 * pl.f32_floats_per_point) == (
            15_744, SIREN_F32_STASH_BYTES)
        assert pl.tc_bytes_per_point == fused_render_siren.TC_BYTES_PER_POINT
    if h == 1024 and dp == 32:
        assert pl.tc_bytes_per_point == 62_592
    if h == 512 and dp == 32:
        assert pl.tc_bytes_per_point == 31_360


def test_siren_stash_is_what_the_library_sizes():
    """A bf16 SIREN train pass sizes its stash from the library's
    fused_siren_train_tc_sizes (here a fake that reports the plan's bytes a
    point): at hidden 1024, lego_siren.txt's step (1024 rays x 256
    samples on 132 SMs) stashes 262,144 points of 62,592 bytes, 16.4 GB,
    which an 80 GB card holds."""
    import ctypes

    fr = FusedSirenRender(SirenModel(hidden_dim=1024, compute_dtype="bfloat16"), 2.0, 6.0)

    def sizes(per_point, npart, n_out):
        for ptr, v in ((per_point, fr.plan.tc_bytes_per_point), (npart, 4), (n_out, 1)):
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[0] = v

    got = fused_render.grad_sizes(sizes)
    assert got[0] == fr.plan.tc_bytes_per_point == 62_592
    _, grid, cap = launch_plan(1024, 256, 132)
    assert grid * cap * got[0] == 16_408_117_248


@pytest.mark.parametrize("h, ld", [(1280, 4), (512, 11), (384, 4)])
def test_siren_plan_refuses_other_shapes(h, ld):
    """Hidden 1280 (nerf_tpu's kernels take it) or a direction encoding
    padded to 96 columns (L_d = 11), or a width that is no multiple of 256:
    no plan, and the wrappers refuse at the launch's check, naming
    ROADMAP.md's queue 2."""
    dp = siren_plan.d_pad(ld)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        siren_plan.plan(h, dp)
    model = SirenModel(hidden_dim=h, dir_encoding_dim=ld)
    fr, field = FusedSirenRender(model, 2.0, 6.0), fused_siren.SirenField(model)
    x, t = torch.zeros(2, 3), torch.zeros(2, 4)
    for wrapper, launch in ((fr, lambda: fr._launch_fwd(None, x, x, x, t)),
                            (field, lambda: field._launch_fwd(None, x, x))):
        assert not wrapper.supported() and wrapper.plan is None
        assert "ROADMAP.md queue 2" in wrapper._unsupported()
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
            launch()


def test_siren_d_pad_follows_nerf_tpu():
    """nerf_tpu pads the SIREN's direction encoding to a multiple of 32
    columns (make_fused_siren_apply's d_pad): L_d = 4 gives 32, 5 to 10 give
    64, 11 gives 96; the packing pads wr0d to it with zero rows."""
    assert [siren_plan.d_pad(ld) for ld in (0, 4, 5, 6, 10, 11)] == [32, 32, 64, 64, 64, 96]
    packed = fused_render_siren.pack_params(SirenModel(hidden_dim=512, dir_encoding_dim=6))
    assert packed.mats["wr0d"].shape == (64, 256) and packed.mats["wr0f"].shape == (512, 256)
    with torch.no_grad():
        assert float(packed.mats["wr0d"][39:].abs().max()) == 0.0
    assert fused_siren.input_transposes(packed).numel() == 256 * 128


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_siren_wrappers_count_launches_by_shape(cdt):
    """Each count of the SIREN wrappers also goes to ``shape_launches`` under
    (counter, plan tag, dtype): the split by shape that phase 36 of
    chip_smoke.py reads."""
    model = SirenModel(hidden_dim=1024, compute_dtype=cdt)
    for cls, wrapper, counters in (
            (FusedSirenRender, FusedSirenRender(model, 2.0, 6.0),
             ("launches", "train_launches", "bwd_launches")),
            (fused_siren.SirenField, fused_siren.SirenField(model),
             ("launches", "bwd_launches"))):
        for counter in counters:
            key = (counter, "h1024d32", cdt)
            before = (getattr(cls, counter), cls.shape_launches[key])
            wrapper._count(counter)
            assert (getattr(cls, counter), cls.shape_launches[key]) == (
                before[0] + 1, before[1] + 1)


# ---------------------------------------------------------------- GaborNet plan


def _gabor_defines(pl) -> dict:
    return {**_siren_defines(pl), "GABOR_NL": pl.n}


@pytest.mark.parametrize("h, dp, n", list(itertools.product(
    gabor_plan.WIDTHS, gabor_plan.D_PADS, (1, 3, 8))))
def test_gabor_plan_fits_shared_memory(h, dp, n):
    """Every GaborNet kernel of the shape under 227 KB of shared memory,
    and each sum the sources' own (SMEM_BYTES, SMEM_GABOR_TC, SMEM_BWD, the
    stash bytes a point TC_BYTES_PER_POINT, the packed sizes N_W and N_B,
    evaluated from the headers under the shape's -D flags); stash rows
    16-byte aligned in both dtypes; the bf16 forward two CTAs an SM at
    hidden 256 (one tile) and one wider (two); chunks that divide each other
    and the backward's 32-point k-tiles; the NeRF family's chunk rule; the
    depth as -DGABOR_NL; at hidden 1024 with 8 stages 56,448 stash bytes a
    point."""
    pl = gabor_plan.plan(h, dp, n)
    assert max(pl.smem().values()) <= nerf_plan.SMEM_LIMIT
    src = _source_consts(_gabor_defines(pl), "gabor")
    assert (src["H"], src["DP"], src["P"], src["TC_P"], src["TC_PB"], src["NL"]) == (
        h, dp, pl.p, pl.tc_p, pl.tc_pb, n)
    assert pl.smem() == {"f32": src["SMEM_BYTES"], "fwd_tc": src["SMEM_GABOR_TC"],
                         "bwd_tc": src["SMEM_BWD"]}
    assert pl.tc_bytes_per_point == src["TC_BYTES_PER_POINT"]
    assert (pl.n_w, pl.n_b) == (src["N_W"], src["N_B"])
    assert src["ONE_TILE"] == pl.one_tile == (h == 256)
    assert pl.tc_bytes_per_point % 16 == 0
    assert pl.f32_floats_per_point(2) % 4 == 0 and pl.f32_floats_per_point(4) % 4 == 0
    assert pl.fwd_ctas_per_sm == (2 if h == 256 else 1)
    assert pl.tc_p % pl.tc_pb == 0 and pl.tc_p % 32 == 0 and pl.tc_pb % 16 == 0
    np_ = nerf_plan.plan(h, 64, dp)
    assert (pl.p, pl.tc_p, pl.tc_pb) == (np_.p, np_.tc_p, np_.tc_pb)
    assert pl.default == ((h, dp, n) == (256, 32, 8)) and (pl.defines == ()) == pl.default
    assert pl.tag == f"h{h}d{dp}n{n}"
    assert pl.default or pl.defines[-1] == f"-DGABOR_NL={n}"
    assert [b[0] for b in pl.builds] == list(gabor_plan.LIBS)
    assert set(gabor_plan.LIBS) <= set(build.LIBS)
    if pl.default:
        # the hidden-256 kernels: 14,208 stash bytes a point
        # (fused_render_gabor_train_tc.cu), 4,816 floats (fused_render_gabor_train.cu)
        assert (pl.tc_bytes_per_point, 4 * pl.f32_floats_per_point(2)) == (
            14_208, GABOR_F32_STASH_BYTES)
        assert pl.tc_bytes_per_point == fused_render_gabor.TC_BYTES_PER_POINT
        assert fused_gabor.TC_BWD_COLS_AT == pl.tc_bytes_per_point // 4 - 16
    if (h, dp, n) == (1024, 32, 8):
        assert pl.tc_bytes_per_point == 56_448


def test_gabor_stash_and_partials_fit_the_card(monkeypatch):
    """The bf16 GaborNet train pass at hidden 1024 with 8 stages, at
    lego_siren.txt's step (1024 rays x 256 samples on 132 SMs): 262,144
    stashed points of 56,448 bytes (14.8 GB) and 128 partials of the
    gradients (4.6 GB), which an 80 GB card holds; at 64 stages (nerf_tpu
    takes any depth) they outgrow it, and the launch raises before it
    allocates."""
    class Card:
        multi_processor_count = 132
        total_memory = 80 * 10 ** 9

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Card)
    t = torch.zeros(1024, 256)
    for n, fits in ((8, True), (64, False)):
        fr = FusedGaborRender(GaborModel(hidden_dim=1024, num_layers=n,
                                         compute_dtype="bfloat16"), 2.0, 6.0)
        sizes = (fr.plan.tc_bytes_per_point, (fr.plan.n_w + fr.plan.n_b + 1 + 3) // 4 * 4, 0)
        _, grid, cap = launch_plan(1024, 256, 132)
        if n == 8:
            assert grid * cap * sizes[0] == 14_797_504_512
            assert grid * sizes[1] * 4 == 4_578_875_392
        if fits:
            fr._check_fits(t, sizes, 1)
        else:
            with pytest.raises(RuntimeError, match="fewer rays a step"):
                fr._check_fits(t, sizes, 1)


@pytest.mark.parametrize("h, ld, n", [(1280, 4, 8), (512, 11, 8), (384, 4, 8),
                                      (1024, 4, 2046), (256, 4, 0)])
def test_gabor_plan_refuses_other_shapes(h, ld, n):
    """Hidden 1280 (nerf_tpu's kernels take it), a direction encoding padded
    to 96 columns (L_d = 11), a width that is no multiple of 256, a depth
    whose packed offsets leave a 32-bit int, no stage: no plan, and the
    wrappers refuse at the launch's check, naming ROADMAP.md's queue 2."""
    dp = gabor_plan.d_pad(ld)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        gabor_plan.plan(h, dp, n)
    assert gabor_plan.covered(1024, 32, 2045) and gabor_plan.covered(256, 32, 1)
    if n in (0, 2046):
        return
    model = GaborModel(hidden_dim=h, dir_encoding_dim=ld, num_layers=n)
    fr, field = FusedGaborRender(model, 2.0, 6.0), fused_gabor.GaborField(model)
    x, t = torch.zeros(2, 3), torch.zeros(2, 4)
    for wrapper, launch in ((fr, lambda: fr._launch_fwd(None, None, x, t)),
                            (field, lambda: field._launch_fwd(None, x, x))):
        assert not wrapper.supported() and wrapper.plan is None
        assert "ROADMAP.md queue 2" in wrapper._unsupported()
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
            launch()


def test_gabor_d_pad_and_depth_follow_nerf_tpu():
    """nerf_tpu pads the GaborNet's direction encoding as the SIREN's (L_d =
    4 gives 32 columns, 6 gives 64) and packs w1..w{n-1}: the port's packing
    pads wr0d to d_pad with zero rows, holds n - 1 hidden matrices, and the
    tensor-core backward's direction product is wr0d^T at hidden / 2 rows
    by 128."""
    model = GaborModel(hidden_dim=512, dir_encoding_dim=6, num_layers=3)
    fr = FusedGaborRender(model, 2.0, 6.0)
    assert fr.plan.tag == "h512d64n3"
    packed = fr.pack(model).packed
    assert packed.mats["wr0d"].shape == (64, 256) and packed.mats["wr0f"].shape == (512, 256)
    assert [k for k in packed.mats if k.startswith("w") and k[1:].isdigit()] == ["w1", "w2"]
    assert (packed.wmat.numel(), packed.vec.numel()) == (fr.plan.n_w, fr.plan.n_b)
    with torch.no_grad():
        assert float(packed.mats["wr0d"][39:].abs().max()) == 0.0
    assert fused_gabor.direction_transpose(packed).shape == (256, 128)
    one = FusedGaborRender(GaborModel(hidden_dim=256, num_layers=1), 2.0, 6.0)
    assert one.plan.tag == "h256d32n1" and one.mat_names == ("wre", "wr0f", "wr0d", "wr1")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_gabor_wrappers_count_launches_by_shape(cdt):
    """Each count of the GaborNet wrappers also goes to ``shape_launches``
    under (counter, plan tag, dtype): the split by shape that phase 37 of
    chip_smoke.py reads."""
    model = GaborModel(hidden_dim=1024, compute_dtype=cdt)
    for cls, wrapper, counters in (
            (FusedGaborRender, FusedGaborRender(model, 2.0, 6.0),
             ("launches", "train_launches")),
            (fused_gabor.GaborField, fused_gabor.GaborField(model),
             ("launches", "bwd_launches"))):
        for counter in counters:
            key = (counter, "h1024d32n8", cdt)
            before = (getattr(cls, counter), cls.shape_launches[key])
            wrapper._count(counter)
            assert (getattr(cls, counter), cls.shape_launches[key]) == (
                before[0] + 1, before[1] + 1)
