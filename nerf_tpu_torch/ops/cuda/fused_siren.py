"""SIREN field evaluation and its vector-Jacobian product in CUDA kernels.

Two kernels, each replacing one of ``nerf_tpu/ops/pallas/fused_siren.py``
(their sources say what bounds each on an H100 and how the design answers):

  * ``csrc/fused_siren_fwd.cu`` (``_fwd_kernel``): the 8-layer sine MLP of
    given points and directions, rgb and sigma out; in bfloat16 on the
    tensor cores, ``csrc/fused_siren_fwd_tc.cu`` (the SIREN forward render's
    chain, ``csrc/fused_render_siren_tc_common.cuh``);
  * ``csrc/fused_siren_bwd.cu`` (``_bwd_kernel``): from the (rgb, sigma)
    cotangent, the 25 float32 weight and bias gradients (per-CTA partials
    added in order, no atomics) and the point and direction cotangents; in
    bfloat16 on the tensor cores, ``csrc/fused_siren_bwd_tc.cu`` (the SIREN
    train pass's split: a forward kernel on the forward's own chain that
    stashes, then the train pass's backward with the two input products).

Both run the SIREN render kernels' chain and backward
(``csrc/fused_render_siren_common.cuh``; in bfloat16 the tensor-core ones,
``csrc/fused_render_siren_tc_common.cuh``) on the packed layout of
``fused_render_siren.py::pack_f32`` / ``cast_packed`` (``nerf_tpu``'s
``pack_params`` order), so ``models/convert.py::load_jax_params`` carries
JAX weights across unchanged. This module holds

  * the plain PyTorch versions ``siren_field_plain`` and
    ``siren_field_bwd_plain``, with the kernels' arithmetic and rounding
    (``fused_siren.py``'s): the points rounded to the compute dtype before
    layer 1, the direction encoding through the EXACT sine in both modes,
    the layers through the degree-11 sine in bfloat16, matmul inputs
    rounded to the compute dtype, float32 sums, the density from the
    unrounded h8, the backward's layer inputs as the forward's (sin(w0 z)
    of the same pre-activations), and the direction encoding's backward
    through the exact cosine;
  * ``SirenField``: the field ``(points, dirs) -> (rgb, sigma)`` of one
    ``SirenModel`` (8 layers), with the contract of ``field.py::
    FusedField``: on CPU tensors the plain versions, on CUDA tensors the
    kernels (hidden 256 to 1024 with d_pad 32 or 64, ``siren_plan.py``; each
    shape its own build) or a raise, never one for the other;
    differentiable under autograd through the backward kernel;
    ``launches`` and ``bwd_launches`` count the kernels' launches over all
    instances, ``shape_launches`` by shape.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.field import FusedField
from nerf_tpu_torch.ops.cuda.fused_nerf import NI, _encode_bwd
from nerf_tpu_torch.ops.cuda.fused_render import Packed, _encode
from nerf_tpu_torch.ops.cuda.fused_render_siren import (
    _MATS,
    NUM_LAYERS,
    TC_BYTES_PER_POINT,
    SirenConsts,
    cast_packed,
    mlp_acts,
    mlp_bwd,
    pack_f32,
)
from nerf_tpu_torch.ops.cuda.siren_plan import SirenPlan, covered, d_pad, plan

# the bfloat16 backward's stash a point at hidden 256
# (csrc/fused_siren_bwd_tc.cu): the SIREN train pass's, its 16 per-point
# float32 columns last; TC_BWD_COLS_AT floats of a row precede the columns
TC_BWD_BYTES_PER_POINT = TC_BYTES_PER_POINT
TC_BWD_COLS_AT = TC_BYTES_PER_POINT // 4 - 16


# ---------------------------------------------------------------- plain


def _acts(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
          k: SirenConsts) -> dict:
    """Every activation of the kernels' forward of points (n, 3) and
    directions (n, 3): the direction encoding through the exact sine
    (``packed``'s d_pad columns), then the chain
    (``fused_render_siren.py::mlp_acts``)."""
    denc = _encode(dirs, k.dir_freqs, packed.mats["wr0d"].shape[0], torch.sin)
    return mlp_acts(packed, pts, denc, k)


def siren_field_plain(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                      k: SirenConsts):
    """The forward kernel's function in plain PyTorch: ``(rgb (n, 3), sigma
    (n,))``, float32."""
    a = _acts(packed, pts, dirs, k)
    return a["rgb"], torch.relu(a["sigma_pre"]) * k.sigma_mul


def siren_field_bwd_plain(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                          cot: torch.Tensor, k: SirenConsts):
    """The backward kernel's function in plain PyTorch: ``(gw, gv, dpts,
    ddirs)``, the flat float32 gradients of sum(cot * [rgb, sigma]) in the
    packed layout and the point and direction cotangents; ``cot`` is (n,
    4)."""
    a = _acts(packed, pts, dirs, k)
    rgb = a["rgb"]
    dzr1 = ((cot[:, :3] * rgb) * (1.0 - rgb)) * k.rgb_mul
    dsig = torch.where(a["sigma_pre"] > 0, cot[:, 3] * k.sigma_mul,
                       torch.zeros_like(cot[:, 3]))
    gw, gv, dpts, ddenc = mlp_bwd(packed, a, dzr1, dsig, k, inputs=True)
    return gw, gv, dpts, _encode_bwd(ddenc, dirs, k.dir_freqs)


# ---------------------------------------------------------------- libraries


# each library -> its C entry point (the two forwards take the same
# arguments; the tensor-core backward adds the input-product matrix)
_FWD_ENTRY = {"fused_siren_fwd": "siren_field_fwd",
              "fused_siren_fwd_tc": "siren_field_fwd_tc"}
_BWD_ENTRY = {"fused_siren_bwd": "siren_field_bwd",
              "fused_siren_bwd_tc": "siren_field_bwd_tc"}


@functools.cache
def _library(name: str, shape: SirenPlan | None = None) -> ctypes.CDLL:
    """The library ``name`` with its C signatures declared, at the default
    shape or at the SIREN plan ``shape``'s (built on first use)."""
    lib = library(name) if shape is None else library(name, shape.tag, shape.defines)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry = {**_FWD_ENTRY, **_BWD_ENTRY}[name]
    fn, err = getattr(lib, entry), getattr(lib, entry + "_error")
    if name in _FWD_ENTRY:
        fn.argtypes = [vp] * 4 + [ci] * 5 + [cf] * 4 + [vp] * 3
    elif name == "fused_siren_bwd":
        fn.argtypes = [vp] * 6 + [ci] * 7 + [cf] * 4 + [vp] * 6
    else:
        fn.argtypes = [vp] * 7 + [ci] * 8 + [cf] * 4 + [vp] * 6
    fn.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    if name in _BWD_ENTRY:
        sizes = getattr(lib, entry + "_sizes")
        sizes.argtypes = [ctypes.POINTER(ci)] * (4 if name.endswith("_tc") else 3)
        sizes.restype = None
    return lib


def input_transposes(packed: Packed) -> torch.Tensor:
    """The tensor-core backward's input-product matrix in the compute
    dtype: wr0d^T (hidden / 2 rows) zero-padded to NI columns, built once a
    packing (the point cotangent's dz1 w1^T runs on the CUDA cores from the
    packed w1)."""
    if "input_t" not in packed.derived:
        w = packed.mats["wr0d"]
        packed.derived["input_t"] = F.pad(w.t(), (0, NI - w.shape[0])).reshape(-1)
    return packed.derived["input_t"]


# ---------------------------------------------------------------- wrapper


class SirenField(FusedField):
    """The field ``(points (..., 3), dirs (..., 3)) -> (rgb (..., 3), sigma
    (...,))`` of a SIREN through the field kernels (the counterpart of
    ``make_fused_siren_apply``'s ``apply``), with ``FusedField``'s
    contract: ``packed`` a ``cast_packed`` packing or None."""

    launches = 0
    bwd_launches = 0
    shape_launches: collections.Counter = collections.Counter()
    family = "SIREN"

    def __init__(self, model, packed: Packed | None = None):
        if model.num_layers != NUM_LAYERS:
            # the packed layout itself has 8 sine layers (as the TPU kernels')
            raise NotImplementedError(
                f"the SIREN field takes {NUM_LAYERS} sine layers, not "
                f"{model.num_layers} (as nerf_tpu's; evaluate the module)")
        super().__init__(model, packed)
        self.consts = SirenConsts.of(model)
        self.real_d = 3 * (1 + 2 * self.consts.dir_freqs)
        self.d_pad = d_pad(self.consts.dir_freqs)
        # the kernels' plan at this shape, None outside the shapes they take
        self.plan = plan(self.h, self.d_pad) if covered(self.h, self.d_pad) else None

    def params_f32(self) -> tuple:
        return pack_f32(self.model)

    def cast(self, wflat: torch.Tensor, vec: torch.Tensor) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h, self.d_pad)

    def supported(self) -> bool:
        """The shapes the kernels cover (``siren_plan.covered``, as the
        render kernels): hidden 256, 512, 768 or 1024 with the direction
        encoding padded to at most 64 columns."""
        return self.plan is not None

    def _unsupported(self) -> str:
        return (f"the SIREN field kernels cover hidden 256 to 1024 with the direction "
                f"encoding padded to at most 64 columns; got hidden {self.h}, "
                f"{self.real_d} columns (ROADMAP.md queue 2; run on the CPU, or with "
                "use_pallas = false)")

    def _plain_forward(self, packed: Packed, pts, dirs):
        return siren_field_plain(packed, pts, dirs, self.consts)

    def _plain_backward(self, packed: Packed, pts, dirs, cot):
        return siren_field_bwd_plain(packed, pts, dirs, cot, self.consts)

    def fwd_library(self) -> str:
        """The forward's kernel library: bfloat16 on the tensor cores,
        float32 on the CUDA cores."""
        return "fused_siren_fwd_tc" if self.cdt == torch.bfloat16 else "fused_siren_fwd"

    def bwd_library(self) -> str:
        """The backward's kernel library: bfloat16 on the tensor cores,
        float32 on the CUDA cores."""
        return "fused_siren_bwd_tc" if self.cdt == torch.bfloat16 else "fused_siren_bwd"

    def _bwd_entry(self):
        """(function, error string, sizes) of the backward."""
        name = self.bwd_library()
        lib, entry = _library(name, self.plan), _BWD_ENTRY[name]
        return tuple(getattr(lib, entry + s) for s in ("", "_error", "_sizes"))

    def _fwd_entry(self):
        """(function, error string) of the forward."""
        name = self.fwd_library()
        lib, entry = _library(name, self.plan), _FWD_ENTRY[name]
        return getattr(lib, entry), getattr(lib, entry + "_error")

    def _launch_fwd(self, packed: Packed, pts: torch.Tensor, dirs: torch.Tensor):
        self._check(packed, pts, dirs)
        n = pts.shape[0]
        dev = pts.device
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        sigma = torch.empty((n,), dtype=torch.float32, device=dev)
        if n == 0:
            return rgb, sigma
        pts, dirs = pts.contiguous(), dirs.contiguous()
        k = self.consts
        fn, err = self._fwd_entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                pts.data_ptr(), dirs.data_ptr(), packed.wmat.data_ptr(),
                packed.vec.data_ptr(), packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), n, self.real_d, k.w0, k.hidden_w0,
                k.sigma_mul, k.rgb_mul, rgb.data_ptr(), sigma.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("SIREN field forward kernel: " + err(code).decode())
        self._count("launches")
        return rgb, sigma

    def _launch_bwd(self, packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                    cot: torch.Tensor, run: int | None = None, stash: dict | None = None):
        self._check(packed, pts, dirs, cot)
        n = pts.shape[0]
        dev = pts.device
        dpts = torch.empty((n, 3), dtype=torch.float32, device=dev)
        ddirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
        n_w, n_b = packed.wmat.numel(), packed.vec.numel()
        if n == 0:
            return (torch.zeros(n_w, device=dev), torch.zeros(n_b, device=dev),
                    dpts, ddirs)
        pts, dirs, cot = pts.contiguous(), dirs.contiguous(), cot.contiguous()
        k = self.consts
        fn, err, sizes = self._bwd_entry()
        tc = self.bwd_library().endswith("_tc")
        vals = [ctypes.c_int() for _ in range(4 if tc else 3)]
        sizes(*(ctypes.byref(v) for v in vals))
        per_point, npart, n_out = (v.value for v in vals[:3])
        run, grid = self._bwd_plan(n, dev, run)
        # the arguments between the packed W and the dtype flag: the
        # tensor-core entry's (wmat_t, not read: its products read the
        # packed W itself; wt_in; vec; n_w; n_b; n_t), the CUDA-core one's
        # (wmat_t, vec, n_w, n_b)
        if tc:
            wt_in = input_transposes(packed)
            if wt_in.numel() != vals[3].value:
                raise ValueError(f"input transposes: {wt_in.numel()} values, want "
                                 f"{vals[3].value}")
            mid = (None, wt_in.data_ptr(), packed.vec.data_ptr(), n_w, n_b, wt_in.numel())
        else:
            wmat_t = torch.cat([packed.mats[m].t().reshape(-1) for m in _MATS])
            mid = (wmat_t.data_ptr(), packed.vec.data_ptr(), n_w, n_b)
        scratch = torch.empty(grid * run * per_point, dtype=torch.float32, device=dev)
        partial = torch.empty(grid * npart, dtype=torch.float32, device=dev)
        out = torch.empty(n_out, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                pts.data_ptr(), dirs.data_ptr(), cot.data_ptr(), packed.wmat.data_ptr(),
                *mid, int(self.cdt == torch.bfloat16), n, run, run, self.real_d, k.w0,
                k.hidden_w0, k.sigma_mul, k.rgb_mul, scratch.data_ptr(),
                partial.data_ptr(), out.data_ptr(), dpts.data_ptr(), ddirs.data_ptr(),
                stream)
        if code != 0:
            raise RuntimeError("SIREN field backward kernel: " + err(code).decode())
        self._count("bwd_launches")
        if stash is not None:
            stash.update(scratch=scratch, run=run, grid=grid, per_point=per_point)
        return out[:n_w], out[n_w:n_w + n_b], dpts, ddirs
