"""NeRF field evaluation and its vector-Jacobian product in CUDA kernels.

Two kernels, each replacing one of ``nerf_tpu/ops/pallas/fused_nerf.py``
(their sources say what bounds each on an H100 and how the design answers):

  * ``csrc/fused_nerf_fwd.cu`` (``_fwd_kernel``): positional and direction
    encoding and the NeRF MLP of given points, rgb and sigma out; in
    bfloat16 on the tensor cores, ``csrc/fused_nerf_fwd_tc.cu`` (the NeRF
    forward render's chain, ``csrc/fused_render_tc_common.cuh``);
  * ``csrc/fused_nerf_bwd.cu`` (``_bwd_kernel``): from the (rgb, sigma)
    cotangent, the 28 float32 weight and bias gradients (per-CTA partials
    added in order, no atomics) and the point and direction cotangents; in
    bfloat16 on the tensor cores, ``csrc/fused_nerf_bwd_tc.cu`` (the NeRF
    train pass's split: a forward kernel on the forward's own chain that
    stashes, then the train pass's backward with the three input products).

Both run the MLP chain of the NeRF render kernels
(``csrc/fused_render_common.cuh``; in bfloat16 the tensor-core one,
``csrc/fused_render_tc_common.cuh``) on the packed layout of
``fused_render.py::pack_f32`` / ``cast_packed`` (``nerf_tpu``'s
``pack_params`` order), so ``models/convert.py::load_jax_params`` carries
JAX weights across unchanged. This module holds

  * the plain PyTorch versions ``nerf_field_plain`` and
    ``nerf_field_bwd_plain``, with the kernels' arithmetic and rounding:
    both encodings through the degree-11 sine in bfloat16 (the exact sine in
    float32), matmul inputs rounded to the compute dtype, float32 sums, the
    density from the unrounded h9, and the encodings' backward through the
    exact cosine in both modes. They are not the module's path, which
    rounds elsewhere (``models/nerf.py``);
  * ``NerfField``: the field ``(points, dirs) -> (rgb, sigma)`` of one
    ``NeRFModel``, with the contract of ``field.py::FusedField``: on CPU
    tensors the plain versions, on CUDA tensors the kernels or a raise,
    never one for the other; differentiable under autograd through the
    backward kernel; ``launches`` and ``bwd_launches`` count the kernels'
    launches over all instances, and ``shape_launches`` splits them by
    shape: ``(counter, plan tag, compute dtype)`` -> launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.field import FusedField
from nerf_tpu_torch.ops.cuda.fused_render import (
    PP,
    TC_BYTES_PER_POINT,
    Packed,
    _HALF_PI,
    _MATS,
    _encode,
    cast_packed,
    fast_sin,
    mlp_acts,
    mlp_bwd,
    pack_f32,
    packed_pads,
)
from nerf_tpu_torch.ops.cuda.nerf_plan import NerfPlan, covered, enc_pads, plan

NI = 128          # columns of the backward's input-product matrices (>= any pad)
# the bfloat16 backward's stash a point at hidden 256 (csrc/fused_nerf_bwd_tc.cu):
# the NeRF train pass's (its 12 per-point float32 columns last), then dz6
# w6p^T (PP float32 columns); TC_BWD_COLS_AT floats of a row precede the
# columns
TC_BWD_BYTES_PER_POINT = plan(256, PP, 32).field_tc_bytes_per_point
TC_BWD_COLS_AT = TC_BYTES_PER_POINT // 4 - 12


# ---------------------------------------------------------------- plain


def _acts(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor, pos_freqs: int,
          dir_freqs: int, sums: torch.dtype = torch.float32) -> dict:
    """Every activation of the kernels' forward of points (n, 3) and
    directions (n, 3): both encodings through the kernels' sine, rounded to
    the compute dtype, then the MLP (``fused_render.py::mlp_acts``, its
    sums in ``sums``)."""
    sin = fast_sin if packed.cdt == torch.bfloat16 else torch.sin
    pp, dp = packed_pads(packed)
    penc = round_to(_encode(pts, pos_freqs, pp, sin), packed.cdt)
    denc = round_to(_encode(dirs, dir_freqs, dp, sin), packed.cdt)
    return mlp_acts(packed, penc.to(sums), denc.to(sums))


def _encode_bwd(g: torch.Tensor, x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """The VJP of ``_encode`` at ``x`` (n, 3) for the cotangent ``g`` (n,
    width) of its columns (``fused_nerf.py::_encode_bwd``): the coordinates'
    own columns plus each sine column's cotangent times 2^j cos(2^j x +
    phase), the cosine exact."""
    out = g[:, :3]
    if num_freqs:
        freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
        phase = torch.tensor([0.0, _HALF_PI], dtype=x.dtype, device=x.device)
        arg = (x[:, None, :] * freqs[:, None])[:, :, None, :] + phase[:, None]
        gc = g[:, 3:3 + 6 * num_freqs].reshape(-1, num_freqs, 2, 3)
        out = out + torch.sum(gc * torch.cos(arg) * freqs[:, None, None], dim=(1, 2))
    return out


def nerf_field_plain(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                     pos_freqs: int, dir_freqs: int):
    """The forward kernel's function in plain PyTorch: ``(rgb (n, 3), sigma
    (n,))``, float32."""
    a = _acts(packed, pts, dirs, pos_freqs, dir_freqs)
    return a["rgb"], torch.relu(a["sigma_pre"])


def nerf_field_bwd_plain(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                         cot: torch.Tensor, pos_freqs: int, dir_freqs: int,
                         sums: torch.dtype = torch.float32):
    """The backward kernel's function in plain PyTorch: ``(gw, gv, dpts,
    ddirs)``, the flat float32 gradients of sum(cot * [rgb, sigma]) in the
    packed layout and the point and direction cotangents; ``cot`` is (n,
    4). ``sums`` float64 keeps the encodings and every rounding point and
    takes every product and sum after them in float64: a reference for
    what a float32 sum in another order does to the bfloat16 roundings."""
    a = _acts(packed, pts, dirs, pos_freqs, dir_freqs, sums)
    rgb = a["rgb"]
    cot, pts, dirs = cot.to(sums), pts.to(sums), dirs.to(sums)
    dzr1 = cot[:, :3] * rgb * (1.0 - rgb)
    dsig = torch.where(a["sigma_pre"] > 0, cot[:, 3], torch.zeros_like(cot[:, 3]))
    gw, gv, dpenc, ddenc = mlp_bwd(packed, a, dzr1, dsig, inputs=True)
    return (gw, gv, _encode_bwd(dpenc, pts, pos_freqs).float(),
            _encode_bwd(ddenc, dirs, dir_freqs).float())


# ---------------------------------------------------------------- libraries


# the forward's and the backward's libraries; each names its C entry point
# after itself (the two of a direction take the same arguments)
_FWD_LIBS = ("fused_nerf_fwd", "fused_nerf_fwd_tc")


@functools.cache
def _library(name: str, shape: NerfPlan | None = None) -> ctypes.CDLL:
    """The library ``name`` with its C signatures declared, at the default
    shape or at the plan ``shape``'s (built on first use)."""
    lib = library(name) if shape is None else library(name, shape.tag, shape.defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn, err = getattr(lib, name), getattr(lib, name + "_error")
    if name in _FWD_LIBS:
        fn.argtypes = [vp] * 4 + [ci] * 6 + [vp] * 3
    else:
        fn.argtypes = [vp] * 7 + [ci] * 9 + [vp] * 6
        sizes = getattr(lib, name + "_sizes")
        sizes.argtypes = [ctypes.POINTER(ci)] * 4
        sizes.restype = None
    fn.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return lib


def input_transposes(packed: Packed) -> torch.Tensor:
    """The backward kernels' input-product matrices in the compute dtype:
    w1^T and w6p^T (hidden rows) and wr0d^T (hidden / 2 rows), each
    zero-padded to NI columns (``csrc/fused_render_common.cuh``'s OFF_T_*),
    built once a packing."""
    if "input_t" not in packed.derived:
        packed.derived["input_t"] = torch.cat(
            [F.pad(packed.mats[k].t(), (0, NI - packed.mats[k].shape[0])).reshape(-1)
             for k in ("w1", "w6p", "wr0d")])
    return packed.derived["input_t"]


# ---------------------------------------------------------------- wrapper


class NerfField(FusedField):
    """The field ``(points (..., 3), dirs (..., 3)) -> (rgb (..., 3), sigma
    (...,))`` of ``model`` through the field kernels (the counterpart of
    ``make_fused_nerf_apply``'s ``apply``), with ``FusedField``'s contract:
    ``packed`` a ``cast_packed`` packing or None."""

    launches = 0
    bwd_launches = 0
    shape_launches: collections.Counter = collections.Counter()
    family = "NeRF"

    def __init__(self, model: NeRFModel, packed: Packed | None = None):
        super().__init__(model, packed)
        self.pos_freqs = model.pos_encoding_dim
        self.dir_freqs = model.dir_encoding_dim
        self.real_p = 3 * (1 + 2 * self.pos_freqs)
        self.real_d = 3 * (1 + 2 * self.dir_freqs)
        self.pads = enc_pads(self.pos_freqs, self.dir_freqs)
        # the kernels' plan at this shape, None outside the shapes they take
        self.plan = plan(self.h, *self.pads) if covered(self.h, *self.pads) else None

    def params_f32(self) -> tuple:
        return pack_f32(self.model)

    def cast(self, wflat: torch.Tensor, vec: torch.Tensor) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h, self.pads)

    def supported(self) -> bool:
        """The shapes the kernels cover (``nerf_plan.covered``): hidden 256,
        512, 768 or 1024 with encodings padded to at most 128 / 64
        columns."""
        return self.plan is not None

    def _unsupported(self) -> str:
        return (f"the NeRF field kernels cover hidden 256 to 1024 with encodings "
                f"padded to at most 128/64 columns; got hidden {self.h}, {self.real_p}/"
                f"{self.real_d} (ROADMAP.md queue 2; run on the CPU, or with "
                "use_pallas = false)")

    def _plain_forward(self, packed: Packed, pts, dirs):
        return nerf_field_plain(packed, pts, dirs, self.pos_freqs, self.dir_freqs)

    def _plain_backward(self, packed: Packed, pts, dirs, cot):
        return nerf_field_bwd_plain(packed, pts, dirs, cot, self.pos_freqs,
                                    self.dir_freqs)

    def fwd_library(self) -> str:
        """The forward's kernel library: bfloat16 on the tensor cores,
        float32 on the CUDA cores."""
        return "fused_nerf_fwd_tc" if self.cdt == torch.bfloat16 else "fused_nerf_fwd"

    def bwd_library(self) -> str:
        """The backward's kernel library: bfloat16 on the tensor cores,
        float32 on the CUDA cores."""
        return "fused_nerf_bwd_tc" if self.cdt == torch.bfloat16 else "fused_nerf_bwd"

    def _fwd_entry(self):
        """(function, error string) of the forward."""
        name = self.fwd_library()
        lib = _library(name, self.plan)
        return getattr(lib, name), getattr(lib, name + "_error")

    def _bwd_entry(self):
        """(function, error string, sizes) of the backward."""
        name = self.bwd_library()
        lib = _library(name, self.plan)
        return tuple(getattr(lib, name + s) for s in ("", "_error", "_sizes"))

    def _launch_fwd(self, packed: Packed, pts: torch.Tensor, dirs: torch.Tensor):
        n = pts.shape[0]
        self._check(packed, pts, dirs)
        dev = pts.device
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        sigma = torch.empty((n,), dtype=torch.float32, device=dev)
        if n == 0:
            return rgb, sigma
        pts, dirs = pts.contiguous(), dirs.contiguous()
        fn, err = self._fwd_entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                pts.data_ptr(), dirs.data_ptr(), packed.wmat.data_ptr(),
                packed.vec.data_ptr(), packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), n, self.real_p, self.real_d,
                rgb.data_ptr(), sigma.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("NeRF field forward kernel: " + err(code).decode())
        self._count("launches")
        return rgb, sigma

    def _launch_bwd(self, packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                    cot: torch.Tensor, run: int | None = None, stash: dict | None = None):
        n = pts.shape[0]
        self._check(packed, pts, dirs, cot)
        dev = pts.device
        dpts = torch.empty((n, 3), dtype=torch.float32, device=dev)
        ddirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
        n_w, n_b = packed.wmat.numel(), packed.vec.numel()
        if n == 0:
            return (torch.zeros(n_w, device=dev), torch.zeros(n_b, device=dev),
                    dpts, ddirs)
        pts, dirs, cot = pts.contiguous(), dirs.contiguous(), cot.contiguous()
        fn, err, sizes = self._bwd_entry()
        vals = [ctypes.c_int() for _ in range(4)]
        sizes(*(ctypes.byref(v) for v in vals))
        per_point, npart, n_out, n_t = (v.value for v in vals)
        run, grid = self._bwd_plan(n, dev, run)
        # the tensor-core products read the packed W itself
        wmat_t = (None if self.bwd_library().endswith("_tc") else
                  torch.cat([packed.mats[k].t().reshape(-1) for k in _MATS]))
        wt_in = input_transposes(packed)
        if wt_in.numel() != n_t:
            raise ValueError(f"input transposes: {wt_in.numel()} values, want {n_t}")
        scratch = torch.empty(grid * run * per_point, dtype=torch.float32, device=dev)
        partial = torch.empty(grid * npart, dtype=torch.float32, device=dev)
        out = torch.empty(n_out, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                pts.data_ptr(), dirs.data_ptr(), cot.data_ptr(), packed.wmat.data_ptr(),
                None if wmat_t is None else wmat_t.data_ptr(), wt_in.data_ptr(),
                packed.vec.data_ptr(), n_w, n_b,
                n_t, int(self.cdt == torch.bfloat16), n, run, run, self.real_p,
                self.real_d, scratch.data_ptr(), partial.data_ptr(), out.data_ptr(),
                dpts.data_ptr(), ddirs.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("NeRF field backward kernel: " + err(code).decode())
        self._count("bwd_launches")
        if stash is not None:
            stash.update(scratch=scratch, run=run, grid=grid, per_point=per_point)
        return out[:n_w], out[n_w:n_w + n_b], dpts, ddirs

