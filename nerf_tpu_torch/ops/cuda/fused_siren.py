"""SIREN field evaluation and its vector-Jacobian product in CUDA kernels.

Two kernels, each replacing one of ``nerf_tpu/ops/pallas/fused_siren.py``
(their sources say what bounds each on an H100 and how the design answers):

  * ``csrc/fused_siren_fwd.cu`` (``_fwd_kernel``): the 8-layer sine MLP of
    given points and directions, rgb and sigma out;
  * ``csrc/fused_siren_bwd.cu`` (``_bwd_kernel``): from the (rgb, sigma)
    cotangent, the 25 float32 weight and bias gradients (per-CTA partials
    added in order, no atomics) and the point and direction cotangents.

Both run the SIREN render kernels' chain and backward
(``csrc/fused_render_siren_common.cuh``) on the packed layout of
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
    kernels (hidden 256) or a raise, never one for the other;
    differentiable under autograd through the backward kernel;
    ``launches`` and ``bwd_launches`` count the kernels' launches over all
    instances.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.field import FusedField
from nerf_tpu_torch.ops.cuda.fused_nerf import _encode_bwd
from nerf_tpu_torch.ops.cuda.fused_render import DP, Packed, _encode, grad_sizes
from nerf_tpu_torch.ops.cuda.fused_render_siren import (
    _MATS,
    NUM_LAYERS,
    SirenConsts,
    cast_packed,
    mlp_acts,
    mlp_bwd,
    pack_f32,
)

HIDDEN = 256      # the width the kernels take


# ---------------------------------------------------------------- plain


def _acts(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
          k: SirenConsts) -> dict:
    """Every activation of the kernels' forward of points (n, 3) and
    directions (n, 3): the direction encoding through the exact sine, then
    the chain (``fused_render_siren.py::mlp_acts``)."""
    return mlp_acts(packed, pts, _encode(dirs, k.dir_freqs, DP, torch.sin), k)


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


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = library(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "fused_siren_fwd":
        lib.siren_field_fwd.argtypes = [vp] * 4 + [ci] * 5 + [cf] * 4 + [vp] * 3
        lib.siren_field_fwd.restype = ci
        lib.siren_field_fwd_error.argtypes = [ci]
        lib.siren_field_fwd_error.restype = ctypes.c_char_p
    else:
        lib.siren_field_bwd.argtypes = [vp] * 6 + [ci] * 7 + [cf] * 4 + [vp] * 6
        lib.siren_field_bwd.restype = ci
        lib.siren_field_bwd_error.argtypes = [ci]
        lib.siren_field_bwd_error.restype = ctypes.c_char_p
        lib.siren_field_bwd_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        lib.siren_field_bwd_sizes.restype = None
    return lib


# ---------------------------------------------------------------- wrapper


class SirenField(FusedField):
    """The field ``(points (..., 3), dirs (..., 3)) -> (rgb (..., 3), sigma
    (...,))`` of a SIREN through the field kernels (the counterpart of
    ``make_fused_siren_apply``'s ``apply``), with ``FusedField``'s
    contract: ``packed`` a ``cast_packed`` packing or None."""

    launches = 0
    bwd_launches = 0
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

    def params_f32(self) -> tuple:
        return pack_f32(self.model)

    def cast(self, wflat: torch.Tensor, vec: torch.Tensor) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h)

    def supported(self) -> bool:
        """The shapes the kernels cover: hidden 256 (as the render kernels)
        and a direction encoding of at most 32 columns. (The TPU kernels
        also take hidden 512; the port does not yet.)"""
        return self.h == HIDDEN and self.real_d <= DP

    def _unsupported(self) -> str:
        return (f"the SIREN field kernels cover hidden {HIDDEN} with a direction "
                f"encoding of at most {DP} columns; got hidden {self.h}, "
                f"{self.real_d} columns (hidden 512 is ROADMAP.md queue 2; run on "
                "the CPU, or with use_pallas = false)")

    def _plain_forward(self, packed: Packed, pts, dirs):
        return siren_field_plain(packed, pts, dirs, self.consts)

    def _plain_backward(self, packed: Packed, pts, dirs, cot):
        return siren_field_bwd_plain(packed, pts, dirs, cot, self.consts)

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
        lib = _library("fused_siren_fwd")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.siren_field_fwd(
                pts.data_ptr(), dirs.data_ptr(), packed.wmat.data_ptr(),
                packed.vec.data_ptr(), packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), n, self.real_d, k.w0, k.hidden_w0,
                k.sigma_mul, k.rgb_mul, rgb.data_ptr(), sigma.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("SIREN field forward kernel: "
                               + lib.siren_field_fwd_error(code).decode())
        type(self).launches += 1
        return rgb, sigma

    def _launch_bwd(self, packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                    cot: torch.Tensor):
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
        lib = _library("fused_siren_bwd")
        per_point, npart, n_out = grad_sizes(lib.siren_field_bwd_sizes)
        run, grid = self._runs(n, dev)
        wmat_t = torch.cat([packed.mats[m].t().reshape(-1) for m in _MATS])
        scratch = torch.empty(grid * run * per_point, dtype=torch.float32, device=dev)
        partial = torch.empty(grid * npart, dtype=torch.float32, device=dev)
        out = torch.empty(n_out, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.siren_field_bwd(
                pts.data_ptr(), dirs.data_ptr(), cot.data_ptr(), packed.wmat.data_ptr(),
                wmat_t.data_ptr(), packed.vec.data_ptr(), n_w, n_b,
                int(self.cdt == torch.bfloat16), n, run, run, self.real_d, k.w0,
                k.hidden_w0, k.sigma_mul, k.rgb_mul, scratch.data_ptr(),
                partial.data_ptr(), out.data_ptr(), dpts.data_ptr(), ddirs.data_ptr(),
                stream)
        if code != 0:
            raise RuntimeError("SIREN field backward kernel: "
                               + lib.siren_field_bwd_error(code).decode())
        type(self).bwd_launches += 1
        return out[:n_w], out[n_w:n_w + n_b], dpts, ddirs
