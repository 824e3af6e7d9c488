"""GaborNet field evaluation and its vector-Jacobian product in CUDA kernels.

Two kernels, each replacing one of ``nerf_tpu/ops/pallas/fused_gabor.py``
(their sources say what bounds each on an H100 and how the design answers):

  * ``csrc/fused_gabor_fwd.cu`` (``_fwd_kernel``): the filter banks
    evaluated at given points and the multiplicative filter network, rgb
    and sigma out;
  * ``csrc/fused_gabor_bwd.cu`` (``_bwd_kernel``): from the (rgb, sigma)
    cotangent, the 23 float32 weight and bias gradients, the gradients of
    every filter bank (per-CTA partials added in order, no atomics) and the
    point and direction cotangents.

Both run the GaborNet render kernels' network and backward
(``csrc/fused_render_gabor_common.cuh``) on the linear and head layout of
``fused_render_gabor.py::pack_f32`` / ``cast_packed``, with the filter
banks packed beside it (``pack_filters``): per stage omega (3 x h), phi,
mu^T (3 x h), |mu|^2 and gamma, float32, built with differentiable torch
ops as nerf_tpu's ``pack_params`` builds them, so that autograd maps the
kernel's d|mu|^2 back onto mu. The filters are evaluated in the kernels
from the points themselves, through the expansion q = |x|^2 - 2 x . mu +
|mu|^2 (not |x - mu|^2 as ``models/gabor.py`` computes it: q can fall below
zero by cancellation, and E = exp(-gamma q / 2) then exceeds 1, as on the
TPU). This module holds

  * ``pack_filters`` / ``filter_views``: the banks' layout;
  * the plain PyTorch versions ``gabor_field_plain`` and
    ``gabor_field_bwd_plain``, with the kernels' arithmetic and rounding
    (``fused_gabor.py``'s): the banks float32, the points rounded to the
    compute dtype inside the filters' products and |x|^2 from the unrounded
    points, the direction encoding through the exact sine, the filters'
    sines through the degree-11 sine in bfloat16, the network's matmul
    inputs rounded to the compute dtype with float32 sums, the density from
    the unrounded z8; in the backward both operands of the banks' x^T
    products rounded, and of the point cotangent's products only dsinarg
    and dq;
  * ``GaborField``: the field ``(points, dirs) -> (rgb, sigma)`` of one
    ``GaborModel``, with the contract of ``field.py::FusedField``: on CPU
    tensors the plain versions (any width and depth), on CUDA tensors the
    kernels (hidden 256, 8 stages) or a raise, never one for the other;
    differentiable under autograd through the backward kernel; ``launches``
    and ``bwd_launches`` count the kernels' launches over all instances.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.field import FusedField
from nerf_tpu_torch.ops.cuda.fused_nerf import _encode_bwd
from nerf_tpu_torch.ops.cuda.fused_render import (
    DP,
    Packed,
    _encode,
    grad_sizes,
    trig,
)
from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
    NUM_LAYERS,
    GaborConsts,
    _names,
    cast_packed,
    net_acts,
    net_bwd,
    pack_f32,
)

HIDDEN = 256      # the width the kernels take
BANK_ROWS = 9     # omega (3), phi, mu^T (3), |mu|^2, gamma: rows of h a stage


@dataclass(frozen=True)
class GaborFieldPack:
    """A GaborNet as the field kernels read it: the linear and head weights
    (``cast_packed``) and the filter banks (``pack_filters``, float32)."""

    packed: Packed
    filters: torch.Tensor


def pack_filters(model) -> torch.Tensor:
    """The filter banks of every stage, flat float32 (stage, row, h) with
    rows omega (3), phi, mu^T (3), |mu|^2 and gamma, differentiable in the
    filters' parameters."""
    banks = [torch.cat([f.omega, f.phi[None], f.mu.T,
                        torch.sum(f.mu ** 2, dim=-1)[None], f.gamma[None]])
             for f in model.filters]
    return torch.stack(banks).float().reshape(-1)


def filter_views(fpack: torch.Tensor, num_layers: int) -> list:
    """Per stage, the views ``om`` (3, h), ``ph`` (h,), ``muT`` (3, h),
    ``m2`` (h,) and ``gam`` (h,) of a flat bank packing (or of its
    gradient)."""
    v = fpack.view(num_layers, BANK_ROWS, -1)
    return [{"om": v[i, 0:3], "ph": v[i, 3], "muT": v[i, 4:7], "m2": v[i, 7],
             "gam": v[i, 8]} for i in range(num_layers)]


# ---------------------------------------------------------------- plain


def point_filters(fpack: torch.Tensor, pts: torch.Tensor, num_layers: int,
                  cdt: torch.dtype) -> list:
    """Per stage, ``(sinarg, E, g, q)`` of every point (n, h), float32, as
    ``fused_gabor.py::_filters_from_points``: x rounded to ``cdt`` in the
    products, |x|^2 of the unrounded points, sinarg = x omega + phi, q =
    (|x|^2 - 2 x mu^T) + |mu|^2, E = exp((-gamma/2) q), g = sin(sinarg) E
    (the degree-11 sine in bfloat16)."""
    sin, _ = trig(cdt)
    xx = torch.sum(pts * pts, dim=-1, keepdim=True)
    xr = round_to(pts, cdt)
    out = []
    for f in filter_views(fpack, num_layers):
        sinarg = xr @ f["om"] + f["ph"]
        q = (xx - 2.0 * (xr @ f["muT"])) + f["m2"]
        e = torch.exp((-0.5 * f["gam"]) * q)
        out.append((sinarg, e, sin(sinarg) * e, q))
    return out


def _acts(pk: GaborFieldPack, pts: torch.Tensor, dirs: torch.Tensor,
          k: GaborConsts) -> dict:
    """Every activation of the kernels' forward of points (n, 3) and
    directions (n, 3) (``fused_render_gabor.py::net_acts``)."""
    filt = point_filters(pk.filters, pts, k.num_layers, pk.packed.cdt)
    return net_acts(pk.packed, filt, _encode(dirs, k.dir_freqs, DP, torch.sin), k)


def gabor_field_plain(pk: GaborFieldPack, pts: torch.Tensor, dirs: torch.Tensor,
                      k: GaborConsts):
    """The forward kernel's function in plain PyTorch: ``(rgb (n, 3), sigma
    (n,))``, float32."""
    a = _acts(pk, pts, dirs, k)
    return a["rgb"], torch.relu(a["sigma_pre"]) * k.sigma_mul


def gabor_field_bwd_plain(pk: GaborFieldPack, pts: torch.Tensor, dirs: torch.Tensor,
                          cot: torch.Tensor, k: GaborConsts):
    """The backward kernel's function in plain PyTorch: ``(gw, gv, gf, dpts,
    ddirs)``, the flat float32 gradients of sum(cot * [rgb, sigma]) of the
    packed weights and of the filter banks (``pack_filters``' layout), and
    the point and direction cotangents; ``cot`` is (n, 4)."""
    cdt = pk.packed.cdt
    sin, cos = trig(cdt)

    def r(x):
        return round_to(x, cdt)

    a = _acts(pk, pts, dirs, k)
    rgb = a["rgb"]
    dzr1 = ((cot[:, :3] * rgb) * (1.0 - rgb)) * k.rgb_mul
    dsig = torch.where(a["sigma_pre"] > 0, cot[:, 3] * k.sigma_mul,
                       torch.zeros_like(cot[:, 3]))
    (gw, gv), dgs, dzr0 = net_bwd(pk.packed, a, dzr1, dsig, k)
    gf = torch.zeros_like(pk.filters)
    xr = r(pts)
    dpts = torch.zeros_like(pts)
    for j, (f, g) in enumerate(zip(filter_views(pk.filters, k.num_layers),
                                   filter_views(gf, k.num_layers))):
        sinarg, e, _, q = a["filt"][j]
        dsinarg = (dgs[j] * cos(sinarg)) * e
        da = (dgs[j] * sin(sinarg)) * e
        dq = da * (-0.5 * f["gam"])
        g["om"].copy_(xr.T @ r(dsinarg))
        g["ph"].copy_(dsinarg.sum(0))
        g["muT"].copy_(xr.T @ r(-2.0 * dq))
        g["m2"].copy_(dq.sum(0))
        g["gam"].copy_((da * (-0.5 * q)).sum(0))
        dpts = ((dpts + r(dsinarg) @ f["om"].T)
                + (2.0 * pts) * dq.sum(1, keepdim=True)) - 2.0 * (r(dq) @ f["muT"].T)
    ddenc = r(dzr0) @ pk.packed.mats["wr0d"].float().T
    return gw, gv, gf, dpts, _encode_bwd(ddenc, dirs, k.dir_freqs)


# ---------------------------------------------------------------- libraries


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = library(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "fused_gabor_fwd":
        lib.gabor_field_fwd.argtypes = [vp] * 5 + [ci] * 6 + [cf] * 2 + [vp] * 3
        lib.gabor_field_fwd.restype = ci
        lib.gabor_field_fwd_error.argtypes = [ci]
        lib.gabor_field_fwd_error.restype = ctypes.c_char_p
    else:
        lib.gabor_field_bwd.argtypes = [vp] * 7 + [ci] * 8 + [cf] * 2 + [vp] * 6
        lib.gabor_field_bwd.restype = ci
        lib.gabor_field_bwd_error.argtypes = [ci]
        lib.gabor_field_bwd_error.restype = ctypes.c_char_p
        lib.gabor_field_bwd_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        lib.gabor_field_bwd_sizes.restype = None
    return lib


# ---------------------------------------------------------------- wrapper


class GaborField(FusedField):
    """The field ``(points (..., 3), dirs (..., 3)) -> (rgb (..., 3), sigma
    (...,))`` of a GaborNet through the field kernels (the counterpart of
    ``make_fused_gabor_apply``'s ``apply``), with ``FusedField``'s
    contract: ``packed`` a ``GaborFieldPack`` or None."""

    launches = 0
    bwd_launches = 0
    family = "GaborNet"

    def __init__(self, model, packed: GaborFieldPack | None = None):
        super().__init__(model, packed)
        self.n = model.num_layers
        self.consts = GaborConsts.of(model)
        self.real_d = 3 * (1 + 2 * self.consts.dir_freqs)

    def params_f32(self) -> tuple:
        return (*pack_f32(self.model), pack_filters(self.model))

    def cast(self, wflat: torch.Tensor, vec: torch.Tensor,
             fpack: torch.Tensor) -> GaborFieldPack:
        return GaborFieldPack(packed=cast_packed(wflat, vec, self.cdt, self.h, self.n),
                              filters=fpack.contiguous())

    def supported(self) -> bool:
        """The shapes the kernels cover: hidden 256 and 8 stages (as the
        render kernels) and a direction encoding of at most 32 columns.
        (The TPU kernels take any depth and hidden 512 too; the port does
        not yet.)"""
        return self.h == HIDDEN and self.n == NUM_LAYERS and self.real_d <= DP

    def _unsupported(self) -> str:
        return (f"the GaborNet field kernels cover hidden {HIDDEN} with "
                f"{NUM_LAYERS} stages and a direction encoding of at most {DP} "
                f"columns; got hidden {self.h}, {self.n} stages, {self.real_d} "
                "columns (ROADMAP.md queue 2; run on the CPU, or with use_pallas "
                "= false)")

    def _plain_forward(self, pk: GaborFieldPack, pts, dirs):
        return gabor_field_plain(pk, pts, dirs, self.consts)

    def _plain_backward(self, pk: GaborFieldPack, pts, dirs, cot):
        return gabor_field_bwd_plain(pk, pts, dirs, cot, self.consts)

    def _packed_args(self, pk: GaborFieldPack) -> tuple:
        return (("wmat", pk.packed.wmat, pk.packed.wmat.shape, self.cdt),
                ("vec", pk.packed.vec, pk.packed.vec.shape, torch.float32),
                ("filters", pk.filters, (self.n * BANK_ROWS * self.h,), torch.float32))

    def _launch_fwd(self, pk: GaborFieldPack, pts: torch.Tensor, dirs: torch.Tensor):
        self._check(pk, pts, dirs)
        n = pts.shape[0]
        dev = pts.device
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        sigma = torch.empty((n,), dtype=torch.float32, device=dev)
        if n == 0:
            return rgb, sigma
        pts, dirs = pts.contiguous(), dirs.contiguous()
        packed, k = pk.packed, self.consts
        lib = _library("fused_gabor_fwd")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gabor_field_fwd(
                pts.data_ptr(), dirs.data_ptr(), packed.wmat.data_ptr(),
                packed.vec.data_ptr(), pk.filters.data_ptr(), packed.wmat.numel(),
                packed.vec.numel(), pk.filters.numel(), int(self.cdt == torch.bfloat16),
                n, self.real_d, k.sigma_mul, k.rgb_mul, rgb.data_ptr(),
                sigma.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("GaborNet field forward kernel: "
                               + lib.gabor_field_fwd_error(code).decode())
        type(self).launches += 1
        return rgb, sigma

    def _launch_bwd(self, pk: GaborFieldPack, pts: torch.Tensor, dirs: torch.Tensor,
                    cot: torch.Tensor):
        self._check(pk, pts, dirs, cot)
        n = pts.shape[0]
        dev = pts.device
        dpts = torch.empty((n, 3), dtype=torch.float32, device=dev)
        ddirs = torch.empty((n, 3), dtype=torch.float32, device=dev)
        packed, k = pk.packed, self.consts
        n_w, n_b, n_f = packed.wmat.numel(), packed.vec.numel(), pk.filters.numel()
        if n == 0:
            return (torch.zeros(n_w, device=dev), torch.zeros(n_b, device=dev),
                    torch.zeros(n_f, device=dev), dpts, ddirs)
        pts, dirs, cot = pts.contiguous(), dirs.contiguous(), cot.contiguous()
        lib = _library("fused_gabor_bwd")
        per_point, npart, n_out = grad_sizes(lib.gabor_field_bwd_sizes)
        run, grid = self._runs(n, dev)
        wmat_t = torch.cat([packed.mats[m].t().reshape(-1) for m in _names(self.n)[0]])
        scratch = torch.empty(grid * run * per_point, dtype=torch.float32, device=dev)
        partial = torch.empty(grid * npart, dtype=torch.float32, device=dev)
        out = torch.empty(n_out, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gabor_field_bwd(
                pts.data_ptr(), dirs.data_ptr(), cot.data_ptr(), packed.wmat.data_ptr(),
                wmat_t.data_ptr(), packed.vec.data_ptr(), pk.filters.data_ptr(), n_w,
                n_b, n_f, int(self.cdt == torch.bfloat16), n, run, run, self.real_d,
                k.sigma_mul, k.rgb_mul, scratch.data_ptr(), partial.data_ptr(),
                out.data_ptr(), dpts.data_ptr(), ddirs.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("GaborNet field backward kernel: "
                               + lib.gabor_field_bwd_error(code).decode())
        type(self).bwd_launches += 1
        return (out[:n_w], out[n_w:n_w + n_b], out[n_w + n_b:n_w + n_b + n_f],
                dpts, ddirs)
