"""Fused grid render: interpolation, density, colour decode and compositing
of a voxel-grid family in one CUDA kernel (eval only).

``FusedGridRender(params, rays_o, rays_d, viewdirs, t) -> {rgb, acc,
depth, weights}`` is the Plenoxels branch of
``nerf_tpu/ops/pallas/fused_grid_render.py::FusedGridRender``: per sample
the trilinear interpolation of the grid (``interp_dtype``: float32, or the
bfloat16 mode from the copy ``PlenoxelsModel.precompute`` makes), the
softplus density of channel 0, the colour ``sigmoid(sum_l Y_l(d) sh_l)``
(``_sh_sel`` maps channel 1 + c*L + l to colour c, ``_expand_basis`` lays
the ray's SH basis over the channels), ``1 - alpha = exp(-sigma delta)``
with the 1e10 tail, and the transmittance carried along the ray. The
[near, far] -> [-1, 1] normalisation and the model's ``domain`` are folded
into one ray -> cell affine (``_cells``). The white background is the
caller's; the weights carry no gradient. Like nerf_tpu's it is eval-only
(``eval_only``): training routes skip it, and a call whose grid requires
grad under autograd raises.

The kernel is ``csrc/fused_grid_render.cu`` (replacing
``_grid_render_kernel``; it shares ``csrc/grid_common.cuh`` with the
row-17 kernel). On CPU tensors the plain version runs; on CUDA tensors the
kernel launches or the call raises (``NotImplementedError`` for C > 32 or
R < 2), never the plain version; ``FusedGridRender.launches`` counts the
launches. The baked FastNeRF branch (``_factor_sel``, relu density) waits
for ROADMAP queue 1 item 4(c): ``make_fused_grid_render`` raises for it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, PlenoxelsPack, sh_basis, softplus
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.fused_grid import LANES, check_grid, interp_cells_plain
from nerf_tpu_torch.ops.sampling import deltas_from_t
from nerf_tpu_torch.ops.volume import exclusive_cumprod

ROW = "row 18, fused_grid_render.py::_grid_render_kernel"


def _sh_sel(l_dim: int) -> np.ndarray:
    """SH layout: channel 1 + c*L + l belongs to colour c; (32,) int8 colour
    of each channel, -1 for none (the density channel, padding)."""
    sel = np.full(LANES, -1, np.int8)
    for c in range(3):
        sel[1 + c * l_dim:1 + (c + 1) * l_dim] = c
    return sel


def _expand_basis(x: torch.Tensor) -> torch.Tensor:
    """(R, L) SH basis -> (R, 32) over the channels: [0, basis x3, 0...]."""
    num = x.shape[0]
    body = torch.cat([x, x, x], dim=1)
    pad = LANES - 1 - body.shape[1]
    return torch.cat([x.new_zeros((num, 1)), body, x.new_zeros((num, pad))], dim=1)


def grid_render_plain(src: torch.Tensor, o_aff: torch.Tensor, d_aff: torch.Tensor,
                      t: torch.Tensor, bexp: torch.Tensor, sel: np.ndarray) -> tuple:
    """The kernel's function in plain PyTorch: ``(rgb, acc, depth,
    weights)`` of rays with the folded affine ``o_aff``/``d_aff`` (R, 3),
    samples ``t`` (R, S) and channel-expanded basis ``bexp`` (R, 32) over
    the grid ``src`` (float32, or its bfloat16 copy for the bfloat16
    mode)."""
    r, c = src.shape[0], src.shape[-1]
    cells = (o_aff[:, None, :] + d_aff[:, None, :] * t[..., None]).clamp(0.0, r - 1.0)
    vals = interp_cells_plain(src, cells)                        # (R, S, C)
    sigma = softplus(vals[..., 0])
    onehot = torch.zeros((c, 3), dtype=torch.float32, device=src.device)
    for ch in range(c):
        if sel[ch] >= 0:
            onehot[ch, int(sel[ch])] = 1.0
    rgb = torch.sigmoid((vals * bexp[:, None, :c]) @ onehot)      # (R, S, 3)
    one_m = torch.exp(-sigma * deltas_from_t(t))
    w = exclusive_cumprod(one_m, dim=-1) * (1.0 - one_m)
    return (torch.sum(w[..., None] * rgb, dim=-2), torch.sum(w, dim=-1),
            torch.sum(w * t, dim=-1), w)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("fused_grid_render")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grid_render.argtypes = [vp] * 6 + [ci] * 5 + [vp] * 5
    lib.grid_render.restype = ci
    lib.grid_render_error.argtypes = [ci]
    lib.grid_render_error.restype = ctypes.c_char_p
    return lib


class FusedGridRender:
    """The eval render of a ``PlenoxelsModel`` (the fused-render contract
    of ``FusedNerfRender``: ``pack`` once per image, then ``__call__`` per
    ray tile)."""

    eval_only = True
    launches = 0

    def __init__(self, model: PlenoxelsModel, near: float, far: float, normalize: bool = True):
        self.near, self.far, self.normalize = float(near), float(far), bool(normalize)
        self.domain = model.domain
        self.sh_degree = model.sh_degree
        self.sel = _sh_sel(model.sh_dim)

    def pack(self, params) -> PlenoxelsPack:
        """``params`` (a model, or its ``precompute``) with the grid copy
        its interpolation reads, made once."""
        return params if isinstance(params, PlenoxelsPack) else params.precompute()

    def affine(self, rays_o: torch.Tensor, rays_d: torch.Tensor, r: int) -> tuple:
        """``(o', d')``: cell coordinate g = o' + d' t of each ray, the
        normalisation and the domain folded in (nerf_tpu's ``_cells``)."""
        lo, hi = self.domain
        ext = hi - lo
        if self.normalize:
            s_n = 2.0 / (self.far - self.near)
            o_n = -2.0 * self.near / (self.far - self.near) - 1.0
            scale = (r - 1.0) * s_n / ext
            off = (r - 1.0) * (o_n - lo) / ext
        else:
            scale = (r - 1.0) / ext
            off = (r - 1.0) * (-lo) / ext
        return (scale * rays_o + off).contiguous(), (scale * rays_d).contiguous()

    def __call__(self, params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 viewdirs: torch.Tensor, t: torch.Tensor) -> dict:
        pack = self.pack(params)
        grid = pack.model.grid
        if torch.is_grad_enabled() and grid.requires_grad:
            raise NotImplementedError(
                "the fused grid render is eval-only (as nerf_tpu's: no VJP); render "
                "under torch.no_grad() or train through the module")
        src = grid.detach() if pack.packed is None else pack.packed
        r, _ = check_grid(src, ROW)
        o_aff, d_aff = self.affine(rays_o.float(), rays_d.float(), r)
        bexp = _expand_basis(sh_basis(viewdirs.float(), self.sh_degree)).contiguous()
        t = t.float().contiguous()
        if t.device.type == "cpu":
            rgb, acc, depth, w = grid_render_plain(src, o_aff, d_aff, t, bexp, self.sel)
        elif t.device.type == "cuda":
            rgb, acc, depth, w = self._launch(src, o_aff, d_aff, t, bexp)
        else:
            raise ValueError(f"the fused grid render runs on cuda or cpu, not {t.device}")
        return {"rgb": rgb, "acc": acc, "depth": depth, "weights": w}

    def _launch(self, src, o_aff, d_aff, t, bexp) -> tuple:
        r, c = src.shape[0], src.shape[-1]
        num_rays, s = t.shape
        dev = t.device
        if not (src.device == o_aff.device == bexp.device == dev):
            raise ValueError(f"grid on {src.device}, rays on {o_aff.device}, t on {dev}")
        rgb = torch.empty((num_rays, 3), dtype=torch.float32, device=dev)
        acc = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        depth = torch.empty_like(acc)
        w = torch.empty((num_rays, s), dtype=torch.float32, device=dev)
        if num_rays == 0 or s == 0:
            return rgb, acc.zero_(), depth.zero_(), w
        src = src.contiguous()
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.grid_render(
                o_aff.data_ptr(), d_aff.data_ptr(), t.data_ptr(), bexp.data_ptr(),
                self.sel.ctypes.data, src.data_ptr(), r, c, int(src.dtype == torch.bfloat16),
                num_rays, s, rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(),
                w.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("fused grid render kernel: " + lib.grid_render_error(code).decode())
        type(self).launches += 1
        return rgb, acc, depth, w


def make_fused_grid_render(model, near: float, far: float, normalize: bool = True):
    """The fused grid render of ``model`` (nerf_tpu's factory): a
    ``PlenoxelsModel`` with the grid kernels (``use_grid_kernel``) and at
    most 32 channels gets one, other Plenoxels None (the module renders).
    Raises ``NotImplementedError`` for the baked FastNeRF and PlenOctree
    caches (ROADMAP queue 1 item 4(c))."""
    if isinstance(model, PlenoxelsModel):
        if not model.use_grid_kernel or model.channels > LANES:
            return None
        return FusedGridRender(model, near, far, normalize)
    raise NotImplementedError(
        f"no fused grid render for {type(model).__name__}: row 18's baked FastNeRF / "
        "PlenOctree branch (_factor_sel, relu density) waits for ROADMAP.md queue 1 "
        "item 4(c)")
