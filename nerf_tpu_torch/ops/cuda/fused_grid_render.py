"""Fused grid render: interpolation, density, colour decode and compositing
of a voxel-grid cache in one CUDA kernel (eval only), in two forms.

``FusedGridRender(params, rays_o, rays_d, viewdirs, t) -> {rgb, acc,
depth, weights}`` is ``nerf_tpu/ops/pallas/fused_grid_render.py::
FusedGridRender``: per sample the trilinear interpolation of the grid
(float32, or the bfloat16 mode from a bfloat16 copy), the density of
channel 0, the colour decode, ``1 - alpha = exp(-sigma delta)`` with the
1e10 tail, and the transmittance carried along the ray. The two forms are
nerf_tpu's two:

  * SH (``FusedGridRender``, a ``PlenoxelsModel``, also the baked
    PlenOctree cache): softplus density, colour ``sigmoid(sum_l Y_l(d)
    v_{1 + c*L + l})`` (``_sh_sel``; ``_expand_basis`` lays the ray's SH
    basis over the channels), the interpolation mode ``interp_dtype``'s
    from the copy ``PlenoxelsModel.precompute`` makes;
  * factors (``FusedFactorRender``, a ``BakedFastNeRF``): relu density,
    colour ``sigmoid(sum_d beta_d v_{1 + 3d + c})`` (``_factor_sel``;
    ``_expand_basis(beta, repeat_block=False)``), beta the ray's row of
    the cache's direction grid from ``BakedFastNeRF.beta``, computed before
    the launch as nerf_tpu computes its basis outside its pallas_call; the
    grid the cache's bfloat16 copy ``packed_pos`` (nerf_tpu's eval
    default), or ``pos_grid`` in float32 without one.

The [near, far] -> [-1, 1] normalisation and the model's ``domain`` are
folded into one ray -> cell affine (``affine``). The white background is
the caller's; the weights carry no gradient. Like nerf_tpu's the render is
eval-only (``eval_only``): training routes skip it, and a call whose grid
requires grad under autograd raises.

The kernel is ``csrc/fused_grid_render.cu`` (replacing
``_grid_render_kernel``; it shares ``csrc/grid_common.cuh`` with the
row-17 kernel), one C entry with the form as an argument. It takes the
rays, t, the two affine scalars and the ray's decode input (the view
direction, from which it computes the SH basis itself, or beta): a tile is
one launch. On CPU tensors the plain composition runs (``cells_affine``,
the basis, ``_expand_basis``, ``grid_render_plain``); on CUDA tensors the
kernel launches or the call raises (``NotImplementedError`` for C > 32 or
R < 2), never the plain version. ``FusedGridRender.launches`` counts the SH
form's launches, ``FusedFactorRender.launches`` the factor form's.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nerf_tpu_torch.models.fastnerf import BakedFastNeRF
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, PlenoxelsPack, sh_basis, softplus
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.fused_grid import LANES, check_grid, interp_cells_plain
from nerf_tpu_torch.ops.sampling import deltas_from_t
from nerf_tpu_torch.ops.volume import exclusive_cumprod

ROW = "row 18, fused_grid_render.py::_grid_render_kernel"
SH, FACTORS = 0, 1          # the kernel's decode forms


def _sh_sel(l_dim: int) -> np.ndarray:
    """SH layout: channel 1 + c*L + l belongs to colour c; (32,) int8 colour
    of each channel, -1 for none (the density channel, padding)."""
    sel = np.full(LANES, -1, np.int8)
    for c in range(3):
        sel[1 + c * l_dim:1 + (c + 1) * l_dim] = c
    return sel


def _factor_sel(d_dim: int) -> np.ndarray:
    """Factor layout (baked FastNeRF): channel 1 + 3d + c belongs to colour
    c; int8 as ``_sh_sel``, over at least 32 channels (more for D > 10,
    which the kernel refuses at the call)."""
    sel = np.full(max(LANES, 1 + 3 * d_dim), -1, np.int8)
    sel[1:1 + 3 * d_dim] = np.tile(np.arange(3, dtype=np.int8), d_dim)
    return sel


def _expand_basis(x: torch.Tensor, repeat_block: bool = True) -> torch.Tensor:
    """(R, L) basis -> (R, 32) over the channels: [0, basis x3, 0...] for SH
    (a colour's block of L channels each), [0, each beta_d x3, 0...] for
    factors (``repeat_block=False``: beta_d covers channels 1 + 3d..3 + 3d)."""
    num = x.shape[0]
    body = torch.cat([x, x, x], dim=1) if repeat_block else x.repeat_interleave(3, dim=1)
    pad = LANES - 1 - body.shape[1]
    return torch.cat([x.new_zeros((num, 1)), body, x.new_zeros((num, pad))], dim=1)


def cells_affine(rays_o: torch.Tensor, rays_d: torch.Tensor, scale: float,
                 off: float) -> tuple:
    """``(o', d')`` (R, 3): the ray -> cell affine of ``FusedGridRender.affine``'s
    scalars applied as the kernel applies them (float32, ``scale * o + off``
    and ``scale * d``)."""
    return (scale * rays_o + off).contiguous(), (scale * rays_d).contiguous()


def grid_render_plain(src: torch.Tensor, o_aff: torch.Tensor, d_aff: torch.Tensor,
                      t: torch.Tensor, bexp: torch.Tensor, sel: np.ndarray,
                      relu_sigma: bool = False) -> tuple:
    """The kernel's function in plain PyTorch: ``(rgb, acc, depth,
    weights)`` of rays with the folded affine ``o_aff``/``d_aff`` (R, 3),
    samples ``t`` (R, S) and channel-expanded basis ``bexp`` (R, 32) over
    the grid ``src`` (float32, or its bfloat16 copy for the bfloat16 mode);
    the density softplus, or relu with ``relu_sigma`` (the factor form)."""
    r, c = src.shape[0], src.shape[-1]
    cells = (o_aff[:, None, :] + d_aff[:, None, :] * t[..., None]).clamp(0.0, r - 1.0)
    vals = interp_cells_plain(src, cells)                        # (R, S, C)
    sigma = torch.relu(vals[..., 0]) if relu_sigma else softplus(vals[..., 0])
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
    cf = ctypes.c_float
    lib.grid_render.argtypes = [vp] * 4 + [cf, cf, vp] + [ci] * 7 + [vp] * 5
    lib.grid_render.restype = ci
    lib.grid_render_error.argtypes = [ci]
    lib.grid_render_error.restype = ctypes.c_char_p
    return lib


class FusedGridRender:
    """The eval render of a ``PlenoxelsModel``, row 18's SH form (the
    fused-render contract of ``FusedNerfRender``: ``pack`` once per image,
    then ``__call__`` per ray tile)."""

    eval_only = True
    launches = 0
    form = SH
    relu_sigma = False

    def __init__(self, model: PlenoxelsModel, near: float, far: float, normalize: bool = True):
        self.near, self.far, self.normalize = float(near), float(far), bool(normalize)
        self.domain = model.domain
        self.k = model.sh_degree
        self.sel = _sh_sel(model.sh_dim)

    def pack(self, params) -> PlenoxelsPack:
        """``params`` (a model, or its ``precompute``) with the grid copy
        its interpolation reads, made once."""
        return params if isinstance(params, PlenoxelsPack) else params.precompute()

    def grids(self, pack) -> tuple:
        """``(grid, src)``: the cache's float32 grid and the copy the
        interpolation reads (the bfloat16 one, else the grid)."""
        grid = pack.model.grid
        return grid, (grid.detach() if pack.packed is None else pack.packed)

    def ray_input(self, pack, viewdirs: torch.Tensor) -> torch.Tensor:
        """The per-ray input of the kernel's colour decode: the view
        directions (R, 3), whose SH basis the kernel computes."""
        return viewdirs

    def expanded_basis(self, ray_in: torch.Tensor) -> torch.Tensor:
        """The plain version's (R, 32) channel basis from ``ray_input``."""
        return _expand_basis(sh_basis(ray_in, self.k))

    def affine(self, r: int) -> tuple:
        """``(scale, off)``: a ray's sample at t lies at cell coordinate
        g = (scale o + off) + (scale d) t, the normalisation and the domain
        folded in (nerf_tpu's ``_cells``); computed on the host."""
        lo, hi = self.domain
        ext = hi - lo
        if self.normalize:
            s_n = 2.0 / (self.far - self.near)
            o_n = -2.0 * self.near / (self.far - self.near) - 1.0
            return (r - 1.0) * s_n / ext, (r - 1.0) * (o_n - lo) / ext
        return (r - 1.0) / ext, (r - 1.0) * (-lo) / ext

    def __call__(self, params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 viewdirs: torch.Tensor, t: torch.Tensor) -> dict:
        pack = self.pack(params)
        grid, src = self.grids(pack)
        if torch.is_grad_enabled() and grid.requires_grad:
            raise NotImplementedError(
                "the fused grid render is eval-only (as nerf_tpu's: no VJP); render "
                "under torch.no_grad() or train through the module")
        r, _ = check_grid(src, ROW)
        scale, off = self.affine(r)
        rays_o, rays_d = rays_o.float().contiguous(), rays_d.float().contiguous()
        t = t.float().contiguous()
        ray_in = self.ray_input(pack, viewdirs.float()).float().contiguous()
        if t.device.type == "cpu":
            o_aff, d_aff = cells_affine(rays_o, rays_d, scale, off)
            rgb, acc, depth, w = grid_render_plain(
                src, o_aff, d_aff, t, self.expanded_basis(ray_in).contiguous(), self.sel,
                self.relu_sigma)
        elif t.device.type == "cuda":
            rgb, acc, depth, w = self._launch(src, rays_o, rays_d, ray_in, t, scale, off)
        else:
            raise ValueError(f"the fused grid render runs on cuda or cpu, not {t.device}")
        return {"rgb": rgb, "acc": acc, "depth": depth, "weights": w}

    def channels(self) -> int:
        """The channels of the grid this form decodes."""
        return 1 + 3 * (self.k + 1) ** 2

    def _launch(self, src, rays_o, rays_d, ray_in, t, scale: float, off: float) -> tuple:
        r, c = src.shape[0], src.shape[-1]
        num_rays, s = t.shape
        dev = t.device
        if not (src.device == rays_o.device == rays_d.device == ray_in.device == dev):
            raise ValueError(f"grid on {src.device}, rays on {rays_o.device}, t on {dev}")
        if c != self.channels():
            raise ValueError(f"grid of {c} channels for {type(self).__name__} of "
                             f"{self.channels()}")
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
                rays_o.data_ptr(), rays_d.data_ptr(), ray_in.data_ptr(), t.data_ptr(),
                scale, off, src.data_ptr(), r, c, self.form, self.k,
                int(src.dtype == torch.bfloat16), num_rays, s, rgb.data_ptr(),
                acc.data_ptr(), depth.data_ptr(), w.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("fused grid render kernel: " + lib.grid_render_error(code).decode())
        type(self).launches += 1
        return rgb, acc, depth, w


class FusedFactorRender(FusedGridRender):
    """The eval render of a ``BakedFastNeRF``, row 18's factor form: the
    cache is its own pack (``params`` the ``BakedFastNeRF``), beta its
    ``beta`` of the view directions."""

    launches = 0
    form = FACTORS
    relu_sigma = True

    def __init__(self, model: BakedFastNeRF, near: float, far: float, normalize: bool = True):
        self.near, self.far, self.normalize = float(near), float(far), bool(normalize)
        self.domain = model.domain
        self.k = model.num_factors
        self.sel = _factor_sel(self.k)

    def pack(self, params) -> BakedFastNeRF:
        return params

    def grids(self, pack) -> tuple:
        grid = pack.pos_grid
        return grid, (grid if pack.packed_pos is None else pack.packed_pos)

    def ray_input(self, pack, viewdirs: torch.Tensor) -> torch.Tensor:
        """beta (R, D) of the view directions, from the cache's direction
        grid."""
        return pack.beta(viewdirs)

    def expanded_basis(self, ray_in: torch.Tensor) -> torch.Tensor:
        return _expand_basis(ray_in, repeat_block=False)

    def channels(self) -> int:
        return 1 + 3 * self.k


def make_fused_grid_render(model, near: float, far: float, normalize: bool = True):
    """The fused grid render of ``model`` (nerf_tpu's factory): a
    ``PlenoxelsModel`` (the SH form) or a ``BakedFastNeRF`` (the factor
    form) with the grid kernels (``use_grid_kernel``) and at most 32
    channels gets one; any other model, and those without the kernels or
    with more channels, None (the module renders)."""
    if isinstance(model, PlenoxelsModel):
        if not model.use_grid_kernel or model.channels > LANES:
            return None
        return FusedGridRender(model, near, far, normalize)
    if isinstance(model, BakedFastNeRF):
        if not model.use_grid_kernel or model.pos_grid.shape[-1] > LANES:
            return None
        return FusedFactorRender(model, near, far, normalize)
    return None
