"""Trilinear interpolation of a dense voxel grid at ray-structured points,
in a CUDA kernel.

``trilinear_rays(grid, points, dtype)`` is the function of
``nerf_tpu/ops/pallas/fused_grid.py::trilinear_rays``: the (R, R, R, C)
grid (C <= 32) interpolated at points (R_rays, S, 3) in [-1, 1] ->
(R_rays, S, C) float32, exact with respect to ``ops/interp.py::trilinear``
in ``"float32"`` mode; in ``"bfloat16"`` mode the rows come from a
bfloat16 copy of the grid (``pack_grid``, made once per render by
``PlenoxelsModel.precompute``) and each corner weight is rounded to
bfloat16 after its product, with float32 sums (``_interp_seg``). Its
gradient is ``ops/interp.py::trilinear``'s (the 8-corner scatter-add and
the point gradient), as nerf_tpu's custom VJP takes the pure backward.

The kernel (``csrc/fused_grid.cu`` on ``csrc/grid_common.cuh``, replacing
``_grid_kernel``) takes any batch of points: the TPU kernel's sub-brick
packing, 16^3 window, ``fits`` bit and ``lax.cond`` to the gather path
answer Mosaic's missing in-kernel gather and have no counterpart here.
On CPU tensors ``grid_interp`` runs the plain version (the same roundings,
operation by operation); on CUDA tensors it launches the kernel or raises
(``NotImplementedError`` for C > 32 or R < 2), never the plain version.
``GridKernel.launches`` counts the launches. ``tile_ray_order`` is
nerf_tpu's 8x8 pixel-block permutation of an image's rays, which keeps a
launch's neighbouring rays close in space.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.ops.cuda.build import library

LANES = 32          # channels the kernels cover


class GridKernel:
    """Launch count of ``csrc/fused_grid.cu`` over all calls."""

    launches = 0


def check_grid(grid: torch.Tensor, row: str) -> tuple[int, int]:
    """``(R, C)`` of a (R, R, R, C) grid; ``NotImplementedError`` (naming
    ``row`` of PERF.md's table) for a shape the grid kernels do not cover."""
    if grid.dim() != 4 or not grid.shape[0] == grid.shape[1] == grid.shape[2]:
        raise ValueError(f"grid (R, R, R, C) wanted, got {tuple(grid.shape)}")
    r, c = grid.shape[0], grid.shape[-1]
    if r < 2 or not 1 <= c <= LANES:
        raise NotImplementedError(
            f"the grid kernels ({row}) cover R >= 2 and 1..{LANES} channels, got "
            f"R = {r}, C = {c}")
    return r, c


def pack_grid(grid: torch.Tensor, dtype: str) -> torch.Tensor | None:
    """The grid copy that ``dtype``'s interpolation reads, made once per
    render (the counterpart of ``pack_grid(grid, bf16)``): a contiguous
    bfloat16 copy for ``"bfloat16"``, None for ``"float32"`` (the grid
    itself)."""
    if dtype == "float32":
        return None
    if dtype != "bfloat16":
        raise ValueError(f"interp dtype must be float32 or bfloat16, got {dtype!r}")
    return grid.detach().to(torch.bfloat16).contiguous()


def cells_of(points: torch.Tensor, r: int) -> torch.Tensor:
    """Float cell coordinates of points in [-1, 1], clamped to [0, R-1]
    (``interp.py::_tri_coords``)."""
    return ((points + 1.0) * (0.5 * (r - 1))).clamp(0.0, r - 1.0)


def interp_cells_plain(src: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """The interpolation of ``csrc/grid_common.cuh`` in plain PyTorch: the
    grid ``src`` (float32, or its bfloat16 copy: then the weights round to
    bfloat16) at float cell coordinates (..., 3) -> (..., C) float32,
    rounded as the kernels round (one operation at a time)."""
    r, c = src.shape[0], src.shape[-1]
    flat = src.reshape(-1, c)
    x0 = torch.floor(cells).clamp(0.0, r - 2.0)
    f = cells - x0
    lo = 1.0 - f
    x0i = x0.long()
    base = (x0i[..., 0] * r + x0i[..., 1]) * r + x0i[..., 2]
    out = None
    for k in range(8):
        wx = f[..., 0] if k & 4 else lo[..., 0]
        wy = f[..., 1] if k & 2 else lo[..., 1]
        wz = f[..., 2] if k & 1 else lo[..., 2]
        w = round_to((wx * wy) * wz, src.dtype)
        row = flat[base + ((r * r) if k & 4 else 0) + (r if k & 2 else 0) + (k & 1)].float()
        term = w[..., None] * row
        out = term if out is None else out + term
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("fused_grid")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.grid_interp.argtypes = [vp, vp, ci, ci, ci, cl, vp, vp]
    lib.grid_interp.restype = ci
    lib.grid_interp_error.argtypes = [ci]
    lib.grid_interp_error.restype = ctypes.c_char_p
    return lib


def grid_interp(src: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The grid ``src`` (R, R, R, C), float32 or its bfloat16 copy (which
    selects the mode), interpolated at points (N, 3) in [-1, 1] -> (N, C)
    float32: the plain version for CPU tensors, the kernel for CUDA tensors.
    No gradient (``ops/interp.py`` wraps it)."""
    r, c = check_grid(src, "row 17, fused_grid.py::_grid_kernel")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points (N, 3) wanted, got {tuple(points.shape)}")
    if src.dtype not in (torch.float32, torch.bfloat16) or src.device != points.device:
        raise ValueError(f"grid {src.dtype} on {src.device}, points on {points.device}")
    points = points.detach().float()
    if points.device.type == "cpu":
        return interp_cells_plain(src.detach(), cells_of(points, r))
    if points.device.type != "cuda":
        raise ValueError(f"grid interpolation runs on cuda or cpu, not {points.device}")
    n = points.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    points, src = points.contiguous(), src.detach().contiguous()
    lib = _library()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.grid_interp(points.data_ptr(), src.data_ptr(), r, c,
                               int(src.dtype == torch.bfloat16), n, out.data_ptr(), stream)
    if code != 0:
        raise RuntimeError("grid interpolation kernel: " + lib.grid_interp_error(code).decode())
    GridKernel.launches += 1
    return out


def trilinear_rays(grid: torch.Tensor, points: torch.Tensor, dtype: str = "bfloat16",
                   packed: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` (R, R, R, C) at ray-structured
    ``points`` (R_rays, S, 3) in [-1, 1] -> (R_rays, S, C) float32, in
    ``dtype``'s mode (``packed``: ``pack_grid(grid, dtype)`` made once per
    render; made here when None). Differentiable in ``grid`` and
    ``points`` through ``ops/interp.py::trilinear``'s backward."""
    from nerf_tpu_torch.ops.interp import Trilinear

    if packed is None:
        packed = pack_grid(grid, dtype)
    elif dtype == "float32" or packed.shape != grid.shape:
        raise ValueError(f"packed grid {tuple(packed.shape)} does not fit grid "
                         f"{tuple(grid.shape)} in {dtype} mode")
    flat = Trilinear.apply(grid, points.reshape(-1, 3), packed)
    return flat.reshape(*points.shape[:-1], grid.shape[-1])


def tile_ray_order(h: int, w: int, tile: int = 8) -> np.ndarray:
    """Permutation putting an (h, w) image's rays into ``tile`` x ``tile``
    pixel blocks (row-major blocks, row-major within): ``rays[perm]``;
    invert with ``argsort(perm)``. Partial edge blocks are smaller."""
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    out = []
    for by in range(0, h, tile):
        for bx in range(0, w, tile):
            out.append(idx[by:by + tile, bx:bx + tile].reshape(-1))
    return np.concatenate(out)
