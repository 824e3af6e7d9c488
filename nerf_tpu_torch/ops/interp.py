"""Trilinear interpolation of a dense voxel grid, with its exact gradient.

Counterpart of ``nerf_tpu.ops.interp.trilinear``: ``grid`` (R, R, R, C) at
points (N, 3) in [-1, 1]^3, coordinates clamped to the grid's border
(``_tri_coords``). ``Trilinear`` is the ``torch.autograd.Function``:

  * forward: the 8-corner lerp, ``ops/cuda/fused_grid.py::grid_interp``
    (the PERF.md row-17 kernel on CUDA tensors, its plain version on CPU
    tensors), in float32, or in the bfloat16 mode when a bfloat16 copy of
    the grid is given (``trilinear_rays``'s eval renders);
  * backward (``_trilinear_bwd``): the grid's cotangent as ONE scatter-add
    of the 8N corner rows, ``ops/cuda/scatter_add.py::scatter_add_rows``
    (the row-19 kernel on CUDA tensors: sorted, in a fixed order, no float
    atomics, so a training step is deterministic); the point cotangent in
    PyTorch, zero where the clamp is active, only when asked for.

``bilinear`` (FastNeRF's direction grid) is plain PyTorch under autograd,
as nerf_tpu leaves it to XLA: the grid is small and no kernel reaches it.
"""

from __future__ import annotations

import torch

from nerf_tpu_torch.ops.cuda.fused_grid import cells_of, grid_interp
from nerf_tpu_torch.ops.cuda.scatter_add import scatter_add_rows


def _tri_coords(p: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x0, f)``: the int64 corner-0 cell and the fraction of points p."""
    x = cells_of(p, r)
    x0 = torch.floor(x).clamp(0.0, r - 2.0)
    return x0.long(), x - x0


def _trilinear_bwd(grid: torch.Tensor, p: torch.Tensor, g: torch.Tensor,
                   need_grid: bool, need_points: bool):
    """``(grad_grid, grad_points)`` of ``sum(g * trilinear(grid, p))`` (None
    where not needed), as nerf_tpu's ``_trilinear_bwd`` forms them."""
    r, c = grid.shape[0], grid.shape[-1]
    x0, f = _tri_coords(p, r)
    wz = (1.0 - f[:, 2], f[:, 2])
    flat = grid.detach().reshape(-1, c)
    ids, vals = [], []
    gfx = gfy = gfz = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            wx = f[:, 0] if dx else 1.0 - f[:, 0]
            wy = f[:, 1] if dy else 1.0 - f[:, 1]
            w_xy = wx * wy
            base = ((x0[:, 0] + dx) * r + (x0[:, 1] + dy)) * r + x0[:, 2]
            if need_grid:
                coeff = w_xy[:, None] * g
                ids += [base, base + 1]
                vals += [coeff * wz[0][:, None], coeff * wz[1][:, None]]
            if need_points:
                p0, p1 = flat[base], flat[base + 1]
                v = wz[0][:, None] * p0 + wz[1][:, None] * p1
                gv = torch.sum(g * v, dim=-1)
                gfz = gfz + w_xy * torch.sum(g * (p1 - p0), dim=-1)
                gfx = gfx + (1.0 if dx else -1.0) * wy * gv
                gfy = gfy + (1.0 if dy else -1.0) * wx * gv
    grad_grid = grad_p = None
    if need_grid:
        grad_grid = scatter_add_rows(torch.cat(ids), torch.cat(vals), r ** 3).reshape(grid.shape)
    if need_points:
        raw = (p + 1.0) * (0.5 * (r - 1))
        inside = ((raw > 0.0) & (raw < r - 1.0)).float()
        grad_p = torch.stack([gfx, gfy, gfz], dim=-1) * inside * (0.5 * (r - 1))
    return grad_grid, grad_p


class Trilinear(torch.autograd.Function):
    """``(grid, p (N, 3), packed) -> (N, C)``: the forward reads ``packed``
    (a bfloat16 copy of ``grid``: the bfloat16 mode) when given, else
    ``grid``; the gradient flows to ``grid`` and ``p`` (``packed`` gets
    none, the total derivative exactly when it is a copy of ``grid``)."""

    @staticmethod
    def forward(ctx, grid, p, packed):
        ctx.save_for_backward(grid, p)
        return grid_interp(grid if packed is None else packed, p)

    @staticmethod
    def backward(ctx, g):
        grid, p = ctx.saved_tensors
        gg, gp = _trilinear_bwd(grid, p.detach().float(), g.float(),
                                ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return gg, (None if gp is None else gp.to(p.dtype)), None


def trilinear(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` (R, R, R, C) at points ``p``
    (N, 3) in [-1, 1]^3 -> (N, C) float32, differentiable in both."""
    return Trilinear.apply(grid, p, None)


def bilinear(grid: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``grid`` (H, W, C) at float coordinates
    ``(u, v)`` (N,) -> (N, C), as ``nerf_tpu.ops.interp.bilinear``: the base
    cell ``u0 = clip(floor(u), 0, H - 2)``, ``v0 = clip(floor(v), 0, W - 2)``
    and the fractions ``u - u0``, ``v - v0`` taken from the clipped base (so
    a coordinate past the border extrapolates linearly from the last cell);
    the two corners along v lerped first, then along u."""
    h, w = grid.shape[0], grid.shape[1]
    u0 = torch.floor(u).long().clamp(0, h - 2)
    v0 = torch.floor(v).long().clamp(0, w - 2)
    fu, fv = (u - u0)[:, None], (v - v0)[:, None]
    out = 0.0
    for du in (0, 1):
        val = (1.0 - fv) * grid[u0 + du, v0] + fv * grid[u0 + du, v0 + 1]
        out = out + (fu if du else 1.0 - fu) * val
    return out
