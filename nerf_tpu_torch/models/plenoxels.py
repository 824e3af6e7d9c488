"""Plenoxels: a voxel grid of density and spherical harmonics, no network,
as an ``nn.Module``.

Counterpart of ``nerf_tpu.models.plenoxels.PlenoxelsModel``. The grid is
one parameter (R, R, R, C) over the model's ``domain`` cube (mapped onto
[-1, 1] by ``remap_domain``), C = 1 + 3 (sh_degree + 1)^2 channels (28 at
degree 2): a sample trilinearly interpolates its 8 corners and

    sigma = softplus(channel 0)
    rgb_c = sigmoid(sum_l Y_l(d) * channel 1 + c*L + l)

(softplus, not the paper's relu, and sigmoid colour: the JAX package's
documented choices). Grids interpolate in float32 whatever the config's
``compute_dtype`` (nerf_tpu's field has no effect; the port takes none).
The grid starts at softplus^-1(``init_sigma``) in the
density channel and zero elsewhere (all zero with ``reference_init``).

Interpolation (``apply``): ray-structured (R, S, 3) points go through
``ops/cuda/fused_grid.py::trilinear_rays`` (the row-17 kernel on the card)
in float32 wherever gradients flow (nerf_tpu's training batches are
incoherent and always take its exact float32 path) and in ``interp_dtype``
otherwise (eval: bfloat16 from the copy ``precompute`` makes once per
render); other shapes, and ``use_grid_kernel = false`` (set from
``use_pallas``), go through ``ops/interp.py::trilinear`` in float32. The
gradient is ``trilinear``'s: the 8-corner scatter-add (the row-19 kernel).
``tv`` is the paper's total-variation prior (plain PyTorch, as in
nerf_tpu), ``upsample`` the coarse-to-fine resample (through row 17 in
float32).

Class traits: ``wants_tile_order`` (full-image renders reorder rays into
8x8 pixel blocks, ``train/step.py::make_eval_render``). nerf_tpu's
``scan_hostile`` (its fit dispatches grid families per step because XLA
cannot alias the grid across ``lax.scan`` iterations) and
``eval_gather_bound`` (its eval tile is capped at 8192 rays for TPU HBM)
answer TPU dispatch and memory limits and have no counterpart here: the
port's loop dispatches every step from Python, and its eval tile is
``chunk_size`` on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from nerf_tpu_torch.models.common import remap_domain
from nerf_tpu_torch.ops.cuda.fused_grid import pack_grid, trilinear_rays
from nerf_tpu_torch.ops.interp import trilinear

# real SH basis values, degrees 0..2 (the standard 9-term table)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
       1.0925484305920792, 0.5462742152960396)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics Y_lm(d) of unit dirs (..., 3) ->
    (..., (degree + 1)^2), degrees 0-2."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        out += [
            _C2[0] * x * y,
            -_C2[1] * y * z,
            _C2[2] * (3.0 * z * z - 1.0),
            -_C2[3] * x * z,
            _C2[4] * (x * x - y * y),
        ]
    return torch.stack(out, dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + log1p(exp(-|x|)): softplus without overflow."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


@dataclass(frozen=True)
class PlenoxelsPack:
    """A Plenoxels model prepared for one render: the grid copy its
    interpolation reads (``packed``: bfloat16, or None for float32). A
    field ``(points, dirs) -> (rgb, sigma)``, and what the fused grid render
    takes."""

    model: "PlenoxelsModel"
    packed: Optional[torch.Tensor]

    def __call__(self, points: torch.Tensor, viewdirs: torch.Tensor):
        return self.model.apply(points, viewdirs, packed=self.packed)


class PlenoxelsModel(nn.Module):
    name = "plenoxels"
    wants_tile_order = True

    def __init__(self, grid_res: int = 128, sh_degree: int = 2, init_sigma: float = 0.1,
                 reference_init: bool = False, interp_dtype: str = "bfloat16",
                 use_grid_kernel: bool = True,
                 domain: tuple = (-1.0, 1.0), generator: torch.Generator | None = None):
        super().__init__()
        del generator          # deterministic: the grid starts uniform
        if interp_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"interp_dtype must be float32 or bfloat16, got {interp_dtype!r}")
        self.grid_res = int(grid_res)
        self.sh_degree = int(sh_degree)
        self.interp_dtype = interp_dtype
        self.use_grid_kernel = bool(use_grid_kernel)
        self.domain = (float(domain[0]), float(domain[1]))
        r = self.grid_res
        grid = torch.zeros((r, r, r, self.channels), dtype=torch.float32)
        if not reference_init:
            grid[..., 0] = float(np.log(np.expm1(init_sigma)))
        self.grid = nn.Parameter(grid)

    @property
    def sh_dim(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def channels(self) -> int:
        return 1 + 3 * self.sh_dim

    def precompute(self) -> PlenoxelsPack:
        """The model with its render-time grid copy (bfloat16 in
        bfloat16 interp mode with the grid kernels), made once per render."""
        with torch.no_grad():
            dt = self.interp_dtype if self.use_grid_kernel else "float32"
            return PlenoxelsPack(self, pack_grid(self.grid, dt))

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor):
        return self.apply(points, viewdirs)

    def apply(self, points: torch.Tensor, viewdirs: torch.Tensor,
              packed: Optional[torch.Tensor] = None):
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,)); points
        in the renderer's normalised space (``domain`` places the grid)."""
        points = remap_domain(points, self.domain)
        shape = points.shape[:-1]
        c = self.channels
        if points.dim() == 3 and self.use_grid_kernel:
            grad = torch.is_grad_enabled() and self.grid.requires_grad
            dtype = "float32" if grad else self.interp_dtype
            vals = trilinear_rays(self.grid, points, dtype=dtype,
                                  packed=None if dtype == "float32" else packed)
            vals = vals.reshape(-1, c)
        else:
            vals = trilinear(self.grid, points.reshape(-1, 3))
        sigma = softplus(vals[:, 0])
        sh = vals[:, 1:].reshape(-1, 3, self.sh_dim)
        basis = sh_basis(viewdirs.reshape(-1, 3), self.sh_degree)
        rgb = torch.sigmoid(torch.einsum("ncl,nl->nc", sh, basis))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)

    def tv(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Total variation of the grid (the paper's eq. 3): the mean squared
        forward difference along each axis, summed over the axes, for the
        density channel and for the SH channels."""
        g = self.grid
        r = g.shape[0]
        tv_sigma = g.new_zeros(())
        tv_sh = g.new_zeros(())
        for axis in range(3):
            d = g.narrow(axis, 1, r - 1) - g.narrow(axis, 0, r - 1)
            tv_sigma = tv_sigma + torch.mean(torch.square(d[..., 0]))
            tv_sh = tv_sh + torch.mean(torch.square(d[..., 1:]))
        return tv_sigma, tv_sh

    @torch.no_grad()
    def upsample(self, new_res: int) -> torch.Tensor:
        """The grid trilinearly resampled to ``new_res``^3 (coarse-to-fine):
        lattice lines along z as rays, through ``trilinear_rays`` in float32
        (``trilinear`` without the grid kernels)."""
        lin = torch.linspace(-1.0, 1.0, new_res, dtype=torch.float32, device=self.grid.device)
        pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1)
        if self.use_grid_kernel:
            vals = trilinear_rays(self.grid, pts.reshape(new_res * new_res, new_res, 3),
                                  dtype="float32")
        else:
            vals = trilinear(self.grid, pts.reshape(-1, 3))
        return vals.reshape(new_res, new_res, new_res, self.channels)

    def set_grid(self, grid: torch.Tensor) -> None:
        """Replace the grid (a new parameter; ``grid_res`` follows it)."""
        self.grid = nn.Parameter(grid.detach().contiguous())
        self.grid_res = int(grid.shape[0])
