"""FastNeRF: a factorised position / direction field, and its MLP-free
baked cache, as ``nn.Module``s.

Counterpart of ``nerf_tpu.models.fastnerf`` (Garbin et al. 2021). The
field splits into two networks,

    F_pos(x) -> sigma, {f_d in R^3}_{d=1..D}    (the 5 + 3 skip trunk of
                                                  models/common.py, head
                                                  [sigma, D x 3 factors])
    F_dir(v) -> {beta_d}_{d=1..D}               (2 layers on the encoded
                                                  view direction)
    rgb(x, v) = sigmoid(sum_d beta_d f_d)

so that ``bake`` can sample F_pos on a dense grid over the model's
``domain`` cube and F_dir on a lat/long direction grid. The cache
(``BakedFastNeRF``) renders with no network at all: a trilinear row of the
position grid, a bilinear row of the direction grid and a D x 3
contraction a sample. Full images of a cache go through the factor form of
row 18's fused grid render (``ops/cuda/fused_grid_render.py``).

Class traits: ``wants_tile_order`` (full-image renders reorder rays into
8x8 pixel blocks, ``train/step.py::make_eval_render``), on the live model
as on the cache, as in nerf_tpu. nerf_tpu's ``eval_gather_bound`` caps its
eval tile for TPU memory and has no counterpart here (see
models/plenoxels.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerf_tpu_torch.models.common import (
    linear,
    linear_init,
    remap_domain,
    skip_trunk_apply,
    skip_trunk_init,
)
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.nerf import _dtype
from nerf_tpu_torch.ops.cuda.fused_grid import LANES, pack_grid, trilinear_rays
from nerf_tpu_torch.ops.interp import bilinear, trilinear


def lattice(domain: tuple, r: int, device) -> torch.Tensor:
    """The r^3 lattice over ``domain``^3 as (r^3, 3) points in the (R, R, R)
    row order of the voxel grids (``meshgrid(indexing="ij")``)."""
    lin = torch.linspace(float(domain[0]), float(domain[1]), r, dtype=torch.float32,
                         device=device)
    return torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)


def bake_points(field, pts: torch.Tensor, chunk: int) -> torch.Tensor:
    """``field(points) -> (N, C)`` over ``pts`` in chunks of ``chunk``."""
    return torch.cat([field(pts[i:i + chunk]) for i in range(0, pts.shape[0], chunk)])


class FastNeRFModel(nn.Module):
    wants_tile_order = True

    def __init__(self, pos_encoding_dim: int = 10, dir_encoding_dim: int = 4,
                 hidden_dim: int = 256, dir_hidden_dim: int = 128, num_factors: int = 8,
                 compute_dtype: str = "float32", reference_init: bool = False,
                 use_grid_kernel: bool = True, domain: tuple = (-1.0, 1.0),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pos_encoding_dim = pos_encoding_dim
        self.dir_encoding_dim = dir_encoding_dim
        self.hidden_dim = hidden_dim
        self.num_factors = num_factors
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.use_grid_kernel = bool(use_grid_kernel)
        self.domain = (float(domain[0]), float(domain[1]))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.trunk1, self.trunk2, self.head = skip_trunk_init(
            self.pos_in, hidden_dim, 1 + 3 * num_factors, reference_init, generator)
        self.dir = nn.ModuleList([linear_init(self.dir_in, dir_hidden_dim, generator),
                                  linear_init(dir_hidden_dim, num_factors, generator)])

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def pos_factors(self, points: torch.Tensor) -> tuple:
        """F_pos: points (..., 3) in [-1, 1] -> (sigma (...,), factors
        (..., D, 3))."""
        sigma, tail = skip_trunk_apply(self, positional_encoding(points, self.pos_encoding_dim),
                                       self.cdt)
        return sigma, tail.reshape(*tail.shape[:-1], self.num_factors, 3)

    def dir_weights(self, viewdirs: torch.Tensor) -> torch.Tensor:
        """F_dir: unit directions (..., 3) -> beta (..., D)."""
        y = torch.relu(linear(self.dir[0], positional_encoding(viewdirs, self.dir_encoding_dim),
                              self.cdt))
        return linear(self.dir[1], y, self.cdt)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor) -> tuple:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,))."""
        sigma, factors = self.pos_factors(points)
        beta = self.dir_weights(viewdirs)
        return torch.sigmoid(torch.sum(beta[..., None] * factors, dim=-2)), sigma

    @torch.no_grad()
    def bake(self, grid_res: int = 128, dir_res: int = 64,
             chunk: int = 65536) -> "BakedFastNeRF":
        """The paper's cache on this model's device: F_pos on the grid_res^3
        lattice over ``domain``^3 (``pos_grid`` (R, R, R, 1 + 3D) float32,
        and its bfloat16 copy where the grid kernels take it) and F_dir on
        the (dir_res, 2 dir_res) lat/long grid, theta in [0, pi] by phi in
        [-pi, pi] (``beta_grid``). At 128^3 and D = 8: 209.7 MB of float32
        and 104.9 MB of bfloat16."""
        dev = self.head.weight.device
        d = self.num_factors

        def pos_chunk(p):
            sigma, f = self.pos_factors(p)
            return torch.cat([sigma[:, None], f.reshape(-1, 3 * d)], dim=-1)

        pos_grid = bake_points(pos_chunk, lattice(self.domain, grid_res, dev), chunk)
        pos_grid = pos_grid.reshape(grid_res, grid_res, grid_res, 1 + 3 * d)
        th = torch.linspace(0.0, math.pi, dir_res, dtype=torch.float32, device=dev)
        ph = torch.linspace(-math.pi, math.pi, 2 * dir_res, dtype=torch.float32, device=dev)
        tt, pp = torch.meshgrid(th, ph, indexing="ij")
        dirs = torch.stack([torch.sin(tt) * torch.cos(pp), torch.sin(tt) * torch.sin(pp),
                            torch.cos(tt)], dim=-1).reshape(-1, 3)
        beta_grid = self.dir_weights(dirs).reshape(dir_res, 2 * dir_res, d)
        packed = None
        if self.use_grid_kernel and pos_grid.shape[-1] <= LANES:
            packed = pack_grid(pos_grid, "bfloat16")
        return BakedFastNeRF(pos_grid, beta_grid, d, use_grid_kernel=self.use_grid_kernel,
                             packed_pos=packed, domain=self.domain)


class BakedFastNeRF(nn.Module):
    """The MLP-free FastNeRF cache: ``pos_grid`` (R, R, R, 1 + 3D), its
    bfloat16 copy ``packed_pos`` (None without the grid kernels or above 32
    channels) and ``beta_grid`` (T, 2T, D), all buffers, never parameters
    (the cache is eval-only). A field ``(points, dirs) -> (rgb, sigma)``."""

    wants_tile_order = True

    def __init__(self, pos_grid: torch.Tensor, beta_grid: torch.Tensor, num_factors: int,
                 use_grid_kernel: bool = True, packed_pos: Optional[torch.Tensor] = None,
                 domain: tuple = (-1.0, 1.0)):
        super().__init__()
        if pos_grid.shape[-1] != 1 + 3 * num_factors or beta_grid.shape[-1] != num_factors:
            raise ValueError(f"grids {tuple(pos_grid.shape)} / {tuple(beta_grid.shape)} do "
                             f"not hold {num_factors} factors")
        self.register_buffer("pos_grid", pos_grid.detach().float().contiguous())
        self.register_buffer("beta_grid", beta_grid.detach().float().contiguous())
        self.register_buffer("packed_pos", None if packed_pos is None
                             else packed_pos.detach().contiguous())
        self.num_factors = int(num_factors)
        self.use_grid_kernel = bool(use_grid_kernel)
        self.domain = (float(domain[0]), float(domain[1]))

    def beta(self, dirs: torch.Tensor) -> torch.Tensor:
        """F_dir from the cache: unit directions (N, 3) -> (N, D), the
        bilinear row of ``beta_grid`` at theta = arccos(z), phi =
        atan2(y, x). The one source of the direction-grid parameterisation:
        ``apply`` and the fused grid render's factor form both call it."""
        t_res, p_res = self.beta_grid.shape[0], self.beta_grid.shape[1]
        theta = torch.arccos(torch.clamp(dirs[:, 2], -1.0, 1.0))
        phi = torch.atan2(dirs[:, 1], dirs[:, 0])
        u = theta / math.pi * (t_res - 1)
        v = (phi + math.pi) / (2 * math.pi) * (p_res - 1)
        return bilinear(self.beta_grid, u, v)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor) -> tuple:
        return self.apply(points, viewdirs)

    def apply(self, points: torch.Tensor, viewdirs: torch.Tensor) -> tuple:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,)); points
        in the renderer's normalised space. Ray-structured (R, S, 3) points
        interpolate the bfloat16 copy through ``trilinear_rays`` (the row-17
        kernel on the card) where there is one; other shapes, and a cache
        without it, interpolate ``pos_grid`` in float32 (``trilinear``)."""
        points = remap_domain(points, self.domain)
        shape = points.shape[:-1]
        c = self.pos_grid.shape[-1]
        if points.dim() == 3 and self.packed_pos is not None:
            vals = trilinear_rays(self.pos_grid, points, dtype="bfloat16",
                                  packed=self.packed_pos).reshape(-1, c)
        else:
            vals = trilinear(self.pos_grid, points.reshape(-1, 3))
        sigma = torch.relu(vals[:, 0])
        factors = vals[:, 1:].reshape(-1, self.num_factors, 3)
        beta = self.beta(viewdirs.reshape(-1, 3))
        rgb = torch.sigmoid(torch.sum(beta[:, :, None] * factors, dim=1))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)
