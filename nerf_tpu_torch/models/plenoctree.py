"""PlenOctrees: the NeRF-SH field, its bake into a Plenoxels grid, and the
octree's sparse leaf format, as in ``nerf_tpu.models.plenoctree`` (Yu et
al. 2021).

``PlenOctreeModel`` is the trainable stage: the 5 + 3 skip trunk of
models/common.py whose head gives [sigma, 3 x L spherical-harmonic
coefficients] (L = (sh_degree + 1)^2), colour ``sigmoid(sum_l Y_l(d)
sh_cl)`` with no direction network, so that the field bakes. ``bake``
samples it on the grid_res^3 lattice over the model's ``domain`` cube and
returns a port ``PlenoxelsModel`` whose grid holds the raw density
softplus^-1(sigma) = log(expm1(clip(sigma, 1e-8, 1e8))) in channel 0 and the
coefficients in nerf_tpu's channel order: rendering the cache reuses the
Plenoxels path, row 18's SH form included. The expression is nerf_tpu's,
bit for bit wherever it is finite; above sigma ~ 88.7 its float32 expm1
overflows and nerf_tpu stores inf, and a cell of inf density renders NaN
wherever a sample gives it a weight of exactly 0 (0 * inf: every sample
clamped to the grid's border). The port stores the limit there instead:
softplus^-1(sigma) = sigma + log1p(-exp(-sigma)), which is sigma itself in
float32 from 88.7 on.
``to_octree`` / ``from_octree`` are the paper's sparse format on the host
(numpy), copied from nerf_tpu.

Class trait: ``wants_tile_order``, as in nerf_tpu (see models/fastnerf.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_tpu_torch.models.common import skip_trunk_apply, skip_trunk_init
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.fastnerf import bake_points, lattice
from nerf_tpu_torch.models.nerf import _dtype
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, sh_basis


class PlenOctreeModel(nn.Module):
    wants_tile_order = True

    def __init__(self, pos_encoding_dim: int = 10, hidden_dim: int = 256, sh_degree: int = 2,
                 compute_dtype: str = "float32", reference_init: bool = False,
                 use_grid_kernel: bool = True, domain: tuple = (-1.0, 1.0),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pos_encoding_dim = pos_encoding_dim
        self.hidden_dim = hidden_dim
        self.sh_degree = int(sh_degree)
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.use_grid_kernel = bool(use_grid_kernel)
        self.domain = (float(domain[0]), float(domain[1]))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.trunk1, self.trunk2, self.head = skip_trunk_init(
            self.pos_in, hidden_dim, 1 + 3 * self.sh_dim, reference_init, generator)

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def sh_dim(self) -> int:
        return (self.sh_degree + 1) ** 2

    def sh_field(self, points: torch.Tensor) -> tuple:
        """points (..., 3) in [-1, 1] -> (sigma (...,), sh (..., 3, L)):
        everything an octree leaf stores."""
        sigma, tail = skip_trunk_apply(self, positional_encoding(points, self.pos_encoding_dim),
                                       self.cdt)
        return sigma, tail.reshape(*tail.shape[:-1], 3, self.sh_dim)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor) -> tuple:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,))."""
        sigma, sh = self.sh_field(points)
        basis = sh_basis(viewdirs, self.sh_degree)
        return torch.sigmoid(torch.sum(sh * basis[..., None, :], dim=-1)), sigma

    @torch.no_grad()
    def bake(self, grid_res: int = 128, chunk: int = 65536) -> PlenoxelsModel:
        """The field on the grid_res^3 lattice over ``domain``^3 as a
        Plenoxels model on this model's device (its grid a parameter that
        requires no grad: the cache is eval-only). At 128^3 and degree 2:
        234.9 MB of float32."""
        dev = self.head.weight.device

        def field_chunk(p):
            sigma, sh = self.sh_field(p)
            sigma = torch.clamp(sigma, 1e-8, 1e8)
            raw = torch.log(torch.expm1(sigma))
            raw = torch.where(torch.isinf(raw), sigma, raw)   # expm1 overflowed
            return torch.cat([raw[:, None], sh.reshape(-1, 3 * self.sh_dim)], dim=-1)

        r = grid_res
        grid = bake_points(field_chunk, lattice(self.domain, r, dev), chunk)
        # built at 2^3 and given the baked grid: no r^3 init grid to discard
        model = PlenoxelsModel(grid_res=2, sh_degree=self.sh_degree,
                               use_grid_kernel=self.use_grid_kernel, domain=self.domain)
        model.set_grid(grid.reshape(r, r, r, 1 + 3 * self.sh_dim))
        model.grid.requires_grad_(False)
        return model


def to_octree(grid: np.ndarray, sigma_threshold: float = 1e-2) -> dict:
    """The leaf set of an occupancy-thresholded octree over a dense (R, R,
    R, C) density + SH grid: the cells whose channel 0 exceeds
    ``sigma_threshold``, lossless over them. R must be a power of two.
    Returns {"res", "channels", "threshold", "coords" (M, 3) uint16,
    "payload" (M, C) float32}; ``from_octree`` inverts it."""
    grid = np.asarray(grid)
    r, c = grid.shape[0], grid.shape[-1]
    assert r & (r - 1) == 0, "octree baking needs a power-of-two grid"
    occupied = grid[..., 0] > sigma_threshold
    return {
        "res": r,
        "channels": c,
        "threshold": float(sigma_threshold),
        "coords": np.argwhere(occupied).astype(np.uint16),
        "payload": grid[occupied].astype(np.float32),
    }


def from_octree(tree: dict) -> np.ndarray:
    """The dense grid of ``to_octree``'s leaf set, pruned cells zero (zero
    density: skipped space)."""
    r, c = tree["res"], tree["channels"]
    grid = np.zeros((r, r, r, c), np.float32)
    idx = tree["coords"].astype(np.int64)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = tree["payload"]
    return grid
