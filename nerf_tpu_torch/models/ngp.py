"""Instant NGP: a multiresolution hash encoding and two tiny MLPs, as an
``nn.Module``.

Counterpart of ``nerf_tpu.models.ngp.NGPModel`` (Mueller et al. 2022):

  * L levels with resolutions geometrically spaced from ``base_res`` to
    ``max_res`` (``level_resolutions``); each level owns a table of
    ``2**log2_table`` rows of ``feat_dim`` features, drawn U(-1e-4, 1e-4).
    A point's 8 cell corners map to rows directly where the level's dense
    grid fits the table ((res + 1)^3 <= 2^T, a bijection), otherwise by the
    spatial hash of the paper's eq. 4 (primes 1, 2654435761, 805459861,
    XOR, uint32 arithmetic that wraps, masked to the table);
  * the corner rows blend trilinearly, the levels concatenate into an
    (L * feat_dim) encoding over the model's ``domain`` cube (mapped onto
    [-1, 1] by ``remap_domain``);
  * density net encoding -> hidden -> 1 + ``geo_feat_dim`` with the
    exponential density exp(clip(x, -15, 15)), its bias at 0.5 unless
    ``reference_init``; colour net [geo features, SH basis of the view
    direction (``sh_degree``)] -> hidden -> sigmoid rgb.

The hash is computed in int64 with each product masked to 32 bits, so the
row of every corner is nerf_tpu's. The table gradient of the gathers is one
scatter-add of all levels' corner rows a pass
(``ops/cuda/scatter_add.py::scatter_add_rows``: the row-19 kernel on the
card, sorted and in a fixed order, no float atomics, so a training step is
deterministic and a resume repeats it bit for bit); nerf_tpu leaves its
gathers and their scatter-add to XLA and runs no Pallas kernel here.
nerf_tpu's ``eval_gather_bound`` caps its eval tile for TPU memory and has
no counterpart here (see models/plenoxels.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_tpu_torch.models.common import linear, linear_init, remap_domain, uniform_init
from nerf_tpu_torch.models.nerf import _dtype
from nerf_tpu_torch.models.plenoxels import sh_basis
from nerf_tpu_torch.ops.cuda.scatter_add import scatter_add_rows

PRIMES = (1, 2654435761, 805459861)   # pi_1..pi_3, NGP eq. 4
_M32 = 0xFFFFFFFF
# the 8 corner offsets in nerf_tpu's order (meshgrid "ij" over x, y, z)
_OFFS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1).reshape(8, 3)


class _HashGather(torch.autograd.Function):
    """``(rows (L, N, 8), *tables) -> (L, N, 8, F)``: each level's corner
    features; the backward is one ``scatter_add_rows`` of all levels'
    corner cotangents into the L stacked tables."""

    @staticmethod
    def forward(ctx, rows, *tables):
        ctx.save_for_backward(rows)
        ctx.table_rows = tables[0].shape[0]
        return torch.stack([t[r] for t, r in zip(tables, rows)])

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        n_lvl, t = rows.shape[0], ctx.table_rows
        offs = torch.arange(n_lvl, device=rows.device, dtype=rows.dtype) * t
        ids = (rows + offs[:, None, None]).reshape(-1)
        grads = scatter_add_rows(ids, g.reshape(ids.shape[0], -1).float(), n_lvl * t)
        return (None, *grads.reshape(n_lvl, t, -1).unbind(0))


class NGPModel(nn.Module):
    def __init__(self, num_levels: int = 16, feat_dim: int = 2, log2_table: int = 19,
                 base_res: int = 16, max_res: int = 2048, hidden_dim: int = 64,
                 geo_feat_dim: int = 15, sh_degree: int = 2,
                 compute_dtype: str = "float32", reference_init: bool = False,
                 domain: tuple = (-1.0, 1.0), generator: torch.Generator | None = None):
        super().__init__()
        self.num_levels = num_levels
        self.feat_dim = feat_dim
        self.log2_table = log2_table
        self.base_res = base_res
        self.max_res = max_res
        self.hidden_dim = hidden_dim
        self.geo_feat_dim = geo_feat_dim
        self.sh_degree = int(sh_degree)
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.domain = (float(domain[0]), float(domain[1]))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        t = 1 << log2_table
        self.tables = nn.ParameterList(
            [nn.Parameter(uniform_init((t, feat_dim), 1e-4, generator))
             for _ in range(num_levels)])
        self.density = nn.ModuleList([linear_init(self.enc_dim, hidden_dim, generator),
                                      linear_init(hidden_dim, 1 + geo_feat_dim, generator)])
        if not reference_init:
            # exp never dies, but a very negative start stalls the early
            # compositing gradients: start at sigma ~ exp(0.5)
            with torch.no_grad():
                self.density[-1].bias[0] = 0.5
        self.color = nn.ModuleList([linear_init(geo_feat_dim + self.dir_in, hidden_dim,
                                                generator),
                                    linear_init(hidden_dim, 3, generator)])

    @property
    def enc_dim(self) -> int:
        return self.num_levels * self.feat_dim

    @property
    def dir_in(self) -> int:
        return (self.sh_degree + 1) ** 2

    def level_resolutions(self) -> np.ndarray:
        """N_l = floor(N_min * b^l), b from eq. 3 (numpy, as nerf_tpu)."""
        if self.num_levels == 1:
            return np.asarray([self.base_res])
        b = np.exp((np.log(self.max_res) - np.log(self.base_res)) / (self.num_levels - 1))
        return np.floor(self.base_res * b ** np.arange(self.num_levels)).astype(np.int64)

    def corner_rows(self, cell: torch.Tensor, res: int) -> torch.Tensor:
        """Integer corner coordinates (N, 8, 3) at resolution ``res`` -> table
        rows (N, 8) int64: direct where the dense grid fits the table, else
        the spatial hash in uint32 arithmetic (int64, masked to 32 bits
        after each product)."""
        t = 1 << self.log2_table
        if (res + 1) ** 3 <= t:
            stride = res + 1
            return (cell[..., 0] * stride + cell[..., 1]) * stride + cell[..., 2]
        h = (cell[..., 0] * PRIMES[0]) & _M32
        h = h ^ ((cell[..., 1] * PRIMES[1]) & _M32)
        h = h ^ ((cell[..., 2] * PRIMES[2]) & _M32)
        return h & (t - 1)

    def _cells(self, p: torch.Tensor):
        """Per level ``(rows (N, 8), fractions (N, 3))`` of points (N, 3)."""
        x01 = torch.clamp((remap_domain(p, self.domain) + 1.0) * 0.5, 0.0, 1.0)
        offs = torch.from_numpy(_OFFS).to(p.device)
        out = []
        for res in self.level_resolutions():
            res = int(res)
            x = x01 * res
            x0 = torch.floor(x).clamp(max=res - 1)
            cell = x0.long()[:, None, :] + offs[None]
            out.append((self.corner_rows(cell, res), x - x0))
        return out

    def encode(self, p: torch.Tensor) -> torch.Tensor:
        """The multiresolution hash encoding of points (N, 3) in the
        ``domain`` cube -> (N, L * feat_dim)."""
        cells = self._cells(p)
        rows = torch.stack([r for r, _ in cells])
        feats = _HashGather.apply(rows, *self.tables)               # (L, N, 8, F)
        on = torch.from_numpy(_OFFS.astype(bool)).to(p.device)
        outs = []
        for lvl, (_, f) in enumerate(cells):
            w = torch.prod(torch.where(on[None], f[:, None, :], 1.0 - f[:, None, :]), dim=-1)
            outs.append(torch.sum(w[..., None] * feats[lvl], dim=1))
        return torch.cat(outs, dim=-1)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor) -> tuple:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,))."""
        shape = points.shape[:-1]
        p = points.reshape(-1, 3)
        d = viewdirs.reshape(-1, 3)
        x = torch.relu(linear(self.density[0], self.encode(p), self.cdt))
        x = linear(self.density[1], x, self.cdt)
        sigma = torch.exp(torch.clamp(x[:, 0], -15.0, 15.0))
        y = torch.cat([x[:, 1:], sh_basis(d, self.sh_degree)], dim=-1)
        y = torch.relu(linear(self.color[0], y, self.cdt))
        rgb = torch.sigmoid(linear(self.color[1], y, self.cdt))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)
