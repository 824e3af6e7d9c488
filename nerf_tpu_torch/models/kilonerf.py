"""KiloNeRF: a grid of tiny per-voxel MLPs, as an ``nn.Module``.

Counterpart of ``nerf_tpu.models.kilonerf.KiloNeRFModel`` (same architecture,
same compute-dtype rules). The model's ``domain`` cube (``registry.py::
grid_domain``, mapped onto [-1, 1] by ``remap_domain``) is cut into
``grid_res``^3 voxels; each voxel owns an independent network of width
``hidden_dim`` (32 in the paper), evaluated on coordinates local to its
voxel:

  * l1: Linear(63, h) + ReLU on the L=10 encoding of the local position;
  * l2: Linear(h, h) + ReLU;
  * trunk: Linear(h, h + 1), no activation; density = relu(last channel);
  * rgb1: Linear(h + 27, h) + ReLU on concat(features, L=4 encoding of the
    view direction); rgb2: Linear(h, 3) + sigmoid.

Every layer is stored batched over the networks in the JAX layout: ``w``
(G^3, in, out) and ``b`` (G^3, out), as parameters ``{layer}.w`` /
``{layer}.b``. That is the tree of the JAX package (``models/convert.py``
maps it by name) and what the grouped matmuls consume.

Three evaluations of the same field:

  * ``apply_pointwise``: per-point weight gathers (the numerical reference);
  * ``forward``: the grouped path of the JAX ``apply`` (one stable sort by
    network, tiles of ``dispatch_tile`` points, one batched matmul per
    layer over the tiles with float32 sums, one gather back to point
    order). It is the module path (``use_pallas = false``) and is
    differentiable through autograd;
  * ``ops/cuda/fused_kilonerf.py::KiloNeRFField``: the CUDA kernels (their
    plain versions on the CPU), which the train step and the renderer take
    by default (``train/step.py::fused_field_for``).

Init: each layer draws torch's default law (weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in))) per network, weight first, from the
module's ``torch.Generator``, layers in the order above; the density bias
starts at +0.5 unless ``reference_init``. The JAX key stream is not
reproduced, only the law.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_tpu_torch.models.common import remap_domain, round_to, uniform_init
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.nerf import _dtype

LAYERS = ("l1", "l2", "trunk", "rgb1", "rgb2")


class BatchedLinear(nn.Module):
    """G independent linear layers: ``w`` (G, in, out), ``b`` (G, out)."""

    def __init__(self, g: int, in_dim: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        bound = 1.0 / (in_dim ** 0.5)
        w = torch.empty(g, in_dim, out_dim)
        b = torch.empty(g, out_dim)
        for i in range(g):
            w[i] = uniform_init((in_dim, out_dim), bound, generator)
            b[i] = uniform_init((out_dim,), bound, generator)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def dispatch_plan_sorted(svid: torch.Tensor, g3: int, t: int):
    """The tile plan of already-sorted network ids ``svid`` (n,), as
    ``nerf_tpu.models.kilonerf.dispatch_plan_sorted``: ``(gid, src, valid,
    counts)`` with ``gid`` (tiles,) the network of each tile, ``src``
    (tiles, t) the row of the sorted array each slot takes (n for an empty
    slot), ``valid`` (tiles, t) and ``counts`` (g3,) points per network;
    tiles = ceil(n/t) + g3 (surplus tiles are empty)."""
    n = svid.shape[0]
    dev = svid.device
    starts = torch.searchsorted(svid, torch.arange(g3, dtype=svid.dtype, device=dev))
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=starts.dtype, device=dev)])
    counts = ends - starts
    num_tiles = -(-n // t) + g3
    tpg = -(-counts // t)
    tile_end = torch.cumsum(tpg, 0)
    tiles = torch.arange(num_tiles, dtype=tile_end.dtype, device=dev)
    gid = torch.searchsorted(tile_end, tiles, right=True).clamp_max(g3 - 1)
    tile_rank = tiles - (tile_end[gid] - tpg[gid])
    slot = tile_rank[:, None] * t + torch.arange(t, device=dev)[None, :]
    valid = slot < counts[gid][:, None]
    src = torch.where(valid, starts[gid][:, None] + slot, torch.full_like(slot, n))
    return gid, src, valid, counts


def build_dispatch(vid: torch.Tensor, g3: int, t: int):
    """``(order, gid, src, valid, counts)``: a stable sort of the points by
    network, then the tile plan of the sorted ids
    (``nerf_tpu.models.kilonerf.build_dispatch``)."""
    order = torch.sort(vid, stable=True).indices
    gid, src, valid, counts = dispatch_plan_sorted(vid[order], g3, t)
    return order, gid, src, valid, counts


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one row of zeros appended (the empty slots' source)."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


class KiloNeRFModel(nn.Module):
    def __init__(self, grid_res: int = 8, pos_encoding_dim: int = 10,
                 dir_encoding_dim: int = 4, hidden_dim: int = 32,
                 compute_dtype: str = "float32", dispatch_tile: int = 128,
                 reference_init: bool = False,
                 domain: tuple = (-1.0, 1.0),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.grid_res = int(grid_res)
        self.pos_encoding_dim = pos_encoding_dim
        self.dir_encoding_dim = dir_encoding_dim
        self.hidden_dim = hidden_dim
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.dispatch_tile = int(dispatch_tile)
        self.reference_init = reference_init
        self.domain = (float(domain[0]), float(domain[1]))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g, h = self.num_networks, hidden_dim
        self.l1 = BatchedLinear(g, self.pos_in, h, generator)
        self.l2 = BatchedLinear(g, h, h, generator)
        # h features + 1 density channel, the fused head of models/nerf.py
        self.trunk = BatchedLinear(g, h, h + 1, generator)
        self.rgb1 = BatchedLinear(g, h + self.dir_in, h, generator)
        self.rgb2 = BatchedLinear(g, h, 3, generator)
        # the dead-ReLU guard of the other families, once per network
        if not reference_init:
            with torch.no_grad():
                self.trunk.b[:, -1] = 0.5

    @property
    def num_networks(self) -> int:
        return self.grid_res ** 3

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def layer(self, name: str) -> BatchedLinear:
        return getattr(self, name)

    def voxel_of(self, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(vid, local)`` of points in the model's ``domain`` cube: the
        network id (int64) and the position in that voxel's [-1, 1] frame.
        Points outside the domain go to the border voxel, whose local
        coordinates then reach past [-1, 1]."""
        points = remap_domain(points, self.domain)
        r = self.grid_res
        cell = torch.floor((points + 1.0) * (0.5 * r)).long().clamp(0, r - 1)
        vid = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
        center = (cell.to(points.dtype) + 0.5) * (2.0 / r) - 1.0
        local = (points - center) * r
        return vid, local

    def _head(self, x_feats, d_enc, lin):
        """The layer chain after the encodings; ``lin(name, x)`` applies
        one layer with float32 sums and the float32 bias."""
        x = torch.relu(lin("l1", x_feats))
        x = torch.relu(lin("l2", x))
        x = lin("trunk", x)
        sigma = torch.relu(x[..., -1])
        y = torch.cat([x[..., :-1], d_enc], dim=-1)
        y = torch.relu(lin("rgb1", y))
        rgb = torch.sigmoid(lin("rgb2", y))
        return rgb, sigma

    def apply_pointwise(self, points: torch.Tensor, viewdirs: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """The numerical reference: each point's weights gathered (N, in,
        out), the same products as ``forward``. For tests and small
        batches."""
        shape = points.shape[:-1]
        vid, local = self.voxel_of(points.reshape(-1, 3))
        p_enc = positional_encoding(local, self.pos_encoding_dim)
        d_enc = positional_encoding(viewdirs.reshape(-1, 3), self.dir_encoding_dim)
        cdt = self.cdt

        def lin(name, x):
            lyr = self.layer(name)
            w = round_to(lyr.w[vid], cdt)
            return torch.einsum("ni,nio->no", round_to(x, cdt), w) + lyr.b[vid]

        rgb, sigma = self._head(p_enc, d_enc, lin)
        return rgb.reshape(*shape, 3), sigma.reshape(shape)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,)) through
        the grouped dispatch (``nerf_tpu.models.kilonerf.KiloNeRFModel
        .apply``). ``points`` come normalised by the renderer."""
        shape = points.shape[:-1]
        p = points.reshape(-1, 3)
        d = viewdirs.reshape(-1, 3)
        n = p.shape[0]
        t = self.dispatch_tile
        cdt = self.cdt
        vid, local = self.voxel_of(p)
        order, gid, src, valid, _ = build_dispatch(vid, self.num_networks, t)
        num_tiles = src.shape[0]
        p_enc = positional_encoding(pad_rows(local[order])[src], self.pos_encoding_dim)
        d_enc = positional_encoding(pad_rows(d[order])[src], self.dir_encoding_dim)

        def lin(name, x):
            lyr = self.layer(name)
            w = round_to(lyr.w[gid], cdt)                       # (tiles, in, out)
            return torch.bmm(round_to(x, cdt), w) + lyr.b[gid][:, None, :]

        rgb_t, sigma_t = self._head(p_enc, d_enc, lin)
        # each point's slot in the tile layout: the inverse of src
        orig = pad_rows(order[:, None])[src][..., 0]
        slot_of = torch.zeros(n + 1, dtype=torch.long, device=p.device)
        slot_of[torch.where(valid, orig, torch.full_like(orig, n)).reshape(-1)] = \
            torch.arange(num_tiles * t, device=p.device)
        slot_of = slot_of[:n]
        rgb = rgb_t.reshape(-1, 3)[slot_of]
        sigma = sigma_t.reshape(-1)[slot_of]
        return rgb.reshape(*shape, 3), sigma.reshape(shape)
