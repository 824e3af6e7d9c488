"""Occupancy-guided sampling: a static sample count, moved into occupied space.

Counterpart of ``nerf_tpu.ops.occupancy``. A bake samples a field's density
on a dense lattice over the model-input-space ``domain`` cube
(``models/registry.py::grid_domain``), thresholds it into a {0, 1} grid and
dilates it by a 3^3 max-pool; a render then scores ``num_bins`` t-midpoints
per ray against the grid (trilinear, floored at ``floor`` so that content
the bake missed still gets samples) and draws the coarse pass's
``num_samples`` from that piecewise-constant PDF with sorted stratified
quantiles, so t stays monotonic for the compositor. The fused render and
train kernels take that t unchanged: occupancy only moves the samples.

The bake evaluates the field in chunks of 65,536 points: through a field of
``train/step.py::fused_field_for`` (the forward kernel of ``NerfField``,
``SirenField`` or ``GaborField`` for a NeRF, a SIREN or a GaborNet at
hidden 256 on the card, four launches for a 64^3 grid) or through the
module. The lookup is plain gathers; no kernel of the JAX package is
behind it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.common import remap_domain
from nerf_tpu_torch.ops.sampling import normalize_positions, sample_pdf


class OccupancyGrid(NamedTuple):
    """A baked binary occupancy prior over the ``domain`` cube plus the
    sampling knobs. Pass to ``render_rays(occupancy=...)`` /
    ``make_eval_render(occupancy=...)``."""

    grid: torch.Tensor           # (R, R, R, 1) float32 in {0, 1}
    domain: tuple = (-1.0, 1.0)  # cube the grid spans (model input space)
    num_bins: int = 64           # t-bins scored per ray
    floor: float = 1e-2          # minimum bin weight (prior, not a mask)


def lattice(grid_res: int, domain: tuple, device=None) -> torch.Tensor:
    """The (R^3, 3) lattice of a bake: ``linspace`` over the domain on each
    axis, ``meshgrid(indexing="ij")`` order."""
    lin = torch.linspace(float(domain[0]), float(domain[1]), grid_res,
                         dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                       dim=-1).reshape(-1, 3)


@torch.no_grad()
def bake_occupancy(sigma_fn, grid_res: int = 64, domain: tuple = (-1.0, 1.0),
                   threshold: float = 1e-2, dilate: int = 1, chunk: int = 65536,
                   device=None) -> torch.Tensor:
    """Sample ``sigma_fn(pts (N, 3) in domain^3) -> (N,)`` on a dense
    lattice in chunks of ``chunk`` points and threshold into a {0, 1} grid
    (R, R, R, 1), dilated by ``dilate`` cells (a 3^3 max-pool per step, SAME
    padding) so that surfaces straddling a cell face keep their
    neighbourhood sampled."""
    r = grid_res
    pts = lattice(r, domain, device)
    sigma = torch.cat([sigma_fn(pts[i:i + chunk]).reshape(-1)
                       for i in range(0, pts.shape[0], chunk)])
    occ = (sigma > threshold).float().reshape(1, 1, r, r, r)
    for _ in range(dilate):
        occ = F.max_pool3d(occ, kernel_size=3, stride=1, padding=1)
    return occ.reshape(r, r, r, 1)


def sigma_field(field):
    """Adapt a field ``(points, dirs) -> (rgb, sigma)`` to
    ``bake_occupancy``'s ``pts -> sigma``, querying with directions (0, 0,
    1) (density is view-independent in every family)."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        dirs = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype,
                            device=pts.device).expand(pts.shape)
        return field(pts, dirs)[1]

    return fn


def _occ_trilinear(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of the (R, R, R, 1) grid at ``p`` (N, 3) in [-1, 1]^3
    with the clamp and corner law of ``nerf_tpu.ops.occupancy``: positions
    clamped to the grid, the lower corner clamped to R - 2, the z-lerp of
    each (x, y) corner's column, then the four corners in order. (The JAX
    package gathers whole z-columns to dodge XLA's tiny-slice gathers on
    the TPU; here each corner's two z-values are gathered alone.)"""
    r = grid.shape[0]
    flat = grid.reshape(-1)
    x = torch.clamp((p + 1.0) * 0.5 * (r - 1), 0.0, r - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, r - 2)
    f = x - x0.to(x.dtype)
    fz = f[:, 2]
    out = torch.zeros(p.shape[0], dtype=grid.dtype, device=grid.device)
    for dx in (0, 1):
        for dy in (0, 1):
            w_xy = ((f[:, 0] if dx else 1.0 - f[:, 0])
                    * (f[:, 1] if dy else 1.0 - f[:, 1]))
            at = ((x0[:, 0] + dx) * r + (x0[:, 1] + dy)) * r + x0[:, 2]
            out = out + w_xy * (flat[at] * (1.0 - fz) + flat[at + 1] * fz)
    return out


def occupancy_t(occ: OccupancyGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                near: float, far: float, num_samples: int, normalize: bool = True,
                perturb: bool = True, generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_rays, num_samples) monotonic t-values concentrated where the
    occupancy prior is nonzero: the drop-in replacement for
    ``stratified_sample`` in the coarse pass. With ``perturb`` the stratified
    jitter is drawn from ``generator``, or given as ``u`` (num_rays,
    num_samples) in [0, 1) (tests inject the JAX draws); without it the
    quantiles are the strata's midpoints."""
    num_rays = rays_o.shape[0]
    m = occ.num_bins
    dev = rays_o.device
    edges = torch.linspace(near, far, m + 1, dtype=torch.float32, device=dev)
    mids = 0.5 * (edges[1:] + edges[:-1])
    pts = rays_o[:, None, :] + mids[None, :, None] * rays_d[:, None, :]
    if normalize:
        pts = normalize_positions(pts, near, far)
    pts = remap_domain(pts, occ.domain)
    w = _occ_trilinear(occ.grid, pts.reshape(-1, 3)).reshape(num_rays, m)
    w = torch.clamp(w, min=occ.floor)
    base = torch.arange(num_samples, dtype=torch.float32, device=dev)[None]
    if not perturb:
        jit = torch.full((1, num_samples), 0.5, dtype=torch.float32, device=dev)
    elif u is not None:
        jit = u
    else:
        jit = torch.rand((num_rays, num_samples), generator=generator, device=dev)
    q = torch.clamp((base + jit) / num_samples, max=1.0 - 1e-5)
    bins = edges.expand(num_rays, m + 1)
    return sample_pdf(bins, w, num_samples, u=q.expand(num_rays, num_samples))
