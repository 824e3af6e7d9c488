"""Ray sampling: stratified (coarse) and inverse-CDF importance (fine).

Counterpart of ``nerf_tpu.ops.sampling``: ``num_samples + 1`` uniform bin
edges in [near, far] with one jitter per bin, deltas ``t[i+1]-t[i]`` with a
1e10 tail, the componentwise [near, far] -> [-1, 1] position map, and the
original NeRF's inverse-CDF draw merged with the coarse samples. Random
draws come from an explicit ``torch.Generator``; torch and JAX draw
different numbers from the same seed, so parity tests inject ``u``.
"""

from __future__ import annotations

import torch


def stratified_sample(near: float, far: float, num_samples: int, num_rays: int,
                      jitter_mode: str = "per_ray", perturb: bool = True,
                      generator: torch.Generator | None = None,
                      device: torch.device | str = "cpu",
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """Stratified t-samples, (num_rays, num_samples). ``shared`` draws one
    jitter vector for all rays; ``perturb=False`` takes bin midpoints. ``u``
    gives the jitter ((num_rays or 1, num_samples) in [0, 1)) instead of a
    draw from ``generator``."""
    edges = torch.linspace(near, far, num_samples + 1, dtype=torch.float32,
                           device=device)
    lower = edges[:-1]
    width = edges[1:] - edges[:-1]
    if not perturb:
        u = torch.full((1, num_samples), 0.5, dtype=torch.float32, device=device)
    elif u is None:
        rows = 1 if jitter_mode == "shared" else num_rays
        u = torch.rand((rows, num_samples), generator=generator, device=device)
    t = lower[None, :] + width[None, :] * u
    return t.expand(num_rays, num_samples).contiguous()


def deltas_from_t(t: torch.Tensor, inf_delta: float = 1e10) -> torch.Tensor:
    """``t[i+1]-t[i]`` along the last axis with ``inf_delta`` appended."""
    d = t[..., 1:] - t[..., :-1]
    return torch.cat([d, torch.full_like(t[..., :1], inf_delta)], dim=-1)


def sample_positions(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Points ``o + t*d``, (num_rays, num_samples, 3)."""
    return rays_o[..., None, :] + t[..., :, None] * rays_d[..., None, :]


def normalize_positions(p: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Componentwise map of xyz from [near, far] to [-1, 1]."""
    return 2.0 * (p - near) / (far - near) - 1.0


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, num_samples: int,
               deterministic: bool = False, u: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-transform sampling of a piecewise-constant PDF.

    bins: (R, M+1) edges; weights: (R, M). ``u`` (R, num_samples) in [0, 1)
    overrides both draw modes; sorted ``u`` gives monotone t. Returns
    (R, num_samples) t-values."""
    weights = weights + 1e-5  # no NaN from empty rays
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (R, M+1)

    num_rays = cdf.shape[0]
    if u is None:
        if deterministic:
            u = torch.linspace(0.0, 1.0 - 1e-5, num_samples,
                               dtype=torch.float32, device=cdf.device)
            u = u.expand(num_rays, num_samples)
        else:
            u = torch.rand((num_rays, num_samples), generator=generator,
                           device=cdf.device) * (1.0 - 1e-5)
    u = u.contiguous()

    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(idx, 0, cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    frac = (u - cdf_below) / denom
    return bins_below + frac * (bins_above - bins_below)


def merge_samples(t_coarse: torch.Tensor, t_fine: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse and fine t-samples along the last axis (a
    stable sort: ties keep coarse before fine)."""
    x = torch.cat([t_coarse, t_fine], dim=-1)
    return torch.sort(x, dim=-1, stable=True).values
