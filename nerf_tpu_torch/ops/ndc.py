"""NDC ray warping for forward-facing (LLFF) scenes, as
``nerf_tpu.ops.ndc``: the standard NeRF normalised-device-coordinate
reparameterisation, so that a forward-facing capture is sampled uniformly
in [0, 1] disparity.
"""

from __future__ import annotations

import torch


def ndc_rays(h: int, w: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World rays (..., 3) looking down -z -> NDC ``(rays_o, rays_d)``: the
    origins shifted to the near plane at ``near``, then the projective warp
    of an ``h`` x ``w`` camera of ``focal`` pixels; sample t in [0, 1]
    afterwards. The float32 operations of nerf_tpu's, in its order."""
    tshift = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + tshift[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -focal / (0.5 * w) * ox / oz
    o1 = -focal / (0.5 * h) * oy / oz
    # a 0-dim tensor over oz divides as JAX's weak-typed scalar does (a
    # Python scalar over a tensor would multiply by the reciprocal)
    o2 = 1.0 + oz.new_tensor(2.0 * near) / oz

    d0 = -focal / (0.5 * w) * (dx / dz - ox / oz)
    d1 = -focal / (0.5 * h) * (dy / dz - oy / oz)
    d2 = oz.new_tensor(-2.0 * near) / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
