"""Volume compositing, as ``nerf_tpu.ops.volume``:

  * ``alpha_i = 1 - exp(-sigma_i * delta_i)``
  * ``T_i = exclusive-cumprod(1 - alpha)``
  * ``w_i = T_i * alpha_i``; ``rgb = sum_i w_i c_i``
  * a white background adds ``1 - sum_i w_i``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor        # (R, 3) composited color
    weights: torch.Tensor    # (R, S) per-sample compositing weights
    depth: torch.Tensor      # (R,)  expected termination depth
    acc: torch.Tensor        # (R,)  accumulated opacity sum(w)
    disparity: torch.Tensor  # (R,)  1 / max(depth/acc, eps)


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative product shifted right by one with a leading 1."""
    p = torch.cumprod(x, dim=dim).movedim(dim, -1)
    out = torch.cat([torch.ones_like(p[..., :1]), p[..., :-1]], dim=-1)
    return out.movedim(-1, dim)


def disparity_from(depth: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)


def composite(colors: torch.Tensor, densities: torch.Tensor,
              deltas: torch.Tensor, t: torch.Tensor | None = None,
              white_background: bool = True) -> CompositeOutput:
    """colors (R, S, 3), densities (R, S), deltas (R, S) or (S,), t (R, S)."""
    deltas = torch.broadcast_to(deltas, densities.shape)
    alpha = 1.0 - torch.exp(-densities * deltas)
    trans = exclusive_cumprod(1.0 - alpha, dim=-1)
    weights = trans * alpha

    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    acc = torch.sum(weights, dim=-1)
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])
    depth = torch.zeros_like(acc) if t is None else torch.sum(weights * t, dim=-1)
    return CompositeOutput(rgb=rgb, weights=weights, depth=depth, acc=acc,
                           disparity=disparity_from(depth, acc))
