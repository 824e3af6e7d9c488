"""Frequency (positional) encoding, in the layout of
``nerf_tpu.models.encoding``: ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]``
on the feature axis, identity first and no pi factor, ``D*(1+2L)`` features.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Encode ``x`` (..., D) to (..., D*(1+2*num_freqs))."""
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]            # (..., L, D)
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., L, 2, D)
    sc = sc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def encoded_dim(input_dim: int, num_freqs: int) -> int:
    return input_dim * (1 + 2 * num_freqs)
