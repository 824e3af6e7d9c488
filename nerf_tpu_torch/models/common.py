"""Shared building blocks of the port's models.

``linear`` keeps the compute-dtype semantics of ``nerf_tpu.models.common``:
inputs and weight are rounded to the compute dtype, the products are summed
in float32, and the float32 bias is added afterwards. The sum runs as a
float32 matmul of the rounded values: a product of two bfloat16 numbers is
exact in float32, so this is a bfloat16 matmul with float32 accumulation.
"""

from __future__ import annotations

import torch
from torch import nn


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (nearest even) and held as float32."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def linear(layer: nn.Linear, x: torch.Tensor,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ W.T + b`` with matmul inputs in ``compute_dtype`` and float32
    accumulation; the bias is added in float32."""
    w = round_to(layer.weight, compute_dtype)
    return round_to(x, compute_dtype) @ w.T + layer.bias


def linear_init(in_dim: int, out_dim: int,
                generator: torch.Generator) -> nn.Linear:
    """A CPU ``nn.Linear`` under torch's own default law, weight AND bias
    from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from ``generator`` (a
    CPU generator; move the module afterwards)."""
    # built on the meta device so that torch's own init draws nothing from
    # the global generator; the values come from ``generator`` alone
    layer = nn.Linear(in_dim, out_dim, device="meta").to_empty(device="cpu")
    bound = 1.0 / (in_dim ** 0.5)
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            p.uniform_(-bound, bound, generator=generator)
    return layer
