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


def remap_domain(p: torch.Tensor, domain: tuple[float, float]) -> torch.Tensor:
    """Affine map of a grid family's ``domain`` cube (lo, hi) onto [-1, 1]
    (``nerf_tpu.models.common.remap_domain``); the identity for (-1, 1)."""
    lo, hi = float(domain[0]), float(domain[1])
    if (lo, hi) == (-1.0, 1.0):
        return p
    return (p - lo) * (2.0 / (hi - lo)) - 1.0


def uniform_init(shape: tuple[int, ...], bound: float,
                 generator: torch.Generator) -> torch.Tensor:
    """A float32 CPU tensor from U(-bound, bound), drawn from ``generator``
    (counterpart of ``nerf_tpu.models.common.uniform_init``)."""
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def _uniform_linear(in_dim: int, out_dim: int, bound: float,
                    generator: torch.Generator) -> nn.Linear:
    """A CPU ``nn.Linear`` with weight AND bias from U(-bound, bound),
    weight first."""
    # built on the meta device so that torch's own init draws nothing from
    # the global generator; the values come from ``generator`` alone
    layer = nn.Linear(in_dim, out_dim, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            p.copy_(uniform_init(tuple(p.shape), bound, generator))
    return layer


def linear_init(in_dim: int, out_dim: int,
                generator: torch.Generator) -> nn.Linear:
    """A CPU ``nn.Linear`` under torch's own default law, weight AND bias
    from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from ``generator`` (a
    CPU generator; move the module afterwards)."""
    return _uniform_linear(in_dim, out_dim, 1.0 / (in_dim ** 0.5), generator)


def siren_init(in_dim: int, out_dim: int, w0: float, is_first: bool,
               generator: torch.Generator, c: float = 6.0) -> nn.Linear:
    """A CPU ``nn.Linear`` under the SIREN law of
    ``nerf_tpu.models.common.siren_init``: weight AND bias from U(-b, b)
    with b = 1/in_dim for the first layer, else sqrt(c/in_dim)/w0."""
    bound = (1.0 / in_dim) if is_first else ((c / in_dim) ** 0.5 / w0)
    return _uniform_linear(in_dim, out_dim, bound, generator)


def skip_trunk_init(pos_in: int, hidden: int, head_out: int, reference_init: bool,
                    generator: torch.Generator) -> tuple:
    """``(trunk1, trunk2, head)``: the 5 + 3 skip-connected field trunk of the
    grid-bakeable families (FastNeRF's F_pos, PlenOctrees' NeRF-SH), as
    ``nerf_tpu.models.common.skip_trunk_init``: ``trunk1`` 5 layers from the
    encoded position, ``trunk2`` 3 layers from [features, encoded position],
    ``head`` to ``head_out`` columns, column 0 the density. Drawn from
    ``generator`` in that order; the density bias starts at 0.5 unless
    ``reference_init``."""
    trunk1 = nn.ModuleList([linear_init(pos_in, hidden, generator)]
                           + [linear_init(hidden, hidden, generator) for _ in range(4)])
    trunk2 = nn.ModuleList([linear_init(hidden + pos_in, hidden, generator)]
                           + [linear_init(hidden, hidden, generator) for _ in range(2)])
    head = linear_init(hidden, head_out, generator)
    if not reference_init:
        with torch.no_grad():
            head.bias[0] = 0.5
    return trunk1, trunk2, head


def skip_trunk_apply(model: nn.Module, p_enc: torch.Tensor,
                     compute_dtype: torch.dtype) -> tuple:
    """The trunk of ``skip_trunk_init`` (``model.trunk1``, ``trunk2``,
    ``head``) on encoded positions: ``(sigma (...,), tail (..., head_out -
    1))``, the relu density of head column 0 and the family's raw tail."""
    x = p_enc
    for lyr in model.trunk1:
        x = torch.relu(linear(lyr, x, compute_dtype))
    x = torch.cat([x, p_enc], dim=-1)
    for lyr in model.trunk2:
        x = torch.relu(linear(lyr, x, compute_dtype))
    x = linear(model.head, x, compute_dtype)
    return torch.relu(x[..., 0]), x[..., 1:]
