"""The GaborNet (multiplicative filter network, Gabor variant) NeRF field, as
an ``nn.Module``.

Counterpart of ``nerf_tpu.models.gabor.GaborModel`` (same architecture, same
compute-dtype rules). Each stage MULTIPLIES a linear transform of the hidden
state by a Gabor filter of the raw input:

  * z_1 = g_1(x), z_{i+1} = (z_i W_i + b_i) * g_{i+1}(x), 8 stages;
  * g_i(x) = sin(x . omega_i + phi_i) * exp(-gamma_i / 2 * ||x - mu_i||^2),
    computed in float32 (the filters are never rounded to the compute
    dtype; the linear layers are, as the JAX ``linear``);
  * density = relu(Linear(h, 1)) * sigma_mul (10) on the last z;
  * feature remap Linear(h, h), no activation; rgb head relu(Linear(h + 27,
    h/2)) on concat(features, dirs_enc), then sigmoid(Linear(h/2, 3) *
    rgb_mul); directions keep the L=4 frequency encoding;
  * init (``_gabor_filter_init``): per stage fscale = input_scale/sqrt(n),
    gamma ~ Gamma(alpha/n, 1)/beta, omega = N(0,1) * fscale * sqrt(gamma),
    phi ~ U(-pi, pi), mu ~ U(-1, 1); the linear layers keep torch's default
    law; the density bias starts at +0.5 unless ``reference_init``.

Every draw comes from the module's ``torch.Generator``, in the JAX init's
order (filters, linears, sigma, remap, rgb0, rgb1). The JAX key stream is not
reproduced, only the laws; the tests carry weights across with
``models/convert.py``. Submodules carry the names of the JAX pytree
(``filters.{i}.{omega,phi,mu,gamma}``, ``linears.{i}``, ``sigma``, ``remap``,
``rgb0``, ``rgb1``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nerf_tpu_torch.models.common import linear, linear_init, uniform_init
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.nerf import _dtype


def sample_gamma(shape: int, alpha: float, generator: torch.Generator) -> torch.Tensor:
    """``shape`` float32 draws from Gamma(alpha, 1) on ``generator``:
    Marsaglia and Tsang's squeeze method (float64), with the boost
    X * U^(1/alpha) for a shape below 1 (X ~ Gamma(alpha + 1)). Rejected
    draws are redrawn in rounds until every slot is filled."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float64)
    todo = torch.arange(shape)
    while todo.numel():
        n = todo.numel()
        x = torch.randn(n, generator=generator, dtype=torch.float64)
        u = torch.rand(n, generator=generator, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        out = out * u ** (1.0 / alpha)
    return out.float()


class GaborFilter(nn.Module):
    """One Gabor filter bank of 3-D inputs (``out_dim`` filters):
    frequencies ``omega`` (3, out), phases ``phi`` (out,), centres ``mu``
    (out, 3) and bandwidths ``gamma`` (out,)."""

    def __init__(self, out_dim: int, input_scale: float, alpha: float,
                 beta: float, generator: torch.Generator):
        super().__init__()
        gamma = sample_gamma(out_dim, alpha, generator) / beta
        omega = (torch.randn(3, out_dim, generator=generator) * input_scale
                 * torch.sqrt(gamma)[None, :])
        self.omega = nn.Parameter(omega)
        self.phi = nn.Parameter(uniform_init((out_dim,), math.pi, generator))
        self.mu = nn.Parameter(uniform_init((out_dim, 3), 1.0, generator))
        self.gamma = nn.Parameter(gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """g(x) for x (..., 3) -> (..., out), float32."""
        arg = x @ self.omega + self.phi
        d2 = torch.sum((x[..., None, :] - self.mu) ** 2, dim=-1)
        return torch.sin(arg) * torch.exp(-0.5 * self.gamma * d2)


class GaborModel(nn.Module):
    def __init__(self, num_layers: int = 8, hidden_dim: int = 256,
                 dir_encoding_dim: int = 4, sigma_mul: float = 10.0,
                 rgb_mul: float = 1.0, input_scale: float = 64.0,
                 alpha: float = 6.0, beta: float = 1.0,
                 compute_dtype: str = "float32", reference_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.dir_encoding_dim = dir_encoding_dim
        self.sigma_mul = float(sigma_mul)
        self.rgb_mul = float(rgb_mul)
        self.input_scale = float(input_scale)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.reference_init = reference_init
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        h, n = hidden_dim, num_layers
        # per-stage frequency scale input_scale/sqrt(n), so that the PRODUCT
        # of n filters covers the target bandwidth (MFN sec. 3)
        fscale = self.input_scale / math.sqrt(n)
        self.filters = nn.ModuleList(
            [GaborFilter(h, fscale, self.alpha / n, self.beta, generator)
             for _ in range(n)])
        self.linears = nn.ModuleList([linear_init(h, h, generator)
                                      for _ in range(n - 1)])
        self.sigma = linear_init(h, 1, generator)
        # the dead-ReLU guard of the other families
        if not reference_init:
            with torch.no_grad():
                self.sigma.bias[0] = 0.5
        self.remap = linear_init(h, h, generator)
        self.rgb0 = linear_init(h + self.dir_in, h // 2, generator)
        self.rgb1 = linear_init(h // 2, 3, generator)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """points/viewdirs: (..., 3) -> (rgb (..., 3), sigma (...,)).

        ``points`` come normalised by the renderer; the filters take them in
        float32, the linear layers round their inputs to the compute dtype
        (the last z too, before the density row, as the JAX module does)."""
        cdt = self.cdt
        z = self.filters[0](points)
        for lyr, f in zip(self.linears, self.filters[1:]):
            z = linear(lyr, z, cdt) * f(points)
        sigma = torch.relu(linear(self.sigma, z, cdt)) * self.sigma_mul
        sigma = sigma[..., 0]
        feat = linear(self.remap, z, cdt)
        d_enc = positional_encoding(viewdirs, self.dir_encoding_dim)
        y = torch.cat([feat, d_enc], dim=-1)
        y = torch.relu(linear(self.rgb0, y, cdt))
        rgb = torch.sigmoid(linear(self.rgb1, y, cdt) * self.rgb_mul)
        return rgb, sigma
