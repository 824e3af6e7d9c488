"""The SIREN variant of NeRF, as an ``nn.Module``.

Counterpart of ``nerf_tpu.models.siren.SirenModel`` (same architecture, same
compute-dtype rules):

  * base: 8 sine layers on the RAW 3-D points (no positional encoding),
    h = sin(w0 (x W + b)), w0 = 30 on the first layer and 1 after it;
  * density = relu(Linear(h, 1)) * sigma_mul (10);
  * feature remap: Linear(h, h), no activation;
  * rgb head: a sine layer Linear(h + 27, h/2) with the hidden w0 on
    concat(features, dirs_enc), then Linear(h/2, 3);
    rgb = sigmoid(. * rgb_mul) (rgb_mul = 1);
  * directions keep the L=4 frequency encoding;
  * SIREN init: weight AND bias from U(-b, b), b = 1/in_dim for the first
    layer, sqrt(6/in_dim)/w0 for the others; the density and output layers
    keep torch's default law; the density bias starts at +0.5 unless
    ``reference_init``.

Submodules carry the names of the JAX pytree (``base.{0..7}``, ``sigma``,
``remap``, ``rgb0``, ``rgb1``).
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_tpu_torch.models.common import linear, linear_init, siren_init
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding
from nerf_tpu_torch.models.nerf import _dtype


class SirenModel(nn.Module):
    def __init__(self, num_layers: int = 8, hidden_dim: int = 256,
                 dir_encoding_dim: int = 4, sigma_mul: float = 10.0,
                 rgb_mul: float = 1.0, w0: float = 30.0, hidden_w0: float = 1.0,
                 compute_dtype: str = "float32", reference_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.dir_encoding_dim = dir_encoding_dim
        self.sigma_mul = float(sigma_mul)
        self.rgb_mul = float(rgb_mul)
        self.w0 = float(w0)
        self.hidden_w0 = float(hidden_w0)
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.reference_init = reference_init
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        h = hidden_dim
        self.base = nn.ModuleList(
            [siren_init(3, h, self.w0, True, generator)]
            + [siren_init(h, h, self.hidden_w0, False, generator)
               for _ in range(num_layers - 1)])
        self.sigma = linear_init(h, 1, generator)
        # Density bias starts at +0.5 so that no draw puts every point on the
        # dead side of the density ReLU at init; reference_init keeps the
        # raw draw instead.
        if not reference_init:
            with torch.no_grad():
                self.sigma.bias[0] = 0.5
        self.remap = linear_init(h, h, generator)
        self.rgb0 = siren_init(h + self.dir_in, h // 2, self.hidden_w0, False,
                               generator)
        self.rgb1 = linear_init(h // 2, 3, generator)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    @property
    def w0s(self) -> tuple[float, ...]:
        """w0 of each base layer."""
        return (self.w0,) + (self.hidden_w0,) * (self.num_layers - 1)

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """points/viewdirs: (..., 3) -> (rgb (..., 3), sigma (...,)).

        ``points`` come normalised to [-1,1] by the renderer (and are
        rounded to the compute dtype by the first layer, as the JAX
        ``linear`` rounds them); ``viewdirs`` are unit world-space
        directions."""
        cdt = self.cdt
        x = points
        for lyr, w0 in zip(self.base, self.w0s):
            x = torch.sin(w0 * linear(lyr, x, cdt))
        sigma = torch.relu(linear(self.sigma, x, cdt)) * self.sigma_mul
        sigma = sigma[..., 0]
        feat = linear(self.remap, x, cdt)
        d_enc = positional_encoding(viewdirs, self.dir_encoding_dim)
        y = torch.cat([feat, d_enc], dim=-1)
        y = torch.sin(self.hidden_w0 * linear(self.rgb0, y, cdt))
        rgb = torch.sigmoid(linear(self.rgb1, y, cdt) * self.rgb_mul)
        return rgb, sigma
