"""The classic NeRF MLP with its view-direction branch, as an ``nn.Module``.

Counterpart of ``nerf_tpu.models.nerf.NeRFModel`` (same architecture, same
compute-dtype rules):

  * inputs: encoded points (3+6*L_pos = 63 for L=10), encoded dirs (27 for L=4);
  * block1: Linear(63,h) + 4x Linear(h,h), ReLU after each;
  * block2: skip-concat of the encoded points -> Linear(h+63,h) + 3x
    Linear(h,h) with ReLU, then Linear(h,h+1) with no activation;
  * density = relu(last channel);
  * rgb head: concat(features, dirs_enc) -> Linear(h+27,h/2) + ReLU ->
    Linear(h/2,3) -> sigmoid.

Submodules follow the reference layout (``block1.{0,2,4,6,8}``,
``block2.{0,2,4,6,8}``, ``rgb_head.{0,2}``), so a state dict of the
reference's torch NeRF loads as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_tpu_torch.models.common import linear, linear_init
from nerf_tpu_torch.models.encoding import encoded_dim, positional_encoding


def _dtype(name: str) -> torch.dtype:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)
    if dt is None:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
    return dt


class NeRFModel(nn.Module):
    def __init__(self, pos_encoding_dim: int = 10, dir_encoding_dim: int = 4,
                 hidden_dim: int = 256, compute_dtype: str = "float32",
                 reference_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pos_encoding_dim = pos_encoding_dim
        self.dir_encoding_dim = dir_encoding_dim
        self.hidden_dim = hidden_dim
        self.compute_dtype = compute_dtype
        self.cdt = _dtype(compute_dtype)
        self.reference_init = reference_init
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        h = hidden_dim

        def stack(dims, relu_last=True):
            mods = []
            for i, (a, b) in enumerate(dims):
                mods.append(linear_init(a, b, generator))
                if relu_last or i < len(dims) - 1:
                    mods.append(nn.ReLU())
            return nn.Sequential(*mods)

        self.block1 = stack([(self.pos_in, h)] + [(h, h)] * 4)
        self.block2 = stack([(h + self.pos_in, h)] + [(h, h)] * 3 + [(h, h + 1)],
                            relu_last=False)
        self.rgb_head = stack([(h + self.dir_in, h // 2), (h // 2, 3)],
                              relu_last=False)
        # Density-channel bias starts at +0.5 so that no draw puts every
        # point on the dead side of the density ReLU at init;
        # reference_init keeps torch's raw draw instead.
        if not reference_init:
            with torch.no_grad():
                self.block2[8].bias[-1] = 0.5

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def linears(self, block: nn.Sequential) -> list[nn.Linear]:
        return [m for m in block if isinstance(m, nn.Linear)]

    def forward(self, points: torch.Tensor, viewdirs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """points/viewdirs: (..., 3) -> (rgb (..., 3), sigma (...,)).

        ``points`` come normalised to [-1,1] by the renderer; ``viewdirs``
        are unit world-space directions."""
        cdt = self.cdt
        p_enc = positional_encoding(points, self.pos_encoding_dim)
        d_enc = positional_encoding(viewdirs, self.dir_encoding_dim)

        x = p_enc
        for lyr in self.linears(self.block1):
            x = torch.relu(linear(lyr, x, cdt))
        x = torch.cat([x, p_enc], dim=-1)
        b2 = self.linears(self.block2)
        for lyr in b2[:-1]:
            x = torch.relu(linear(lyr, x, cdt))
        x = linear(b2[-1], x, cdt)

        sigma = torch.relu(x[..., -1])
        feat = x[..., :-1]
        r0, r1 = self.linears(self.rgb_head)
        y = torch.relu(linear(r0, torch.cat([feat, d_enc], dim=-1), cdt))
        rgb = torch.sigmoid(linear(r1, y, cdt))
        return rgb, sigma
