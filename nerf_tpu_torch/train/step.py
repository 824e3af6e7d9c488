"""The full-image render behind validation, eval and serving.

Counterpart of ``nerf_tpu.train.step.make_eval_render`` for one device.
There is no probe and no downgrade: a NeRF renders through the fused
render (the CUDA kernel for CUDA tensors, which raises on shapes it does
not cover; its plain version for CPU tensors) unless the caller asks for
the unfused module path with ``fused=False``.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
from nerf_tpu_torch.render.renderer import RenderOutput, RenderSettings, render_image


def make_eval_render(model, settings: RenderSettings, fused: bool = True):
    """Returns ``render(params, fine_params, rays_o, rays_d, generator=None,
    viewdirs=None) -> RenderOutput``, where ``params``/``fine_params`` are
    ``NeRFModel``s (``fine_params`` None: the coarse model renders both
    passes). Memory is bounded by ``settings.chunk_size`` ray tiles."""
    fused_render = None
    if fused:
        fused_render = FusedNerfRender(model, settings.near, settings.far,
                                       normalize=settings.normalize_positions)

    @torch.no_grad()
    def render(params, fine_params, rays_o: torch.Tensor, rays_d: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               viewdirs: Optional[torch.Tensor] = None) -> RenderOutput:
        if fused_render is not None:
            # pack the weights once per image, not once per tile
            params = fused_render.pack(params)
            if fine_params is not None:
                fine_params = fused_render.pack(fine_params)
        return render_image(params, rays_o, rays_d, settings,
                            generator=generator, fine_params=fine_params,
                            viewdirs=viewdirs, fused_render=fused_render)

    return render
