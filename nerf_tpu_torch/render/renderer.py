"""Volumetric renderer: sample -> query -> composite.

Counterpart of ``nerf_tpu.render.renderer``: stratified samples (shared or
per-ray jitter), deltas with the 1e10 tail, the componentwise
[near,far] -> [-1,1] position map, exclusive-cumprod transmittance, a white
background, and hierarchical coarse/fine sampling (``merge`` or
``resample``). A pass runs either through the fused render of the model's
family (one kernel on the card, its plain version on the CPU) or through the
unfused path: a field (the model's forward, or a field of
``train/step.py::fused_field_for`` such as ``KiloNeRFField``) + ``composite``.
``render_image`` bounds memory by a Python loop over ``chunk_size`` ray
tiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from nerf_tpu_torch.ops.sampling import (
    deltas_from_t,
    merge_samples,
    normalize_positions,
    sample_pdf,
    sample_positions,
    stratified_sample,
)
from nerf_tpu_torch.ops.volume import CompositeOutput, composite, disparity_from


@dataclass(frozen=True)
class RenderSettings:
    near: float = 2.0
    far: float = 6.0
    num_samples: int = 256
    num_fine_samples: int = 0        # >0 enables hierarchical sampling
    white_background: bool = True
    jitter_mode: str = "per_ray"     # "per_ray" | "shared"
    perturb: bool = True             # False => bin midpoints, deterministic
    chunk_size: int = 8192           # ray tile of full-image renders
    normalize_positions: bool = True
    fine_sampling: str = "merge"     # "merge" | "resample"


class RenderOutput(NamedTuple):
    rgb: torch.Tensor          # (R, 3) final color (fine if hierarchical)
    depth: torch.Tensor        # (R,)
    acc: torch.Tensor          # (R,)
    disparity: torch.Tensor    # (R,)
    rgb_coarse: torch.Tensor   # (R, 3) coarse color (== rgb if coarse-only)


def _render_pass(params, rays_o, rays_d, viewdirs, t, settings: RenderSettings,
                 fused_render=None) -> CompositeOutput:
    """One pass over the samples ``t``. ``params`` is a field: a model or
    any callable ``(points, dirs) -> (rgb, sigma)`` (a ``KiloNeRFField``),
    or, with ``fused_render``, anything that renderer takes (its
    ``pack``)."""
    if fused_render is not None:
        out = fused_render(params, rays_o, rays_d, viewdirs, t)
        rgb, acc, depth = out["rgb"], out["acc"], out["depth"]
        if settings.white_background:
            rgb = rgb + (1.0 - acc[..., None])
        return CompositeOutput(rgb=rgb, weights=out["weights"], depth=depth,
                               acc=acc, disparity=disparity_from(depth, acc))
    points = sample_positions(rays_o, rays_d, t)
    if settings.normalize_positions:
        points = normalize_positions(points, settings.near, settings.far)
    dirs = viewdirs[..., None, :].expand(points.shape)
    rgb, sigma = params(points, dirs)
    return composite(rgb, sigma, deltas_from_t(t), t=t,
                     white_background=settings.white_background)


def _fine_t(settings: RenderSettings, t, weights,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The fine pass's t from the coarse weights (no gradient)."""
    t_mid = 0.5 * (t[..., 1:] + t[..., :-1])
    w_mid = weights[..., 1:-1].detach()
    if settings.fine_sampling == "resample":
        mf = settings.num_samples + settings.num_fine_samples
        num_rays = t.shape[0]
        base = torch.arange(mf, dtype=torch.float32, device=t.device)[None, :]
        if settings.perturb:
            jit = torch.rand((num_rays, mf), generator=generator,
                             device=t.device) * (1.0 - 1e-5)
        else:
            jit = torch.full((1, mf), 0.5, dtype=torch.float32, device=t.device)
        u = ((base + jit) / mf).expand(num_rays, mf)
        return sample_pdf(t_mid, w_mid, mf, u=u).detach()
    if settings.fine_sampling != "merge":
        raise ValueError(f"fine_sampling must be 'merge' or 'resample', got "
                         f"{settings.fine_sampling!r}")
    t_fine = sample_pdf(t_mid, w_mid, settings.num_fine_samples,
                        deterministic=not settings.perturb, generator=generator)
    return merge_samples(t, t_fine.detach())


def render_rays(params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                settings: RenderSettings,
                generator: Optional[torch.Generator] = None,
                fine_params=None, viewdirs: Optional[torch.Tensor] = None,
                fused_render=None) -> RenderOutput:
    """Render a batch of rays (R, 3). ``params`` / ``fine_params`` are
    fields (models, or callables ``(points, dirs) -> (rgb, sigma)``) or what
    ``fused_render`` takes. ``generator`` (on the rays' device) drives the
    stratified jitter and the inverse-CDF draws; ``fine_params`` defaults to
    ``params``; ``viewdirs`` defaults to normalised ``rays_d``."""
    num_rays = rays_o.shape[0]
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = stratified_sample(settings.near, settings.far, settings.num_samples,
                          num_rays, jitter_mode=settings.jitter_mode,
                          perturb=settings.perturb, generator=generator,
                          device=rays_o.device)
    coarse = _render_pass(params, rays_o, rays_d, viewdirs, t, settings,
                          fused_render)
    if settings.num_fine_samples <= 0:
        return RenderOutput(rgb=coarse.rgb, depth=coarse.depth, acc=coarse.acc,
                            disparity=coarse.disparity, rgb_coarse=coarse.rgb)
    t_all = _fine_t(settings, t, coarse.weights, generator)
    fine = _render_pass(fine_params if fine_params is not None else params,
                        rays_o, rays_d, viewdirs, t_all, settings, fused_render)
    return RenderOutput(rgb=fine.rgb, depth=fine.depth, acc=fine.acc,
                        disparity=fine.disparity, rgb_coarse=coarse.rgb)


def render_rays_train(fused_render, params, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, settings: RenderSettings,
                      target: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      fine_params=None, viewdirs: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training loss through the fused train pass(es), as
    ``nerf_tpu.render.renderer.render_rays_train``: ``(loss, mse)`` with
    loss = mse_fine + mse_coarse when hierarchical (else both the coarse
    mse). Each pass is one train-kernel launch on the card (forward, MSE
    and backward together); ``loss.backward()`` hands the parameters the
    gradients that pass computed. The fine samples come from the coarse
    pass's weights, which carry no gradient."""
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = stratified_sample(settings.near, settings.far, settings.num_samples,
                          rays_o.shape[0], jitter_mode=settings.jitter_mode,
                          perturb=settings.perturb, generator=generator,
                          device=rays_o.device)
    loss_c, aux_c = fused_render.train(params, rays_o, rays_d, viewdirs, t,
                                       target, settings.white_background)
    if settings.num_fine_samples <= 0:
        return loss_c, loss_c
    t_all = _fine_t(settings, t, aux_c["weights"], generator)
    loss_f, _ = fused_render.train(
        fine_params if fine_params is not None else params, rays_o, rays_d,
        viewdirs, t_all, target, settings.white_background)
    return loss_f + loss_c, loss_f


def render_image(params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 settings: RenderSettings,
                 generator: Optional[torch.Generator] = None,
                 fine_params=None, viewdirs: Optional[torch.Tensor] = None,
                 fused_render=None) -> RenderOutput:
    """Render many rays (a full image) in ``chunk_size`` tiles; the last
    tile is ragged. Tiles draw their randomness from ``generator`` in
    turn."""
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    tile = settings.chunk_size
    outs = [
        render_rays(params, rays_o[i:i + tile], rays_d[i:i + tile], settings,
                    generator=generator, fine_params=fine_params,
                    viewdirs=viewdirs[i:i + tile], fused_render=fused_render)
        for i in range(0, rays_o.shape[0], tile)
    ]
    return RenderOutput(*(torch.cat(parts, dim=0) for parts in zip(*outs)))
