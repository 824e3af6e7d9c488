"""Render settings from a config (``nerf_tpu.train.loop``'s helpers). The
training loop itself comes with the training slice."""

from __future__ import annotations

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.render.renderer import RenderSettings


def resolve_eval_chunk(cfg: Config) -> int:
    """Ray tile of full-image renders: ``eval_chunk_size`` when set, else
    ``chunk_size`` (the reference's memory bound)."""
    if cfg.eval_chunk_size > 0:
        return cfg.eval_chunk_size
    return cfg.chunk_size


def render_settings_from_config(cfg: Config, ndc: bool = False) -> RenderSettings:
    return RenderSettings(
        near=cfg.near,
        far=cfg.far,
        num_samples=cfg.num_samples,
        num_fine_samples=cfg.num_fine_samples,
        white_background=cfg.white_background and not ndc,
        jitter_mode=cfg.jitter_mode,
        perturb=cfg.perturb,
        chunk_size=resolve_eval_chunk(cfg),
        normalize_positions=not ndc,
        fine_sampling=cfg.fine_sampling,
    )
