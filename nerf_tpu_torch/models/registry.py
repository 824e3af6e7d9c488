"""Model construction by name. ``nerf``, ``siren``, ``gabor``, ``kilonerf``
and ``plenoxels`` are ported; every other family of
``nerf_tpu.models.registry`` raises and names the ROADMAP row (queue 1)
that will port it."""

from __future__ import annotations

import inspect

import torch
from torch import nn

from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
from nerf_tpu_torch.models.siren import SirenModel

MODEL_REGISTRY = {"nerf": NeRFModel, "siren": SirenModel, "gabor": GaborModel,
                  "kilonerf": KiloNeRFModel, "plenoxels": PlenoxelsModel}

_NOT_YET = {
    "fastnerf": "row 13 (grid families)",
    "plenoctree": "row 13 (grid families)",
    "ngp": "row 13 (grid families)",
}


def create_model(model_type: str, generator: torch.Generator | None = None,
                 **kwargs) -> nn.Module:
    """A CPU model of the family ``model_type``; kwargs the family does not
    take are dropped (configs carry shared knobs), as in
    ``nerf_tpu.models.registry.create_model``."""
    model_type = model_type.lower()
    if model_type in _NOT_YET:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to nerf_tpu_torch yet "
            f"(ROADMAP.md queue 1, {_NOT_YET[model_type]})")
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"Invalid model type: {model_type}")
    cls = MODEL_REGISTRY[model_type]
    names = set(inspect.signature(cls).parameters) - {"generator"}
    return cls(generator=generator,
               **{k: v for k, v in kwargs.items() if k in names})


def grid_domain(cfg) -> tuple[float, float]:
    """The cube (lo, hi) a grid family covers in the model's input space
    (``nerf_tpu.models.registry.grid_domain``): the image of the world cube
    [-scene_bound, scene_bound]^3 under the renderer's componentwise
    [near, far] -> [-1, 1] map; (-1, 1) for NDC scenes, whose points are
    already there."""
    if cfg.dataset_type == "llff" and cfg.ndc:
        return (-1.0, 1.0)
    s = float(cfg.scene_bound)
    lo = 2.0 * (-s - cfg.near) / (cfg.far - cfg.near) - 1.0
    hi = 2.0 * (s - cfg.near) / (cfg.far - cfg.near) - 1.0
    return (lo, hi)


def model_from_config(cfg, generator: torch.Generator | None = None) -> nn.Module:
    """A CPU model from a ``Config``; move it with ``.to(device)``. Grid
    families also take ``domain``, ``use_grid_kernel`` (``use_pallas``)
    and, when the config sets it (> 0), ``grid_res``."""
    common = dict(
        hidden_dim=cfg.hidden_dim,
        pos_encoding_dim=cfg.pos_encoding_dim,
        dir_encoding_dim=cfg.dir_encoding_dim,
        compute_dtype=cfg.compute_dtype,
        reference_init=cfg.reference_init,
        use_grid_kernel=cfg.use_pallas,
        domain=grid_domain(cfg),
    )
    if cfg.grid_res > 0:
        common["grid_res"] = cfg.grid_res
    return create_model(cfg.model_type, generator=generator, **common)
