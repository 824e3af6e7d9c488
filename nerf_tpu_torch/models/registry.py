"""Model construction by name. Only ``nerf`` is ported so far; every other
family of ``nerf_tpu.models.registry`` raises and names the ROADMAP row
(queue 1) that will port it."""

from __future__ import annotations

import torch

from nerf_tpu_torch.models.nerf import NeRFModel

MODEL_REGISTRY = {"nerf": NeRFModel}

_NOT_YET = {
    "siren": "row 10 (SIREN)",
    "gabor": "row 11 (GaborNet)",
    "kilonerf": "row 12 (KiloNeRF)",
    "fastnerf": "row 13 (grid families)",
    "plenoctree": "row 13 (grid families)",
    "ngp": "row 13 (grid families)",
    "plenoxels": "row 13 (grid families)",
}


def create_model(model_type: str, generator: torch.Generator | None = None,
                 **kwargs) -> NeRFModel:
    model_type = model_type.lower()
    if model_type in _NOT_YET:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to nerf_tpu_torch yet "
            f"(ROADMAP.md queue 1, {_NOT_YET[model_type]})")
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"Invalid model type: {model_type}")
    names = ("pos_encoding_dim", "dir_encoding_dim", "hidden_dim",
             "compute_dtype", "reference_init")
    return MODEL_REGISTRY[model_type](
        generator=generator, **{k: v for k, v in kwargs.items() if k in names})


def model_from_config(cfg, generator: torch.Generator | None = None) -> NeRFModel:
    """A CPU model from a ``Config``; move it with ``.to(device)``."""
    return create_model(
        cfg.model_type, generator=generator,
        hidden_dim=cfg.hidden_dim,
        pos_encoding_dim=cfg.pos_encoding_dim,
        dir_encoding_dim=cfg.dir_encoding_dim,
        compute_dtype=cfg.compute_dtype,
        reference_init=cfg.reference_init,
    )
