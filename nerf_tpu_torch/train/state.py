"""Training state, as ``nerf_tpu.train.state``: the step counter, the coarse
(or only) model, the fine model (None when hierarchical sampling is off or
the coarse model renders both passes) and one Adam over both models'
parameters. The models and the optimizer update in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from nerf_tpu_torch.models.registry import model_from_config
from nerf_tpu_torch.train.optim import Adam, make_optimizer
from nerf_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    step: int                           # iterations taken so far
    params: nn.Module                   # coarse (or only) model
    fine_params: Optional[nn.Module]    # fine model, or None
    optimizer: Adam                     # over params, then fine_params

    def models(self) -> list:
        return [m for m in (self.params, self.fine_params) if m is not None]


def create_train_state(cfg, seed: Optional[int] = None,
                       device: str | torch.device = "cuda") -> TrainState:
    """Fresh state from a ``Config``: both models drawn from one CPU
    generator seeded with ``seed`` (default ``cfg.seed``), then moved to
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    params = model_from_config(cfg, generator=gen).to(dev)
    fine = None
    if cfg.num_fine_samples > 0 and cfg.separate_fine_model:
        fine = model_from_config(cfg, generator=gen).to(dev)
    trainable = [p for m in (params, fine) if m is not None for p in m.parameters()]
    return TrainState(step=0, params=params, fine_params=fine,
                      optimizer=make_optimizer(cfg, trainable))
