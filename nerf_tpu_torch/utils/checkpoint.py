"""Checkpoint save and restore with ``torch.save``.

A checkpoint is one file ``{save_path}/{model_type}_model_{step:06d}``
holding ``{step, model_type, params, fine_params}`` (state dicts; an empty
dict when there is no separate fine model), beside a ``.meta.json``
sidecar with the step and model type, as ``nerf_tpu.utils.checkpoint``
lays them out. The file is written under a temporary name and renamed, so
a checkpoint that exists is complete. Checkpoints of the JAX package
(Orbax directories) are not read here.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

_CKPT_RE = re.compile(r"^(?P<model>[a-z0-9_]+)_model_(?P<step>\d{6,})$")


def _state_path(save_path: str, model_type: str, step: int) -> str:
    return os.path.join(os.path.abspath(save_path), f"{model_type}_model_{step:06d}")


def _cpu_state(module) -> dict:
    if module is None:
        return {}
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_checkpoint(model, fine_model, save_path: str, model_type: str,
                    step: int) -> str:
    """Save ``model`` (and ``fine_model``, or None) at ``step``; returns the
    checkpoint path."""
    path = _state_path(save_path, model_type, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": int(step), "model_type": model_type,
                "params": _cpu_state(model),
                "fine_params": _cpu_state(fine_model)}, tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": int(step), "model_type": model_type}, f)
    return path


def load_checkpoint(path: str) -> dict:
    """The dict ``save_checkpoint`` wrote, tensors on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def read_metadata(path: str) -> dict:
    path = os.path.abspath(path)
    # the sidecar is written after the checkpoint itself; a sidecar whose
    # checkpoint is missing is left over from an interrupted save
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no committed checkpoint at {path} (an orphaned .meta.json from "
            "an interrupted save does not count)")
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no checkpoint metadata for {path}")
    with open(meta_path, "r") as f:
        return json.load(f)


def latest_checkpoint(save_path: str,
                      model_type: Optional[str] = None) -> Optional[str]:
    """Most recent checkpoint under ``save_path`` (optionally of one model
    type), or None."""
    save_path = os.path.abspath(save_path)
    if not os.path.isdir(save_path):
        return None
    best: tuple[int, str] | None = None
    for name in os.listdir(save_path):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        if model_type is not None and m.group("model") != model_type:
            continue
        step = int(m.group("step"))
        if best is None or step > best[0]:
            best = (step, name)
    return os.path.join(save_path, best[1]) if best else None
