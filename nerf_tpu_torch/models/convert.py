"""Weights across the two packages.

``nerf_tpu`` keeps a NeRF as a pytree ``{"block1": [{"w", "b"}, ...],
"block2": [...], "rgb": [...]}`` with ``w`` of shape (in, out); ``nn.Linear``
stores (out, in). ``load_jax_params`` copies such a tree (as numpy arrays)
into a ``NeRFModel``; ``export_jax_params`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_BLOCKS = (("block1", "block1"), ("block2", "block2"), ("rgb", "rgb_head"))


def _layers(module) -> list[tuple[str, nn.Linear]]:
    return [(jax_name, lyr)
            for jax_name, torch_name in _BLOCKS
            for lyr in module.linears(getattr(module, torch_name))]


def load_jax_params(module, tree: dict) -> None:
    """Copy a ``nerf_tpu`` NeRF pytree (numpy or array-likes) into
    ``module`` in place, transposing each (in, out) weight."""
    index = {"block1": 0, "block2": 0, "rgb": 0}
    with torch.no_grad():
        for jax_name, lyr in _layers(module):
            src = tree[jax_name][index[jax_name]]
            index[jax_name] += 1
            w = torch.from_numpy(np.asarray(src["w"], np.float32).T.copy())
            b = torch.from_numpy(np.asarray(src["b"], np.float32).copy())
            if w.shape != lyr.weight.shape or b.shape != lyr.bias.shape:
                raise ValueError(
                    f"{jax_name}[{index[jax_name] - 1}]: shape {tuple(w.shape)} "
                    f"does not fit {tuple(lyr.weight.shape)}")
            lyr.weight.copy_(w)
            lyr.bias.copy_(b)
    for name, n in index.items():
        if n != len(tree[name]):
            raise ValueError(f"{name}: tree has {len(tree[name])} layers, "
                             f"module {n}")


def export_jax_params(module) -> dict:
    """The ``nerf_tpu`` pytree (numpy float32, (in, out) weights) of
    ``module``."""
    tree: dict = {"block1": [], "block2": [], "rgb": []}
    for jax_name, lyr in _layers(module):
        tree[jax_name].append({
            "w": lyr.weight.detach().cpu().numpy().T.copy(),
            "b": lyr.bias.detach().cpu().numpy().copy(),
        })
    return tree
