"""Weights across the two packages.

``nerf_tpu`` keeps a model as a pytree of ``{"w", "b"}`` layers with ``w``
of shape (in, out); ``nn.Linear`` stores (out, in). A NeRF is ``{"block1":
[...], "block2": [...], "rgb": [...]}``, a SIREN ``{"base": [...],
"sigma", "remap", "rgb0", "rgb1"}``, a GaborNet ``{"filters": [{"omega",
"phi", "mu", "gamma"}, ...], "linears": [...], "sigma", "remap", "rgb0",
"rgb1"}`` (filter leaves keep their shapes), a KiloNeRF ``{"l1", "l2",
"trunk", "rgb1", "rgb2"}`` of ``{"w", "b"}`` batched over the networks
(``w`` (G^3, in, out), the layout the port keeps, so nothing is
transposed), a Plenoxels model ``{"grid": (R, R, R, C)}`` (the port's
``grid`` parameter as it is). ``load_jax_params`` copies
such a tree (as numpy arrays) into the port's module; ``export_jax_params``
is its inverse, ``export_jax_grads`` gives the ``.grad``s the same way, and
``load_jax_opt_state`` copies optax's Adam moments. Each picks the family
from the module's type (the moments from their tree's keys) and maps every
layer by its name in the tree, never by leaf position: JAX flattens dicts
in sorted-key order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import LAYERS as KILO_LAYERS
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
from nerf_tpu_torch.models.siren import SirenModel

_BLOCKS = (("block1", "block1"), ("block2", "block2"), ("rgb", "rgb_head"))
_HEADS = ("sigma", "remap", "rgb0", "rgb1")     # SIREN's and GaborNet's
# a Gabor filter's leaves in the port's parameter order
FILTER_LEAVES = ("omega", "phi", "mu", "gamma")


def _paths(module) -> list[tuple]:
    """The tree path of each layer of ``module``, in parameter order:
    ``(name, i)`` for the i-th layer of a list, ``(name,)`` for a layer."""
    if isinstance(module, SirenModel):
        return ([("base", i) for i in range(len(module.base))]
                + [(k,) for k in _HEADS])
    if isinstance(module, GaborModel):
        return ([("linears", i) for i in range(len(module.linears))]
                + [(k,) for k in _HEADS])
    return [(jax_name, i) for jax_name, torch_name in _BLOCKS
            for i in range(len(module.linears(getattr(module, torch_name))))]


def _linears(module) -> list[nn.Linear]:
    """The layers of ``module`` in the order of ``_paths``."""
    if isinstance(module, SirenModel):
        return list(module.base) + [getattr(module, k) for k in _HEADS]
    if isinstance(module, GaborModel):
        return list(module.linears) + [getattr(module, k) for k in _HEADS]
    return [lyr for _, torch_name in _BLOCKS
            for lyr in module.linears(getattr(module, torch_name))]


def _get(tree: dict, path: tuple):
    node = tree[path[0]]
    return node[path[1]] if len(path) == 2 else node


def _tree_of(module, leaf) -> dict:
    """The pytree of ``module`` with ``leaf(param) -> numpy`` at each leaf
    (weights transposed to (in, out))."""
    if isinstance(module, KiloNeRFModel):
        return {k: {"w": leaf(module.layer(k).w), "b": leaf(module.layer(k).b)}
                for k in KILO_LAYERS}
    if isinstance(module, PlenoxelsModel):
        return {"grid": leaf(module.grid)}
    tree: dict = {}
    for path, lyr in zip(_paths(module), _linears(module)):
        node = {"w": leaf(lyr.weight).T.copy(), "b": leaf(lyr.bias)}
        if len(path) == 2:
            tree.setdefault(path[0], []).append(node)
        else:
            tree[path[0]] = node
    if isinstance(module, GaborModel):
        tree["filters"] = [{k: leaf(getattr(f, k)) for k in FILTER_LEAVES}
                           for f in module.filters]
    return tree


def _copy_leaf(param: torch.Tensor, src, name: str) -> None:
    """``param`` <- the array-like ``src`` of the same shape (no transpose)."""
    x = torch.from_numpy(np.asarray(src, np.float32).copy())
    if x.shape != param.shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(x)


def load_jax_params(module, tree: dict) -> None:
    """Copy a ``nerf_tpu`` pytree of the module's family (numpy or
    array-likes) into ``module`` in place, transposing each (in, out)
    weight (a KiloNeRF's batched weights keep their layout)."""
    if isinstance(module, KiloNeRFModel):
        with torch.no_grad():
            for k in KILO_LAYERS:
                for leaf in ("w", "b"):
                    _copy_leaf(getattr(module.layer(k), leaf), tree[k][leaf],
                               f"{k}/{leaf}")
        return
    if isinstance(module, PlenoxelsModel):
        with torch.no_grad():
            _copy_leaf(module.grid, tree["grid"], "grid")
        return
    paths = _paths(module)
    for name in {p[0] for p in paths if len(p) == 2}:
        want = sum(1 for p in paths if p[0] == name)
        if len(tree[name]) != want:
            raise ValueError(f"{name}: tree has {len(tree[name])} layers, "
                             f"module {want}")
    if isinstance(module, GaborModel) and len(tree["filters"]) != len(module.filters):
        raise ValueError(f"filters: tree has {len(tree['filters'])} filters, "
                         f"module {len(module.filters)}")
    with torch.no_grad():
        if isinstance(module, GaborModel):
            for i, (src, f) in enumerate(zip(tree["filters"], module.filters)):
                for k in FILTER_LEAVES:
                    _copy_leaf(getattr(f, k), src[k], f"filters/{i}/{k}")
        for path, lyr in zip(paths, _linears(module)):
            src = _get(tree, path)
            w = torch.from_numpy(np.asarray(src["w"], np.float32).T.copy())
            b = torch.from_numpy(np.asarray(src["b"], np.float32).copy())
            if w.shape != lyr.weight.shape or b.shape != lyr.bias.shape:
                raise ValueError(
                    f"{'/'.join(map(str, path))}: shape {tuple(w.shape)} "
                    f"does not fit {tuple(lyr.weight.shape)}")
            lyr.weight.copy_(w)
            lyr.bias.copy_(b)


def export_jax_params(module) -> dict:
    """The ``nerf_tpu`` pytree (numpy float32, (in, out) weights) of
    ``module``."""
    return _tree_of(module, lambda p: p.detach().cpu().numpy().copy())


def export_jax_grads(module) -> dict:
    """The ``.grad`` of every parameter of ``module`` as a ``nerf_tpu``
    gradient pytree (numpy, (in, out) weights), to hold against
    ``jax.grad`` tensor by tensor."""
    return _tree_of(module, lambda p: p.grad.detach().cpu().numpy().copy())


def _flat_in_param_order(tree: dict) -> list[np.ndarray]:
    """A model pytree's leaves in the port module's ``parameters()`` order,
    each in the ``nn.Linear`` layout, found by name (the family from the
    tree's keys)."""
    out = []
    if "trunk" in tree:
        return [np.asarray(tree[k][leaf], np.float32) for k in KILO_LAYERS
                for leaf in ("w", "b")]
    if "grid" in tree:
        return [np.asarray(tree["grid"], np.float32)]
    if "filters" in tree:
        out += [np.asarray(f[k], np.float32) for f in tree["filters"]
                for k in FILTER_LEAVES]
        paths = [("linears", i) for i in range(len(tree["linears"]))] + [
            (k,) for k in _HEADS]
    elif "base" in tree:
        paths = [("base", i) for i in range(len(tree["base"]))] + [
            (k,) for k in _HEADS]
    else:
        paths = [(name, i) for name, _ in _BLOCKS for i in range(len(tree[name]))]
    for path in paths:
        lyr = _get(tree, path)
        out += [np.asarray(lyr["w"], np.float32).T, np.asarray(lyr["b"], np.float32)]
    return out


def load_jax_opt_state(optimizer, opt_state, trees: int = 2) -> None:
    """Copy optax's Adam state (``ScaleByAdamState`` first in the chain;
    ``mu``/``nu`` over the ``(params, fine_params)`` pair, ``fine_params``
    possibly ``{}``) into the port's ``Adam`` in place."""
    adam = opt_state[0]
    mu, nu = [], []
    for i in range(trees):
        if adam.mu[i]:
            mu += _flat_in_param_order(adam.mu[i])
            nu += _flat_in_param_order(adam.nu[i])
    optimizer.load_state_dict({
        "count": int(np.asarray(adam.count)),
        "mu": [torch.from_numpy(np.array(x, np.float32)) for x in mu],
        "nu": [torch.from_numpy(np.array(x, np.float32)) for x in nu]})
