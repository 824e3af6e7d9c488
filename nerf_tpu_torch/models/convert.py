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
``grid`` parameter as it is), a PlenOctree ``{"trunk1": [5 layers],
"trunk2": [3], "head"}``, a FastNeRF the same with ``"dir": [2]``, and an
Instant NGP ``{"tables": [(2^T, F) per level], "density": [2 layers],
"color": [2]}`` (the tables as they are).
``load_jax_params`` copies
such a tree (as numpy arrays) into the port's module; ``export_jax_params``
is its inverse, ``export_jax_grads`` gives the ``.grad``s the same way, and
``load_jax_opt_state`` copies optax's Adam moments. Each picks the family
from the module's type (the moments from their tree's keys) and maps every
layer by its name in the tree, never by leaf position: JAX flattens dicts
in sorted-key order. ``load_jax_baked`` builds a ``BakedFastNeRF`` from
nerf_tpu's baked FastNeRF cache.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_tpu_torch.models.fastnerf import BakedFastNeRF, FastNeRFModel
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import LAYERS as KILO_LAYERS
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.ngp import NGPModel
from nerf_tpu_torch.models.plenoctree import PlenOctreeModel
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_grid import LANES, pack_grid

_BLOCKS = (("block1", "block1"), ("block2", "block2"), ("rgb", "rgb_head"))
_HEADS = ("sigma", "remap", "rgb0", "rgb1")     # SIREN's and GaborNet's
# a Gabor filter's leaves in the port's parameter order
FILTER_LEAVES = ("omega", "phi", "mu", "gamma")
_TRUNK = (("trunk1", 5), ("trunk2", 3))         # the skip trunk's lists
_NGP = [("density", 0), ("density", 1), ("color", 0), ("color", 1)]


def _trunk_paths(with_dir: bool) -> list[tuple]:
    """The tree paths of a skip-trunk family (FastNeRF with its ``dir``
    net, PlenOctree without), in the port module's parameter order."""
    return ([(name, i) for name, n in _TRUNK for i in range(n)] + [("head",)]
            + ([("dir", 0), ("dir", 1)] if with_dir else []))


def _paths(module) -> list[tuple]:
    """The tree path of each layer of ``module``, in parameter order:
    ``(name, i)`` for the i-th layer of a list, ``(name,)`` for a layer."""
    if isinstance(module, SirenModel):
        return ([("base", i) for i in range(len(module.base))]
                + [(k,) for k in _HEADS])
    if isinstance(module, GaborModel):
        return ([("linears", i) for i in range(len(module.linears))]
                + [(k,) for k in _HEADS])
    if isinstance(module, (FastNeRFModel, PlenOctreeModel)):
        return _trunk_paths(isinstance(module, FastNeRFModel))
    if isinstance(module, NGPModel):
        return list(_NGP)
    return [(jax_name, i) for jax_name, torch_name in _BLOCKS
            for i in range(len(module.linears(getattr(module, torch_name))))]


def _linears(module) -> list[nn.Linear]:
    """The layers of ``module`` in the order of ``_paths``."""
    if isinstance(module, SirenModel):
        return list(module.base) + [getattr(module, k) for k in _HEADS]
    if isinstance(module, GaborModel):
        return list(module.linears) + [getattr(module, k) for k in _HEADS]
    if isinstance(module, (FastNeRFModel, PlenOctreeModel)):
        return ([*module.trunk1, *module.trunk2, module.head]
                + (list(module.dir) if isinstance(module, FastNeRFModel) else []))
    if isinstance(module, NGPModel):
        return [*module.density, *module.color]
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
    if isinstance(module, NGPModel):
        tree["tables"] = [leaf(t) for t in module.tables]
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
    if isinstance(module, NGPModel) and len(tree["tables"]) != len(module.tables):
        raise ValueError(f"tables: tree has {len(tree['tables'])} levels, "
                         f"module {len(module.tables)}")
    with torch.no_grad():
        if isinstance(module, NGPModel):
            for i, (src, t) in enumerate(zip(tree["tables"], module.tables)):
                _copy_leaf(t, src, f"tables/{i}")
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
    elif "tables" in tree:
        out += [np.asarray(t, np.float32) for t in tree["tables"]]
        paths = list(_NGP)
    elif "trunk1" in tree:
        paths = _trunk_paths("dir" in tree)
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


def load_jax_baked(baked, device: str | torch.device = "cpu") -> BakedFastNeRF:
    """A ``BakedFastNeRF`` on ``device`` from nerf_tpu's baked FastNeRF
    cache (its ``pos_grid``, ``beta_grid``, ``num_factors``,
    ``use_grid_kernel`` and ``domain``; array-likes), with the bfloat16 copy
    that the port's ``bake`` makes (nerf_tpu's ``packed_pos`` is in its
    Pallas brick layout and is not read)."""
    pos = torch.from_numpy(np.asarray(baked.pos_grid, np.float32).copy()).to(device)
    beta = torch.from_numpy(np.asarray(baked.beta_grid, np.float32).copy()).to(device)
    packed = None
    if baked.use_grid_kernel and pos.shape[-1] <= LANES:
        packed = pack_grid(pos, "bfloat16")
    return BakedFastNeRF(pos, beta, int(baked.num_factors),
                         use_grid_kernel=bool(baked.use_grid_kernel), packed_pos=packed,
                         domain=tuple(baked.domain))
