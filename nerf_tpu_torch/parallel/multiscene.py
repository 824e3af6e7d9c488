"""Multi-scene training: S scenes trained together, as
``nerf_tpu.parallel.multiscene``.

nerf_tpu stacks the scenes' parameters along a leading axis and ``vmap``s
one step over it, which runs each fused kernel once over all scenes. Here a
step is a loop over the scenes: each scene keeps its own ``TrainState``
and pool, and each scene's pass is one launch of its family's train kernel
on the card. Adam works element by element, so per-scene states give the
stacked update. Randomness keys off (seed, step, global scene index): a
chunk of N steps equals N single steps, and any split of the scenes over
ranks gives each scene the same draws.

Under a mesh, the ``scene`` axis splits the scenes over rank groups (this
rank holds its group's scenes) and the ``data`` axis splits each scene's
global batch as ``fit`` does (``train/step.py::_make_step_body``'s
``shard``), its gradients averaged over the data group
(``parallel/dp.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.parallel.dp import grad_reducer
from nerf_tpu_torch.parallel.mesh import Mesh
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.step import SCENE, _make_step_body, sub_seed


def stack_scenes(per_scene: list):
    """Stack identically-structured per-scene values (tensors, or dicts,
    lists and named tuples of them, such as ``RayPool``s) along a new
    leading scene axis."""
    first = per_scene[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(per_scene)
    if isinstance(first, dict):
        return {k: stack_scenes([x[k] for x in per_scene]) for k in first}
    parts = [stack_scenes(list(xs)) for xs in zip(*per_scene)]
    return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)


def scene_seed(seed: int, scene: int) -> int:
    """The seed of global scene ``scene``: its initial weights and its
    steps' draws."""
    return sub_seed(seed, SCENE, scene)


def local_scenes(num_scenes: int, mesh: Mesh, scene_axis: str = "scene") -> range:
    """The global indices of the scenes that this rank's scene group holds
    (contiguous, as nerf_tpu shards the stacked axis)."""
    per = num_scenes // mesh.size(scene_axis)
    first = mesh.index(scene_axis) * per
    return range(first, first + per)


def _make_multiscene_body(models: list, settings: RenderSettings,
                          batch_size_per_scene: int, seed: int, mesh: Mesh,
                          scene_axis: str = "scene", data_axis: str = "data",
                          use_pallas: bool = True, regularizer=None):
    """``(sample, train_on_batches)`` over this rank's scenes (``models``,
    one per scene, the scenes ``local_scenes`` gives):
    ``sample(states, pools) -> batches`` and
    ``train_on_batches(states, batches) -> metrics`` with per-scene (S,)
    vectors of ``loss``, ``mse`` and ``psnr``; each is ``_make_step_body``'s
    of one scene, seeded with ``scene_seed``."""
    scenes = local_scenes(len(models) * mesh.size(scene_axis), mesh, scene_axis)
    shard = reduce = None
    if mesh.size(data_axis) > 1:
        shard = (mesh.index(data_axis), mesh.size(data_axis))
        reduce = grad_reducer(mesh.group(data_axis))
    bodies = []
    for scene, model in zip(scenes, models):
        # KiloNeRF's kernels take one network grid a call; nerf_tpu's
        # vmapped step runs that family through its module
        kernels = use_pallas and not isinstance(model, KiloNeRFModel)
        bodies.append(_make_step_body(
            model, settings, batch_size_per_scene, scene_seed(seed, scene),
            kernels, regularizer=regularizer, shard=shard, reduce=reduce))

    def sample(states: list, pools: list) -> list:
        return [b[0](st, pool) for b, st, pool in zip(bodies, states, pools)]

    def train_on_batches(states: list, batches: list) -> dict:
        ms = [b[1](st, batch) for b, st, batch in zip(bodies, states, batches)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return sample, train_on_batches


def make_multiscene_train_step(models: list, settings: RenderSettings,
                               batch_size_per_scene: int, seed: int, mesh: Mesh,
                               scene_axis: str = "scene", data_axis: str = "data",
                               use_pallas: bool = True, regularizer=None,
                               num_steps: int = 1):
    """``step(states, pools) -> metrics``: one iteration of every scene that
    this rank holds (``models``, ``states`` and ``pools`` in scene order),
    the states updated in place; metrics are (S,) vectors, or (num_steps,
    S) with ``num_steps > 1`` (``num_steps`` iterations in one call, equal
    to as many single calls). ``regularizer(state) -> scalar`` (the grid
    families' TV prior) adds to each scene's loss."""
    sample, train_on_batches = _make_multiscene_body(
        models, settings, batch_size_per_scene, seed, mesh, scene_axis, data_axis,
        use_pallas, regularizer)

    def step(states: list, pools: list) -> dict:
        ms = [train_on_batches(states, sample(states, pools)) for _ in range(num_steps)]
        if num_steps == 1:
            return ms[0]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step


def gather_scene_values(values: torch.Tensor, num_scenes: int, mesh: Mesh,
                        scene_axis: str = "scene", data_axis: str = "data"
                        ) -> torch.Tensor:
    """Every scene's value (num_scenes, ...) on every rank, from this rank's
    scenes' ``values`` (S_local, ...): one ``all_reduce`` over the world,
    to which the first data rank of each scene group gives its scenes."""
    if not dist.is_initialized() or mesh.size(scene_axis) == 1:
        return values
    out = torch.zeros((num_scenes,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if mesh.index(data_axis) == 0:
        out[list(local_scenes(num_scenes, mesh, scene_axis))] = values
    dist.all_reduce(out)
    return out
