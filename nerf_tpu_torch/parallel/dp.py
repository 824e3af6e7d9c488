"""Data parallelism over ``torch.distributed``, as ``nerf_tpu.parallel.dp``.

The collective of a step is one ``all_reduce`` over a rank group: every
gradient of the state's models, then the loss and the mse, flattened into
one buffer, summed and divided by the group's size (``average_grads``). It
runs between the backward pass and the Adam update, through the
``reduce`` hook of ``train/step.py::_make_step_body``, so a data-parallel
step is the one-device step with that hook (nothing of the step is copied).

``make_dp_train_step`` is nerf_tpu's explicit step (its ``shard_map``
form): each rank draws ``batch / D`` rays from its own shard of the pool
(``mesh.shard_pool``) with generators seeded from (seed, step, rank).
``fit`` takes nerf_tpu's GSPMD form instead (``shard`` in
``_make_step_body``): every rank draws the one-rank step's global batch and
renders its slice of it, so D ranks train on the one-rank batches. No
entry point runs ``make_dp_train_step``: only the tests do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nerf_tpu_torch.parallel.mesh import Mesh
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.step import RANK, _make_step_body, sub_seed


def average_grads(models, loss: torch.Tensor, mse: torch.Tensor, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Average every parameter's gradient of ``models`` (a missing one
    counts as zero), ``loss`` and ``mse`` over ``group`` (None: the default
    group) with one ``all_reduce``; the gradients are replaced in place.
    Returns the averaged ``(loss, mse)``."""
    params = [p for m in models for p in m.parameters()]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [loss.reshape(1), mse.reshape(1)])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    at = 0
    for p in params:
        p.grad = flat[at:at + p.numel()].view_as(p).clone()
        at += p.numel()
    return flat[-2].clone(), flat[-1].clone()


def grad_reducer(group=None):
    """The ``reduce`` hook of ``_make_step_body`` that averages over
    ``group``."""
    def reduce(state, loss, mse):
        return average_grads(state.models(), loss, mse, group)

    return reduce


def make_dp_train_step(model, settings: RenderSettings, batch_size: int, seed: int,
                       mesh: Mesh, axis: str = "data", use_pallas: bool = True,
                       regularizer=None):
    """``step(state, pool_shard) -> metrics``: this rank draws ``batch_size /
    D`` rays from its shard (``shard_pool(pool, mesh)``) with generators of
    ``sub_seed(seed, RANK, rank)``, runs the family's fused train pass (or
    the field route), averages the gradients and metrics over the axis's
    group and takes the Adam update. Raises when ``batch_size`` does not
    divide by D."""
    num_shards = mesh.size(axis)
    if batch_size % num_shards:
        raise ValueError(f"batch_size {batch_size} not divisible by {num_shards}")
    sample, train_on_batch = _make_step_body(
        model, settings, batch_size // num_shards, sub_seed(seed, RANK, mesh.index(axis)),
        use_pallas, regularizer=regularizer, reduce=grad_reducer(mesh.group(axis)))

    def step(state, pool_shard) -> dict:
        return train_on_batch(state, sample(state, pool_shard))

    return step
