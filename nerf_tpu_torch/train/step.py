"""The training step and the full-image render behind validation, eval and
serving.

Counterpart of ``nerf_tpu.train.step`` for one device. A step draws a ray
batch on the device, runs the fused train pass of each model (one
train-kernel launch each on the card: forward, MSE and backward together),
maps the packed gradients back onto the parameters with ``backward()`` and
takes one Adam update, all in place. Per-step randomness comes from
``torch.Generator``s seeded from (seed, step, stream), so a resumed run or
a chunk of N steps repeats the same draws as N single steps.

There is no probe and no downgrade: a NeRF, a SIREN or a GaborNet trains
and renders through its family's fused kernels for CUDA tensors (which
raise on shapes they do not cover) and their plain versions for CPU
tensors, unless the caller asks for the unfused module path with
``use_pallas = false`` / ``fused=False``. A family without a fused render
but with field kernels (KiloNeRF) takes the field route instead, as the JAX
step does when ``resolve_fused_render`` gives None: ``render_rays`` on the
field of ``fused_field_for`` (its kernels, or their plain versions on the
CPU), the loss and its gradient through autograd.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.data.pipeline import RayBatch, RayPool
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender, FusedRender
from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
from nerf_tpu_torch.render.renderer import (
    RenderOutput,
    RenderSettings,
    render_image,
    render_rays,
    render_rays_train,
)
from nerf_tpu_torch.train.state import TrainState

SAMPLE, RENDER, VALIDATE, DISTILL = 0, 1, 2, 3   # generator streams of a step


def step_seed(seed: int, step: int, stream: int) -> int:
    """One 63-bit generator seed per (seed, step, stream)."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]
                                   ).generate_state(2)
    return (int(state[0]) << 31) ^ int(state[1])


_FUSED = {NeRFModel: FusedNerfRender, SirenModel: FusedSirenRender,
          GaborModel: FusedGaborRender}


def fused_render_for(model, settings: RenderSettings) -> FusedRender:
    """The fused render of ``model``'s family (counterpart of
    ``nerf_tpu.ops.pallas.get_fused_render`` and
    ``nerf_tpu.train.step.resolve_fused_render``, without their probe and
    their downgrade). Raises ``NotImplementedError`` for a family whose
    fused kernels are not ported."""
    cls = _FUSED.get(type(model))
    if cls is None:
        raise NotImplementedError(
            f"no fused render for {type(model).__name__} in nerf_tpu_torch "
            "yet (ROADMAP.md queue 2; use_pallas = false renders through the "
            "module)")
    return cls(model, settings.near, settings.far,
               normalize=settings.normalize_positions)


def _unported_field_row(model) -> str | None:
    """The row of PERF.md's table of the field kernel that nerf_tpu's
    ``get_fused_apply`` takes for ``model`` and the port lacks, or None where
    it takes none: ``make_fused_{nerf,gabor}_apply`` at widths with
    h % 128 == 0 and (h/2) % 128 == 0, ``make_fused_siren_apply`` there at 8
    sine layers only."""
    h = model.hidden_dim
    if h % 128 or (h // 2) % 128:
        return None
    if isinstance(model, NeRFModel):
        return "row 1 (fused_nerf.py::_fwd_kernel)"
    if isinstance(model, SirenModel) and model.num_layers == 8:
        return "row 9 (fused_siren.py::_fwd_kernel)"
    if isinstance(model, GaborModel):
        return "row 13 (fused_gabor.py::_fwd_kernel)"
    return None


def _on_card(model) -> bool:
    return next(model.parameters()).device.type == "cuda"


def fused_field_for(model):
    """The field ``(points, dirs) -> (rgb, sigma)`` that nerf_tpu's
    ``resolve_apply_fn`` picks for ``model``, without its probe and its
    downgrade: a KiloNeRF through its field kernels (``KiloNeRFField``,
    bound to the module); a NeRF, SIREN or GaborNet through its module where
    nerf_tpu takes no field kernel, and on the CPU. Raises
    ``NotImplementedError`` on the card where nerf_tpu would take a field
    kernel not ported yet (naming its row of PERF.md's table), and for a
    family the port does not have."""
    if isinstance(model, KiloNeRFModel):
        return KiloNeRFField(model)
    if not isinstance(model, (NeRFModel, SirenModel, GaborModel)):
        raise NotImplementedError(
            f"no field for {type(model).__name__} in nerf_tpu_torch yet "
            "(ROADMAP.md queue 2)")
    row = _unported_field_row(model)
    if row is not None and _on_card(model):
        raise NotImplementedError(
            f"{type(model).__name__} at hidden {model.hidden_dim} runs through a "
            f"field kernel in nerf_tpu that is not ported to nerf_tpu_torch yet "
            f"(PERF.md {row}; ROADMAP.md queue 2); use_pallas = false evaluates "
            "the module")
    return model


def _kernel_route(model, settings: RenderSettings, use_kernels: bool):
    """``(fused_render, field)``: the family's fused render, or for KiloNeRF,
    which has none, the factory of its field (``KiloNeRFField``); raises for
    any other family; ``(None, None)`` for the module path."""
    if not use_kernels:
        return None, None
    if type(model) in _FUSED:
        return fused_render_for(model, settings), None
    if not isinstance(model, KiloNeRFModel):
        raise NotImplementedError(
            f"no fused render and no field kernels for {type(model).__name__} in "
            "nerf_tpu_torch yet (ROADMAP.md queue 2; use_pallas = false renders "
            "through the module)")
    return None, KiloNeRFField


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _make_step_body(model, settings: RenderSettings, batch_size: int,
                    seed: int, use_pallas: bool = True,
                    epoch_sampling: bool = False):
    """``(sample, train_on_batch)``: ``sample(state, pool) -> RayBatch``
    draws the batch of ``state.step``; ``train_on_batch(state, batch) ->
    metrics`` renders, takes the loss and its gradient, and updates
    ``state`` in place (the step counter too). ``metrics`` holds ``loss``,
    ``mse`` and ``psnr`` as device scalars. With ``use_pallas`` each pass is
    one train-kernel launch of the family's fused render, or, for a family
    without one, the field route (its field kernels under autograd); without,
    the unfused module path under autograd."""
    fused_render, field = _kernel_route(model, settings, use_pallas)

    def sample(state: TrainState, pool: RayPool) -> RayBatch:
        if epoch_sampling:
            return pool.sample_epoch(seed, state.step, batch_size)
        gen = _generator(pool.rays_o.device, step_seed(seed, state.step, SAMPLE))
        return pool.sample(gen, batch_size)

    def loss_fn(state: TrainState, batch: RayBatch, gen):
        if fused_render is not None:
            return render_rays_train(
                fused_render, state.params, batch.rays_o, batch.rays_d,
                settings, batch.rgb, generator=gen,
                fine_params=state.fine_params, viewdirs=batch.viewdirs)
        params, fine = state.params, state.fine_params
        if field is not None:
            params = field(params)
            fine = field(fine) if fine is not None else None
        out = render_rays(params, batch.rays_o, batch.rays_d, settings,
                          generator=gen, fine_params=fine,
                          viewdirs=batch.viewdirs)
        mse = torch.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if settings.num_fine_samples > 0:
            loss = loss + torch.mean((out.rgb_coarse - batch.rgb) ** 2)
        return loss, mse

    def train_on_batch(state: TrainState, batch: RayBatch) -> dict:
        gen = _generator(batch.rays_o.device, step_seed(seed, state.step, RENDER))
        for m in state.models():
            m.zero_grad(set_to_none=True)
        loss, mse = loss_fn(state, batch, gen)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        mse = mse.detach()
        return {"loss": loss.detach(), "mse": mse, "psnr": -10.0 * torch.log10(mse)}

    return sample, train_on_batch


def make_train_step(model, settings: RenderSettings, batch_size: int,
                    seed: int, use_pallas: bool = True,
                    epoch_sampling: bool = False):
    """``step(state, pool) -> metrics``: one iteration, ``state`` updated
    in place."""
    sample, train_on_batch = _make_step_body(model, settings, batch_size, seed,
                                             use_pallas, epoch_sampling)

    def step(state: TrainState, pool: RayPool) -> dict:
        return train_on_batch(state, sample(state, pool))

    return step


def make_scan_train_step(model, settings: RenderSettings, batch_size: int,
                         seed: int, num_steps: int, use_pallas: bool = True,
                         epoch_sampling: bool = False):
    """``step_n(state, pool) -> metrics``: ``num_steps`` iterations in a
    Python loop, each metric stacked to ``(num_steps,)``. The draws key off
    ``state.step``, so N steps here equal N single steps."""
    step = make_train_step(model, settings, batch_size, seed, use_pallas,
                           epoch_sampling)

    def step_n(state: TrainState, pool: RayPool) -> dict:
        ms = [step(state, pool) for _ in range(num_steps)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step_n


def make_eval_render(model, settings: RenderSettings, fused: bool = True):
    """Returns ``render(params, fine_params, rays_o, rays_d, generator=None,
    viewdirs=None) -> RenderOutput``, where ``params``/``fine_params`` are
    models of ``model``'s family (``fine_params`` None: the coarse model
    renders both passes). With ``fused`` each pass runs the family's fused
    render, or for a family without one its field kernels (the field route);
    otherwise the module. Memory is bounded by ``settings.chunk_size`` ray
    tiles."""
    fused_render, field = _kernel_route(model, settings, fused)

    @torch.no_grad()
    def render(params, fine_params, rays_o: torch.Tensor, rays_d: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               viewdirs: Optional[torch.Tensor] = None) -> RenderOutput:
        # pack the weights once per image, not once per tile
        if fused_render is not None:
            params = fused_render.pack(params)
            if fine_params is not None:
                fine_params = fused_render.pack(fine_params)
        elif field is not None:
            params = field(params).pack()
            if fine_params is not None:
                fine_params = field(fine_params).pack()
        return render_image(params, rays_o, rays_d, settings,
                            generator=generator, fine_params=fine_params,
                            viewdirs=viewdirs, fused_render=fused_render)

    return render
