"""The training step and the full-image render behind validation, eval and
serving.

Counterpart of ``nerf_tpu.train.step`` for one device. A step draws a ray
batch on the device, runs the fused train pass of each model (one
train-kernel launch each on the card: forward, MSE and backward together),
maps the packed gradients back onto the parameters with ``backward()`` and
takes one Adam update, all in place. Per-step randomness comes from
``torch.Generator``s seeded from (seed, step, stream), so a resumed run or
a chunk of N steps repeats the same draws as N single steps.

There is no probe and no downgrade, and the route is nerf_tpu's: a NeRF, a
SIREN or a GaborNet that nerf_tpu's ``make_fused_*_render`` takes (hidden
h with h % 128 == 0 and (h/2) % 128 == 0; a SIREN at 8 layers only)
trains and renders through its family's fused kernels for CUDA tensors
(which raise on shapes they do not cover) and their plain versions for
CPU tensors, unless the caller asks for the unfused module path with
``use_pallas = false`` / ``fused=False``. Any other model takes the field
route, as the JAX step does when ``resolve_fused_render`` gives None:
``render_rays`` on the field of ``fused_field_for`` (a family's field
kernels where nerf_tpu takes them and the port's cover the shape, else the
module),
the loss and its gradient through autograd. A Plenoxels model trains
through its module (its ``apply`` reaches the grid-interpolation kernel and
the scatter-add of its backward itself) and renders full images through
the eval-only fused grid render (``ops/cuda/fused_grid_render.py``), which
training routes skip, as nerf_tpu's ``for_train`` does. With an occupancy
grid (the ``occ_grid`` step argument) the coarse samples come from the
prior (``ops/occupancy.py``); a ``regularizer`` (the grid families' TV
prior, ``train/loop.py::make_regularizer``) adds to the loss; with
``debug_nans`` a non-finite loss or gradient raises ``FloatingPointError``
before the update.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.data.pipeline import RayBatch, RayPool
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
from nerf_tpu_torch.models.siren import SirenModel
from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
from nerf_tpu_torch.ops.cuda.fused_grid import tile_ray_order
from nerf_tpu_torch.ops.cuda.fused_grid_render import make_fused_grid_render
from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender, FusedRender
from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
from nerf_tpu_torch.ops.occupancy import OccupancyGrid
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


def _tpu_kernel_width(model) -> bool:
    """Whether nerf_tpu's NeRF, SIREN and GaborNet kernels take ``model``:
    both its ``make_fused_*_render`` and its ``make_fused_*_apply`` give
    one for hidden h with h % 128 == 0 and (h/2) % 128 == 0, for a SIREN
    at 8 layers only."""
    h = model.hidden_dim
    if h % 128 or (h // 2) % 128:
        return False
    if isinstance(model, SirenModel):
        return model.num_layers == 8
    return isinstance(model, (NeRFModel, GaborModel))


# each family's field wrapper, and the row of PERF.md's table of the TPU
# field kernel it ports
_FIELDS = {NeRFModel: (NerfField, "row 1 (fused_nerf.py::_fwd_kernel)"),
           SirenModel: (SirenField, "row 9 (fused_siren.py::_fwd_kernel)"),
           GaborModel: (GaborField, "row 13 (fused_gabor.py::_fwd_kernel)")}


def _unported_field_row(model) -> str:
    """The row of PERF.md's table of the field kernel that nerf_tpu takes
    for ``model`` (``_tpu_kernel_width``) at a shape that the port's kernels
    do not cover."""
    return _FIELDS[type(model)][1]


def _on_card(model) -> bool:
    return next(model.parameters()).device.type == "cuda"


def fused_field_for(model):
    """The field ``(points, dirs) -> (rgb, sigma)`` that nerf_tpu's
    ``resolve_apply_fn`` picks for ``model``, without its probe and its
    downgrade: a KiloNeRF through its field kernels (``KiloNeRFField``) where
    ``make_fused_kilonerf_apply`` takes it (8 <= h <= 128, h % 8 == 0); on
    the card, a NeRF, SIREN or GaborNet that nerf_tpu's
    ``make_fused_*_apply`` takes (``_tpu_kernel_width``) through its
    family's field kernels (``NerfField``, ``SirenField``, ``GaborField``)
    where they cover the shape (hidden 256; a GaborNet of 8 stages);
    otherwise the module, as on the CPU and wherever nerf_tpu takes no field
    kernel (a Plenoxels model: its ``apply`` reaches the grid kernel).
    Raises ``NotImplementedError`` on the card where nerf_tpu would take a
    field kernel at a shape the port's do not cover (naming its row of
    PERF.md's table: any of the three at hidden 512, a GaborNet of another
    depth than 8), and for a family the port does not have."""
    if isinstance(model, KiloNeRFModel):
        h = model.hidden_dim
        return KiloNeRFField(model) if 8 <= h <= 128 and h % 8 == 0 else model
    if isinstance(model, PlenoxelsModel):
        return model
    if type(model) not in _FIELDS:
        raise NotImplementedError(
            f"no field for {type(model).__name__} in nerf_tpu_torch yet "
            "(ROADMAP.md queue 2)")
    if not _tpu_kernel_width(model) or not _on_card(model):
        return model
    field = _FIELDS[type(model)][0](model)
    if field.supported():
        return field
    raise NotImplementedError(
        f"{type(model).__name__} at hidden {model.hidden_dim} runs through a field "
        f"kernel in nerf_tpu that nerf_tpu_torch does not cover at this shape "
        f"(PERF.md {_unported_field_row(model)}; ROADMAP.md queue 2); "
        "use_pallas = false evaluates the module")


def packed_field(field):
    """``field`` with its weights packed once where it packs (the field
    kernels' wrappers), else the field itself (a module)."""
    return field.pack() if hasattr(field, "pack") else field


def _kernel_route(model, settings: RenderSettings, use_kernels: bool,
                  for_train: bool = True):
    """``(fused_render, field)``: the family's fused render where nerf_tpu
    takes one (``_tpu_kernel_width``; for a Plenoxels model the eval-only
    fused grid render, which a training route skips), else
    ``fused_field_for`` as the field factory (the field route); raises for
    a family the port does not have; ``(None, None)`` for the module
    path."""
    if not use_kernels:
        return None, None
    if isinstance(model, PlenoxelsModel):
        fr = make_fused_grid_render(model, settings.near, settings.far,
                                    normalize=settings.normalize_positions)
        if fr is not None and not (for_train and fr.eval_only):
            return fr, None
        return None, fused_field_for
    if not isinstance(model, (NeRFModel, SirenModel, GaborModel, KiloNeRFModel)):
        raise NotImplementedError(
            f"no fused render and no field kernels for {type(model).__name__} in "
            "nerf_tpu_torch yet (ROADMAP.md queue 2; use_pallas = false renders "
            "through the module)")
    if type(model) in _FUSED and _tpu_kernel_width(model):
        return fused_render_for(model, settings), None
    return None, fused_field_for


def train_field(model, settings: RenderSettings, use_kernels: bool):
    """The field through which ``fit`` bakes ``model``'s occupancy prior, as
    nerf_tpu's loop picks its ``apply_fn``: the module where a fused render
    engages (or without kernels), else the field route's field."""
    _, field = _kernel_route(model, settings, use_kernels)
    return model if field is None else field(model)


def check_finite(what: str, loss: torch.Tensor, models) -> None:
    """``debug_nans``: raise ``FloatingPointError`` naming ``what`` (the
    step) if ``loss`` or any gradient of ``models`` is not finite (the
    counterpart of ``jax_debug_nans`` in nerf_tpu's loop)."""
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(
            f"debug_nans: non-finite loss ({float(loss.detach())}) at {what}")
    for m in models:
        for name, p in m.named_parameters():
            if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
                raise FloatingPointError(
                    f"debug_nans: non-finite gradient of {name} at {what}")


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _make_step_body(model, settings: RenderSettings, batch_size: int,
                    seed: int, use_pallas: bool = True,
                    epoch_sampling: bool = False,
                    occupancy_opts: Optional[tuple] = None,
                    debug_nans: bool = False, regularizer=None):
    """``(sample, train_on_batch)``: ``sample(state, pool) -> RayBatch``
    draws the batch of ``state.step``; ``train_on_batch(state, batch,
    occ_grid=None) -> metrics`` renders, takes the loss and its gradient,
    and updates ``state`` in place (the step counter too). ``metrics`` holds
    ``loss``, ``mse`` and ``psnr`` as device scalars. With ``use_pallas``
    each pass is one train-kernel launch of the family's fused render, or,
    for a model without one, the field route (its field under autograd);
    without, the unfused module path under autograd.

    ``occupancy_opts = (domain, num_bins, floor)`` gives meaning to the
    ``occ_grid`` argument: an (R, R, R, 1) {0, 1} prior (``fit`` rebakes it
    at intervals) from which the coarse pass draws its samples.
    ``regularizer(state) -> scalar`` adds to the loss (not to the mse).
    With ``debug_nans`` a non-finite loss or gradient raises
    ``FloatingPointError`` before the update."""
    fused_render, field = _kernel_route(model, settings, use_pallas)

    def _occ(occ_grid) -> Optional[OccupancyGrid]:
        if occ_grid is None:
            return None
        domain, num_bins, floor = occupancy_opts
        return OccupancyGrid(grid=occ_grid, domain=domain, num_bins=num_bins,
                             floor=floor)

    def sample(state: TrainState, pool: RayPool) -> RayBatch:
        if epoch_sampling:
            return pool.sample_epoch(seed, state.step, batch_size)
        gen = _generator(pool.rays_o.device, step_seed(seed, state.step, SAMPLE))
        return pool.sample(gen, batch_size)

    def loss_fn(state: TrainState, batch: RayBatch, gen, occupancy):
        if fused_render is not None:
            return render_rays_train(
                fused_render, state.params, batch.rays_o, batch.rays_d,
                settings, batch.rgb, generator=gen,
                fine_params=state.fine_params, viewdirs=batch.viewdirs,
                occupancy=occupancy)
        params, fine = state.params, state.fine_params
        if field is not None:
            params = field(params)
            fine = field(fine) if fine is not None else None
        out = render_rays(params, batch.rays_o, batch.rays_d, settings,
                          generator=gen, fine_params=fine,
                          viewdirs=batch.viewdirs, occupancy=occupancy)
        mse = torch.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if settings.num_fine_samples > 0:
            loss = loss + torch.mean((out.rgb_coarse - batch.rgb) ** 2)
        return loss, mse

    def train_on_batch(state: TrainState, batch: RayBatch, occ_grid=None) -> dict:
        gen = _generator(batch.rays_o.device, step_seed(seed, state.step, RENDER))
        for m in state.models():
            m.zero_grad(set_to_none=True)
        loss, mse = loss_fn(state, batch, gen, _occ(occ_grid))
        if regularizer is not None:
            loss = loss + regularizer(state)
        loss.backward()
        if debug_nans:
            check_finite(f"step {state.step}", loss, state.models())
        state.optimizer.step()
        state.step += 1
        mse = mse.detach()
        return {"loss": loss.detach(), "mse": mse, "psnr": -10.0 * torch.log10(mse)}

    return sample, train_on_batch


def make_train_step(model, settings: RenderSettings, batch_size: int,
                    seed: int, use_pallas: bool = True,
                    epoch_sampling: bool = False,
                    occupancy_opts: Optional[tuple] = None,
                    debug_nans: bool = False, regularizer=None):
    """``step(state, pool, occ_grid=None) -> metrics``: one iteration,
    ``state`` updated in place (``_make_step_body`` for the options)."""
    sample, train_on_batch = _make_step_body(model, settings, batch_size, seed,
                                             use_pallas, epoch_sampling,
                                             occupancy_opts, debug_nans,
                                             regularizer)

    def step(state: TrainState, pool: RayPool, occ_grid=None) -> dict:
        return train_on_batch(state, sample(state, pool), occ_grid)

    return step


def make_scan_train_step(model, settings: RenderSettings, batch_size: int,
                         seed: int, num_steps: int, use_pallas: bool = True,
                         epoch_sampling: bool = False,
                         occupancy_opts: Optional[tuple] = None,
                         debug_nans: bool = False, regularizer=None):
    """``step_n(state, pool, occ_grid=None) -> metrics``: ``num_steps``
    iterations in a Python loop, each metric stacked to ``(num_steps,)``.
    The draws key off ``state.step``, so N steps here equal N single
    steps."""
    step = make_train_step(model, settings, batch_size, seed, use_pallas,
                           epoch_sampling, occupancy_opts, debug_nans, regularizer)

    def step_n(state: TrainState, pool: RayPool, occ_grid=None) -> dict:
        ms = [step(state, pool, occ_grid) for _ in range(num_steps)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step_n


def make_eval_render(model, settings: RenderSettings, fused: bool = True,
                     occupancy: Optional[OccupancyGrid] = None):
    """Returns ``render(params, fine_params, rays_o, rays_d, generator=None,
    viewdirs=None, hw=None) -> RenderOutput``, where ``params``/
    ``fine_params`` are models of ``model``'s family (``fine_params`` None:
    the coarse model renders both passes). With ``fused`` each pass runs the
    family's fused render where nerf_tpu takes one (eval-only renders
    included), else the field of ``fused_field_for`` (the field route);
    otherwise the module. A model's ``precompute`` hook (the Plenoxels
    grid's bfloat16 copy) runs once per image. For a model that
    ``wants_tile_order`` (with its grid kernels), ``hw = (h, w)`` of a
    whole image reorders the rays into 8x8 pixel blocks
    (``tile_ray_order``) and the outputs back. With ``occupancy`` the
    coarse samples come from that prior. Memory is bounded by
    ``settings.chunk_size`` ray tiles."""
    fused_render, field = _kernel_route(model, settings, fused, for_train=False)
    precompute = hasattr(model, "precompute")
    tile_order = (getattr(model, "wants_tile_order", False)
                  and getattr(model, "use_grid_kernel", True))
    perm_cache: dict = {}

    def prepare(p):
        # pack the weights once per image, not once per tile
        if p is None:
            return None
        if fused_render is not None:
            return fused_render.pack(p)
        if field is not None:
            p = packed_field(field(p))
        return p.precompute() if precompute else p

    @torch.no_grad()
    def render(params, fine_params, rays_o: torch.Tensor, rays_d: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               viewdirs: Optional[torch.Tensor] = None,
               hw: Optional[tuple] = None) -> RenderOutput:
        if viewdirs is None:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        inv = None
        if tile_order and hw is not None and hw[0] * hw[1] == rays_o.shape[0]:
            key = (tuple(hw), rays_o.device)
            if key not in perm_cache:
                p = tile_ray_order(hw[0], hw[1])
                perm_cache[key] = (torch.from_numpy(p).to(rays_o.device),
                                   torch.from_numpy(np.argsort(p)).to(rays_o.device))
            perm, inv = perm_cache[key]
            rays_o, rays_d, viewdirs = rays_o[perm], rays_d[perm], viewdirs[perm]
        out = render_image(prepare(params), rays_o, rays_d, settings,
                           generator=generator, fine_params=prepare(fine_params),
                           viewdirs=viewdirs, fused_render=fused_render,
                           occupancy=occupancy)
        if inv is not None:
            out = RenderOutput(*(x[inv] for x in out))
        return out

    render.occupancy = occupancy
    return render
