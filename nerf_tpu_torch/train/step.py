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
training routes skip, as nerf_tpu's ``for_train`` does; so does a baked
FastNeRF cache (its factor form). A live FastNeRF, PlenOctree or Instant
NGP model takes the module route (nerf_tpu has no kernel for any of them;
NGP's table gradient is the scatter-add kernel's). With an occupancy
grid (the ``occ_grid`` step argument) the coarse samples come from the
prior (``ops/occupancy.py``); a ``regularizer`` (the grid families' TV
prior, ``train/loop.py::make_regularizer``) adds to the loss; with
``debug_nans`` a non-finite loss or gradient raises ``FloatingPointError``
before the update.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.data.pipeline import RayBatch, RayPool
from nerf_tpu_torch.models.fastnerf import BakedFastNeRF, FastNeRFModel
from nerf_tpu_torch.models.gabor import GaborModel
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.models.ngp import NGPModel
from nerf_tpu_torch.models.plenoctree import PlenOctreeModel
from nerf_tpu_torch.models.plenoxels import PlenoxelsModel, PlenoxelsPack
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
    draw_uniforms,
    render_image,
    render_rays,
    render_rays_train,
)
from nerf_tpu_torch.train.state import TrainState

SAMPLE, RENDER, VALIDATE, DISTILL = 0, 1, 2, 3   # generator streams of a step
SCENE, RANK = 4, 5              # sub-seeds: a scene of a multi-scene run, a rank


def step_seed(seed: int, step: int, stream: int) -> int:
    """One 63-bit generator seed per (seed, step, stream)."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]
                                   ).generate_state(2)
    return (int(state[0]) << 31) ^ int(state[1])


def sub_seed(seed: int, kind: int, index: int) -> int:
    """The seed of scene (``kind`` SCENE) or rank (RANK) ``index`` of a run
    seeded with ``seed``: its steps draw from ``step_seed(sub_seed(...),
    step, stream)``."""
    return step_seed(seed, index, 1000 + kind)


_FUSED = {NeRFModel: FusedNerfRender, SirenModel: FusedSirenRender,
          GaborModel: FusedGaborRender}
# no field kernel in nerf_tpu for these; the caches (a Plenoxels model, a
# baked FastNeRF) render through the eval-only fused grid render
_GRID_CACHES = (PlenoxelsModel, BakedFastNeRF)
_MODULE_FIELDS = _GRID_CACHES + (PlenoxelsPack, FastNeRFModel, PlenOctreeModel, NGPModel)


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
    kernel (a Plenoxels model or a baked FastNeRF cache, whose ``apply``
    reaches the grid kernel; a live FastNeRF, PlenOctree or NGP model).
    Raises ``NotImplementedError`` on the card where nerf_tpu would take a
    field kernel at a shape the port's do not cover (naming its row of
    PERF.md's table: any of the three at hidden 512, a GaborNet of another
    depth than 8), and for a family the port does not have."""
    if isinstance(model, KiloNeRFModel):
        h = model.hidden_dim
        return KiloNeRFField(model) if 8 <= h <= 128 and h % 8 == 0 else model
    if isinstance(model, _MODULE_FIELDS):
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
    takes one (``_tpu_kernel_width``; for a Plenoxels model or a baked
    FastNeRF cache the eval-only fused grid render, which a training route
    skips), else ``fused_field_for`` as the field factory (the field route:
    the module for a live FastNeRF, PlenOctree or NGP model); raises for a
    family the port does not have; ``(None, None)`` for the module path."""
    if not use_kernels:
        return None, None
    if isinstance(model, _GRID_CACHES):
        fr = make_fused_grid_render(model, settings.near, settings.far,
                                    normalize=settings.normalize_positions)
        if fr is not None and not (for_train and fr.eval_only):
            return fr, None
        return None, fused_field_for
    if isinstance(model, (FastNeRFModel, PlenOctreeModel, NGPModel)):
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
                    debug_nans: bool = False, regularizer=None,
                    shard: Optional[tuple] = None, reduce=None):
    """``(sample, train_on_batch)``: ``sample(state, pool) -> RayBatch``
    draws the batch of ``state.step``; ``train_on_batch(state, batch,
    occ_grid=None) -> metrics`` renders, takes the loss and its gradient,
    and updates ``state`` in place (the step counter too). ``metrics`` holds
    ``loss``, ``mse`` and ``psnr`` as device scalars. With ``use_pallas``
    each pass is one train-kernel launch of the family's fused render, or,
    for a model without one, the field route (its field under autograd);
    without, the unfused module path under autograd.

    ``shard = (i, n)`` makes this the i-th of n data-parallel ranks of the
    same step (nerf_tpu's GSPMD step): ``sample`` draws the global batch of
    ``batch_size`` rays as one rank would and keeps rows ``i * batch_size /
    n`` onwards, and the render takes those rows of the global batch's
    draws. ``reduce(state, loss, mse) -> (loss, mse)`` runs between the
    backward pass and the update (``parallel/dp.py``: the gradients and
    metrics averaged over the ranks).

    ``occupancy_opts = (domain, num_bins, floor)`` gives meaning to the
    ``occ_grid`` argument: an (R, R, R, 1) {0, 1} prior (``fit`` rebakes it
    at intervals) from which the coarse pass draws its samples.
    ``regularizer(state) -> scalar`` adds to the loss (not to the mse).
    With ``debug_nans`` a non-finite loss or gradient raises
    ``FloatingPointError`` before the update."""
    fused_render, field = _kernel_route(model, settings, use_pallas)
    rows = None
    if shard is not None:
        if batch_size % shard[1]:
            raise ValueError(f"batch_size {batch_size} not divisible by {shard[1]}")
        local = batch_size // shard[1]
        rows = (shard[0] * local, (shard[0] + 1) * local)

    def _occ(occ_grid) -> Optional[OccupancyGrid]:
        if occ_grid is None:
            return None
        domain, num_bins, floor = occupancy_opts
        return OccupancyGrid(grid=occ_grid, domain=domain, num_bins=num_bins,
                             floor=floor)

    def sample(state: TrainState, pool: RayPool) -> RayBatch:
        if epoch_sampling:
            batch = pool.sample_epoch(seed, state.step, batch_size)
        else:
            gen = _generator(pool.rays_o.device, step_seed(seed, state.step, SAMPLE))
            batch = pool.sample(gen, batch_size)
        return batch if rows is None else RayBatch(*(x[rows[0]:rows[1]] for x in batch))

    def loss_fn(state: TrainState, batch: RayBatch, gen, occupancy):
        uniforms = None
        if rows is not None:
            uniforms = draw_uniforms(settings, batch_size, gen, batch.rays_o.device,
                                     occupancy is not None).rows(*rows)
        if fused_render is not None:
            return render_rays_train(
                fused_render, state.params, batch.rays_o, batch.rays_d,
                settings, batch.rgb, generator=gen,
                fine_params=state.fine_params, viewdirs=batch.viewdirs,
                occupancy=occupancy, uniforms=uniforms)
        params, fine = state.params, state.fine_params
        if field is not None:
            params = field(params)
            fine = field(fine) if fine is not None else None
        out = render_rays(params, batch.rays_o, batch.rays_d, settings,
                          generator=gen, fine_params=fine,
                          viewdirs=batch.viewdirs, occupancy=occupancy,
                          uniforms=uniforms)
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
        loss, mse = loss.detach(), mse.detach()
        if reduce is not None:
            loss, mse = reduce(state, loss, mse)
        if debug_nans:
            check_finite(f"step {state.step}", loss, state.models())
        state.optimizer.step()
        state.step += 1
        return {"loss": loss, "mse": mse, "psnr": -10.0 * torch.log10(mse)}

    return sample, train_on_batch


def make_train_step(model, settings: RenderSettings, batch_size: int,
                    seed: int, use_pallas: bool = True,
                    epoch_sampling: bool = False,
                    occupancy_opts: Optional[tuple] = None,
                    debug_nans: bool = False, regularizer=None,
                    shard: Optional[tuple] = None, reduce=None):
    """``step(state, pool, occ_grid=None) -> metrics``: one iteration,
    ``state`` updated in place (``_make_step_body`` for the options)."""
    sample, train_on_batch = _make_step_body(model, settings, batch_size, seed,
                                             use_pallas, epoch_sampling,
                                             occupancy_opts, debug_nans,
                                             regularizer, shard, reduce)

    def step(state: TrainState, pool: RayPool, occ_grid=None) -> dict:
        return train_on_batch(state, sample(state, pool), occ_grid)

    return step


def make_scan_train_step(model, settings: RenderSettings, batch_size: int,
                         seed: int, num_steps: int, use_pallas: bool = True,
                         epoch_sampling: bool = False,
                         occupancy_opts: Optional[tuple] = None,
                         debug_nans: bool = False, regularizer=None,
                         shard: Optional[tuple] = None, reduce=None):
    """``step_n(state, pool, occ_grid=None) -> metrics``: ``num_steps``
    iterations in a Python loop, each metric stacked to ``(num_steps,)``.
    The draws key off ``state.step``, so N steps here equal N single
    steps."""
    step = make_train_step(model, settings, batch_size, seed, use_pallas,
                           epoch_sampling, occupancy_opts, debug_nans, regularizer,
                           shard, reduce)

    def step_n(state: TrainState, pool: RayPool, occ_grid=None) -> dict:
        ms = [step(state, pool, occ_grid) for _ in range(num_steps)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step_n


class _Replicas:
    """Copies of models on other devices for a split render. A copy is made
    once and made again only when the model asked for is another object, or
    its tensors were written in place since (their ``_version``), so a fixed
    model (served, evaluated) is copied once, not once a frame."""

    def __init__(self):
        self._held: dict = {}

    def get(self, p, device: torch.device, slot: str):
        """``p`` (a model or None) on ``device``: itself where it lies
        there, else the copy held for ``slot`` on ``device``."""
        if p is None:
            return None
        tensors = list(itertools.chain(p.parameters(), p.buffers()))
        if tensors[0].device == device:
            return p
        version = tuple(t._version for t in tensors)
        held = self._held.get((slot, device))
        if held is None or held[0] is not p or held[1] != version:
            held = self._held[(slot, device)] = (p, version, copy.deepcopy(p).to(device))
        return held[2]


def _device_scope(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def make_eval_render(model, settings: RenderSettings, fused: bool = True,
                     occupancy: Optional[OccupancyGrid] = None,
                     devices: Optional[list] = None, group=None):
    """Returns ``render(params, fine_params, rays_o, rays_d, generator=None,
    viewdirs=None, hw=None) -> RenderOutput``, where ``params``/
    ``fine_params`` are models of ``model``'s family (``fine_params`` None:
    the coarse model renders both passes). With ``fused`` each pass runs the
    family's fused render where nerf_tpu takes one (eval-only renders
    included), else the field of ``fused_field_for`` (the field route);
    otherwise the module. A model's ``precompute`` hook (the Plenoxels
    grid's bfloat16 copy) runs once per image, unless the params come with
    it (a ``PlenoxelsPack``, as a baked PlenOctree cache is served; a baked
    FastNeRF cache carries its copy). For a model that
    ``wants_tile_order`` (with its grid kernels), ``hw = (h, w)`` of a
    whole image reorders the rays into 8x8 pixel blocks
    (``tile_ray_order``) and the outputs back. With ``occupancy`` the
    coarse samples come from that prior. Memory is bounded by
    ``settings.chunk_size`` ray tiles.

    The tiles split over ``devices`` (a list: tile k renders on device
    k mod n, on a replica of the models there; nerf_tpu's mesh render) or
    over the ranks of the process group ``group`` (tile k on its rank k mod
    n, the image summed over the group, where every other rank's rows are
    zeros). Each tile's draws come from ``generator`` in tile order, as the
    one-device render takes them, so a split image equals the one-device
    image bit for bit."""
    fused_render, field = _kernel_route(model, settings, fused, for_train=False)
    if group is not None and dist.get_world_size(group) == 1:
        group = None
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
        return p.precompute() if hasattr(p, "precompute") else p

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
        if devices is None and group is None:
            out = render_image(prepare(params), rays_o, rays_d, settings,
                               generator=generator, fine_params=prepare(fine_params),
                               viewdirs=viewdirs, fused_render=fused_render,
                               occupancy=occupancy)
        else:
            out = split_render(params, fine_params, rays_o, rays_d, viewdirs, generator)
        if inv is not None:
            out = RenderOutput(*(x[inv] for x in out))
        return out

    replicas = _Replicas()
    occ_on = ({} if devices is None or occupancy is None else
              {d: occupancy._replace(grid=occupancy.grid.to(d))
               for d in map(torch.device, devices)})

    def split_render(params, fine_params, rays_o, rays_d, viewdirs, generator):
        if devices is not None:
            parts = [(d, prepare(replicas.get(params, d, "coarse")),
                      prepare(replicas.get(fine_params, d, "fine")), occ_on.get(d))
                     for d in map(torch.device, devices)]
            mine = range(len(parts))
        else:
            here = (rays_o.device, prepare(params), prepare(fine_params), occupancy)
            parts = [here] * dist.get_world_size(group)
            mine = [dist.get_rank(group)]
        n, tile = rays_o.shape[0], settings.chunk_size
        outs = {}
        for k, lo in enumerate(range(0, n, tile)):
            hi = min(lo + tile, n)
            u = draw_uniforms(settings, hi - lo, generator, rays_o.device,
                              occupancy is not None)
            if k % len(parts) not in mine:
                continue
            d, p, fp, occ = parts[k % len(parts)]
            with _device_scope(d):
                outs[lo] = render_rays(p, rays_o[lo:hi].to(d), rays_d[lo:hi].to(d),
                                       settings, fine_params=fp,
                                       viewdirs=viewdirs[lo:hi].to(d),
                                       fused_render=fused_render, occupancy=occ,
                                       uniforms=u.to(d))
        if devices is not None:
            return RenderOutput(*(torch.cat([o[j].to(rays_o.device) for o in outs.values()])
                                  for j in range(len(RenderOutput._fields))))
        # one buffer of every field (rgb 3, depth, acc, disparity, rgb_coarse 3)
        flat = torch.zeros(n, 9, device=rays_o.device)
        for lo, o in outs.items():
            flat[lo:lo + o.rgb.shape[0]] = torch.cat(
                [o.rgb, o.depth[:, None], o.acc[:, None], o.disparity[:, None],
                 o.rgb_coarse], dim=1)
        dist.all_reduce(flat, group=group)
        return RenderOutput(flat[:, :3], flat[:, 3], flat[:, 4], flat[:, 5], flat[:, 6:])

    render.occupancy = occupancy
    return render
