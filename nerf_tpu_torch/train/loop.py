"""The training loop, as ``nerf_tpu.train.loop.fit``.

Same observable behaviour: seeding, the config summary, interval-driven
logging, checkpointing and validation under the same conditions, resume,
the final save and a save on SIGINT. Between host touchpoints (log, save,
validation) the loop runs chunks of steps (``make_scan_train_step``, sized
by ``next_event``); metrics stay on the device except on log steps.

Bookkeeping mirrors the JAX loop exactly: a checkpoint records the last
executed iteration as its step while ``state.step`` is one ahead, and a
resumed run restarts the loop counter at the recorded step. A fresh run
with ``distill_from`` first distils that teacher into the model
(``train/distill.py``) and then trains from step 0; a resumed run skips it
(the checkpoint already carries it).

With ``occupancy_res`` the loop bakes an occupancy prior from the live
field before the first step (after distillation, or from the restored
parameters of a resume) and rebakes it after every ``occupancy_interval``-th
optimizer step, outside the throughput window, as nerf_tpu's loop does; the
field is the module where a fused render engages, else the field route's.
The rebakes key off the optimizer step, which runs one ahead of the loop
counter after a resume, so a run resumed from a checkpoint taken at a
rebake repeats the first run bit for bit (nerf_tpu's loop keys them off its
counter and rebakes once more after a resume's first step). With
``debug_nans`` a non-finite loss or gradient raises ``FloatingPointError``
naming the step. ``multihost`` and ``mesh_shape`` train over several ranks
(``fit``'s docstring; ``parallel/``).

Grid families (Plenoxels): ``tv_lambda`` / ``tv_sh_lambda`` add the total-
variation prior to the loss (``make_regularizer``), and ``upsample_steps``
(``"step:res,..."``) resamples the grid to ``res`` before iteration
``step`` and restarts Adam at the new shape (``do_upsample``); entries at
or before a resume's step, or not above the restored grid's resolution,
are already in the checkpoint and drop out.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import load_scene
from nerf_tpu_torch.data.rays import compute_rays
from nerf_tpu_torch.ops.ndc import ndc_rays
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.utils.device import resolve_device


def _quiet(*_) -> None:
    """The console of a rank that is not the primary."""


def resolve_eval_chunk(cfg: Config) -> int:
    """Ray tile of full-image renders: ``eval_chunk_size`` when set, else
    ``chunk_size`` (the reference's memory bound)."""
    if cfg.eval_chunk_size > 0:
        return cfg.eval_chunk_size
    return cfg.chunk_size


def render_settings_from_config(cfg: Config, ndc: bool = False) -> RenderSettings:
    return RenderSettings(
        near=cfg.near,
        far=cfg.far,
        num_samples=cfg.num_samples,
        num_fine_samples=cfg.num_fine_samples,
        white_background=cfg.white_background and not ndc,
        jitter_mode=cfg.jitter_mode,
        perturb=cfg.perturb,
        chunk_size=resolve_eval_chunk(cfg),
        normalize_positions=not ndc,
        fine_sampling=cfg.fine_sampling,
    )


def check_ported(cfg: Config) -> None:
    """Raise for config options whose modules are not ported yet, naming
    the ROADMAP.md (queue 1) row that ports them. Since ``mesh_shape`` and
    ``multihost`` (row 14) every option that ``fit`` reads is ported, so
    nothing raises."""


def make_regularizer(cfg: Config, model):
    """``cfg.tv_lambda`` / ``cfg.tv_sh_lambda`` -> ``reg(state) -> scalar``
    over the state's models (coarse and fine), or None when both are 0, as
    ``nerf_tpu.train.loop.make_regularizer``. Only grid families have a
    ``tv`` (Plenoxels); the knobs on any other family are a config error."""
    if cfg.tv_lambda == 0.0 and cfg.tv_sh_lambda == 0.0:
        return None
    if not hasattr(model, "tv"):
        raise ValueError(
            f"tv_lambda/tv_sh_lambda set but model '{cfg.model_type}' has no TV "
            "regularizer (voxel-grid families only)")

    def reg(state):
        total = 0.0
        for m in state.models():
            tv_sigma, tv_sh = m.tv()
            total = total + cfg.tv_lambda * tv_sigma + cfg.tv_sh_lambda * tv_sh
        return total

    return reg


def parse_upsample_steps(spec: str) -> list:
    """``"2000:64,5000:128"`` -> ``[(2000, 64), (5000, 128)]``, the
    coarse-to-fine schedule; steps and resolutions must strictly
    increase."""
    if not spec.strip():
        return []
    out = []
    for item in spec.split(","):
        s, _, r = item.strip().partition(":")
        if not r:
            raise ValueError(f"upsample_steps entries are 'step:res', got '{item}'")
        out.append((int(s), int(r)))
    if out[0][0] <= 0:
        raise ValueError("upsample steps must be > 0")
    for (s0, r0), (s1, r1) in zip(out, out[1:]):
        if s1 <= s0 or r1 <= r0:
            raise ValueError(f"upsample_steps must increase in step and res: '{spec}'")
    return out


def print_config_summary(cfg: Config, device: torch.device, log=print) -> None:
    log("===== Training Configuration Summary =====")
    for field in (
        "dataset_path num_random_rays chunk_size num_samples num_fine_samples "
        "num_iters learning_rate near far save_path save_interval lr_decay "
        "lr_decay_factor lr_min first_step_render log_interval val_interval "
        "model_type compute_dtype use_pallas".split()
    ):
        log(f"{field}: {getattr(cfg, field)}")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"device: {device} ({kind})")
    log("==========================================")


def fit(cfg: Config, resume_path: Optional[str] = None,
        max_steps: Optional[int] = None, device: str | torch.device = "cuda",
        log=print):
    """Train per the config on ``device``; returns the final TrainState.

    With ``multihost`` or a ``mesh_shape``, ``fit`` joins the process group
    (``parallel/multihost.py::init_distributed``: torchrun's environment,
    or a group its caller made) and, where there is one, trains over the
    mesh's ``data`` axis as nerf_tpu's GSPMD step does: every rank holds the
    pool and draws the one-rank step's global batch, renders its slice of
    it, and the gradients, loss and mse are averaged with one
    ``all_reduce`` before the update (``parallel/dp.py``), so D ranks train
    on the one-rank batches. Validation splits the image's tiles over the
    data ranks. Only the primary rank prints, logs and writes checkpoints;
    the others wait for its saves at a barrier."""
    from nerf_tpu_torch.train.optim import lr_schedule, make_optimizer
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.train.step import (
        VALIDATE,
        make_eval_render,
        make_scan_train_step,
        step_seed,
        train_field,
    )
    from nerf_tpu_torch.utils.checkpoint import (
        AsyncCheckpointSaver,
        read_metadata,
        restore_train_state,
        save_train_state,
    )
    from nerf_tpu_torch.utils.logging import MetricLogger
    from nerf_tpu_torch.utils.metrics import mse_to_psnr
    from nerf_tpu_torch.parallel.multihost import barrier
    from nerf_tpu_torch.utils.profiling import Throughput, trace
    from nerf_tpu_torch.utils.timer import format_elapsed_time

    mesh = None
    if cfg.multihost or cfg.mesh_shape.strip():
        from nerf_tpu_torch.parallel.mesh import create_mesh
        from nerf_tpu_torch.parallel.multihost import init_distributed

        init_distributed(device=device)
        if dist.is_initialized():
            mesh = create_mesh(cfg.mesh_shape)
    primary = mesh is None or mesh.rank == 0
    if not primary:
        log = _quiet
    dev = resolve_device(device)
    if resume_path is not None:
        # the checkpoint is self-describing: its model_type and (for grid
        # families) its grid_res win, so the restored shapes match
        meta = read_metadata(resume_path)
        cfg = dataclasses.replace(
            cfg, model_type=meta.get("model_type", cfg.model_type).lower(),
            grid_res=int(meta.get("grid_res", cfg.grid_res)))
    np.random.seed(cfg.seed)
    print_config_summary(cfg, dev, log)
    if mesh is not None:
        log(f"Mesh: {mesh.shape} (rank {mesh.rank})")
    num_iters = int(max_steps if max_steps is not None else cfg.num_iters)

    log("Loading dataset...")
    scene = load_scene(cfg, device=dev)
    # the scene's interval (LLFF: its bounds, or [0, 1] for NDC) is set
    # before the model is built: a grid family's domain derives from it
    cfg = dataclasses.replace(cfg, near=float(scene.near), far=float(scene.far))
    settings = dataclasses.replace(render_settings_from_config(cfg, ndc=scene.ndc),
                                   white_background=scene.white_background)
    log(f"Loaded scene '{scene.name}': {scene.pool.size} train rays, "
        f"{scene.val_images.shape[0]} val images {scene.hw[0]}x{scene.hw[1]}")

    state = create_train_state(cfg, device=dev)
    start_step = 0
    if resume_path is not None:
        restore_train_state(state, resume_path)
        start_step = int(read_metadata(resume_path)["step"])
        log(f"Resuming training from iteration {start_step}")

    model = state.params
    regularizer = make_regularizer(cfg, model)
    upsample_sched = parse_upsample_steps(cfg.upsample_steps)
    if upsample_sched and not hasattr(model, "upsample"):
        raise ValueError(f"upsample_steps set but model '{cfg.model_type}' has no "
                         "upsample hook (voxel-grid families only)")
    upsample_sched = [(s, r) for s, r in upsample_sched
                      if s > start_step and r > model.grid_res]
    max_chunk = cfg.steps_per_call
    if max_chunk <= 0:
        max_chunk = min(math.gcd(math.gcd(cfg.log_interval, cfg.val_interval),
                                 cfg.save_interval), 100)
    step_fns: dict = {}
    shard = reduce = val_group = None
    if mesh is not None:
        from nerf_tpu_torch.parallel.dp import grad_reducer

        # nerf_tpu's GSPMD step: the one-rank batch, a slice a data rank
        shard = (mesh.index("data"), mesh.size("data"))
        reduce = grad_reducer(mesh.group("data"))
        val_group = mesh.group("data")

    occ_opts = None
    if cfg.occupancy_res > 0:
        from nerf_tpu_torch.models.registry import grid_domain

        occ_opts = (grid_domain(cfg), 64, 1e-2)

    def get_step_fn(c: int):
        if c not in step_fns:
            step_fns[c] = make_scan_train_step(
                model, settings, cfg.num_random_rays, cfg.seed, num_steps=c,
                use_pallas=cfg.use_pallas, epoch_sampling=cfg.epoch_sampling,
                occupancy_opts=occ_opts, debug_nans=cfg.debug_nans,
                regularizer=regularizer, shard=shard, reduce=reduce)
        return step_fns[c]

    # the optimizer step runs ``occ_lead`` ahead of the loop counter (1 after
    # a resume); the rebakes follow the optimizer step
    occ_lead = state.step - start_step

    def next_event(i: int) -> int:
        """Smallest step >= i at which the host must act (log/save/val)."""
        def next_mult(j: int, k: int) -> int:
            return ((j + k - 1) // k) * k

        candidates = [next_mult(i, cfg.log_interval)]
        s = next_mult(max(i, cfg.save_interval), cfg.save_interval)
        if 0 < s < num_iters - 1:
            candidates.append(s)
        v = next_mult(i, cfg.val_interval)
        if v == 0 and not cfg.first_step_render:
            v = cfg.val_interval
        candidates.append(v)
        if occ_opts is not None:
            candidates.append(next_mult(max(i + occ_lead, 1), cfg.occupancy_interval)
                              - occ_lead)
        if upsample_sched and upsample_sched[0][0] - 1 >= i:
            # a chunk ends right before an upsample step
            candidates.append(upsample_sched[0][0] - 1)
        return min(candidates)

    eval_render = make_eval_render(model, settings, fused=cfg.use_pallas, group=val_group)

    def do_upsample(new_res: int) -> None:
        """Resample the grid(s) to ``new_res`` and restart Adam at the new
        shape (the paper restarts it too); the draws key off state.step and
        are untouched. The eval render is rebuilt for the new grid."""
        nonlocal eval_render
        for m in state.models():
            m.set_grid(m.upsample(new_res))
        state.optimizer = make_optimizer(
            cfg, [p for m in state.models() for p in m.parameters()])
        eval_render = make_eval_render(model, settings, fused=cfg.use_pallas,
                                       group=val_group)

    schedule = lr_schedule(cfg.learning_rate, cfg.lr_decay, cfg.lr_decay_factor,
                           cfg.lr_min)
    if primary:
        os.makedirs(cfg.save_path, exist_ok=True)
    saver = AsyncCheckpointSaver()
    logger = MetricLogger(log_dir=cfg.log_dir if primary else None,
                          model_type=cfg.model_type, dataset_name=scene.name,
                          config_text=str(cfg), echo=log)

    def save(path_fn, step: int) -> Optional[str]:
        """Only the primary rank writes; the others wait for it."""
        path = path_fn(state, cfg.save_path, cfg.model_type, step) if primary else None
        barrier()
        return path
    if resume_path is None and cfg.distill_from and cfg.distill_steps > 0:
        from nerf_tpu_torch.train.distill import run_distillation

        log(f"Distilling from teacher {cfg.distill_from} "
            f"({cfg.distill_steps} field-matching steps)...")
        state = run_distillation(cfg, state, device=dev, log=log,
                                 log_scalar=logger.log_scalar)
    occ_grid = None
    if occ_opts is not None:
        from nerf_tpu_torch.ops.occupancy import bake_occupancy, sigma_field

        bake_from = train_field(model, settings, cfg.use_pallas)

        def bake_occ():
            return bake_occupancy(sigma_field(bake_from), grid_res=cfg.occupancy_res,
                                  domain=occ_opts[0], threshold=cfg.occupancy_thresh,
                                  device=dev)

        occ_grid = bake_occ()
    start_time = datetime.datetime.now()

    def run_validation(step: int) -> None:
        idx = np.random.randint(scene.val_images.shape[0])
        val_img = scene.val_images[idx]
        c2w = np.eye(4, dtype=np.float32)
        c2w[: scene.val_c2w.shape[1]] = scene.val_c2w[idx]
        rays_o, rays_d, _ = compute_rays(val_img[None], c2w[None], scene.focal)
        rays_o, rays_d = torch.from_numpy(rays_o[0]), torch.from_numpy(rays_d[0])
        viewdirs = None
        if scene.ndc:
            viewdirs = rays_d.to(dev)
            rays_o, rays_d = ndc_rays(*scene.hw, scene.focal, 1.0, rays_o, rays_d)
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(cfg.seed, step, VALIDATE))
        out = eval_render(state.params, state.fine_params, rays_o.to(dev),
                          rays_d.to(dev), gen, viewdirs=viewdirs, hw=scene.hw)
        pred = out.rgb.reshape(*scene.hw, 3).cpu().numpy()
        val_psnr = float(mse_to_psnr(float(np.mean((pred - val_img) ** 2))))
        logger.log_validation(step, val_psnr, pred)

    throughput = Throughput(warmup=2)
    step = start_step
    try:
        pos = start_step
        chunk_idx = 0
        while pos < num_iters:
            while upsample_sched and pos >= upsample_sched[0][0]:
                _, new_res = upsample_sched.pop(0)
                with throughput.exclude():
                    do_upsample(new_res)
                log(f"[{format_elapsed_time(start_time)}] Upsampled grid to "
                    f"{new_res}^3 at iteration {pos}")
            boundary = min(next_event(pos) + 1, num_iters)
            c = min(max_chunk, boundary - pos)
            if cfg.profile_dir and chunk_idx == 2 and primary:
                with trace(cfg.profile_dir):
                    metrics = get_step_fn(c)(state, scene.pool, occ_grid)
            else:
                metrics = get_step_fn(c)(state, scene.pool, occ_grid)
            step = pos + c - 1          # last executed iteration
            throughput.update(c * cfg.num_random_rays)
            chunk_idx += 1

            if step % cfg.log_interval == 0:
                logger.log_train(step, schedule(step), float(metrics["mse"][-1]))
                logger.log_scalar("rays_per_sec", throughput.rays_per_sec, step)
            if (occ_grid is not None and step + occ_lead > 0
                    and (step + occ_lead) % cfg.occupancy_interval == 0):
                with throughput.exclude():
                    occ_grid = bake_occ()
            if step % cfg.save_interval == 0 and 0 < step < num_iters - 1:
                with throughput.exclude():
                    path = save(saver.save, step)
                log(f"[{format_elapsed_time(start_time)}] Model saved to "
                    f"{path} at iteration {step}")
            if step % cfg.val_interval == 0 and (step > 0 or cfg.first_step_render):
                with throughput.exclude():
                    run_validation(step)
            pos += c

        saver.wait()     # durability before the final (blocking) save
        final = save(save_train_state, num_iters)
        elapsed = format_elapsed_time(start_time)
        log(f"[{elapsed}] Training complete!")
        log(f"[{elapsed}] Final model saved to {final}")
    except KeyboardInterrupt:
        elapsed = format_elapsed_time(start_time)
        log(f"\n[{elapsed}] Keyboard interrupt! Saving current checkpoint...")
        saver.wait()
        path = save(save_train_state, step)
        log(f"[{elapsed}] Checkpoint saved to {path}. Exiting training.")
    finally:
        saver.wait()
        logger.close()
    return state
