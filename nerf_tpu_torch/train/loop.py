"""The training loop, as ``nerf_tpu.train.loop.fit`` on one device.

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
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import load_scene
from nerf_tpu_torch.data.rays import compute_rays
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.utils.device import resolve_device


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
    the ROADMAP.md (queue 1) row that ports them. (Other model families
    and LLFF scenes raise where the model and the scene are built.)"""
    rows = []
    if cfg.occupancy_res > 0:
        rows.append("occupancy_res (row 13: ops/occupancy.py)")
    if cfg.upsample_steps.strip():
        rows.append("upsample_steps (row 13: grid families)")
    if cfg.tv_lambda or cfg.tv_sh_lambda:
        rows.append("tv_lambda / tv_sh_lambda (row 13: grid families)")
    if cfg.mesh_shape.strip() or cfg.multihost:
        rows.append("mesh_shape / multihost (row 14: parallel)")
    if rows:
        raise NotImplementedError(
            "not ported to nerf_tpu_torch yet (ROADMAP.md queue 1): "
            + "; ".join(rows))


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
    """Train per the config on ``device``; returns the final TrainState."""
    from nerf_tpu_torch.train.optim import lr_schedule
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.train.step import (
        make_eval_render,
        VALIDATE,
        make_scan_train_step,
        step_seed,
    )
    from nerf_tpu_torch.utils.checkpoint import (
        AsyncCheckpointSaver,
        read_metadata,
        restore_train_state,
        save_train_state,
    )
    from nerf_tpu_torch.utils.logging import MetricLogger
    from nerf_tpu_torch.utils.metrics import mse_to_psnr
    from nerf_tpu_torch.utils.profiling import Throughput, trace
    from nerf_tpu_torch.utils.timer import format_elapsed_time

    dev = resolve_device(device)
    if resume_path is not None:
        # the checkpoint is self-describing: its model_type and (for grid
        # families) its grid_res win, so the restored shapes match
        meta = read_metadata(resume_path)
        cfg = dataclasses.replace(
            cfg, model_type=meta.get("model_type", cfg.model_type).lower(),
            grid_res=int(meta.get("grid_res", cfg.grid_res)))
    check_ported(cfg)
    np.random.seed(cfg.seed)
    print_config_summary(cfg, dev, log)
    num_iters = int(max_steps if max_steps is not None else cfg.num_iters)

    log("Loading dataset...")
    scene = load_scene(cfg, device=dev)
    cfg = dataclasses.replace(cfg, near=float(scene.near), far=float(scene.far))
    settings = dataclasses.replace(render_settings_from_config(cfg),
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
    max_chunk = cfg.steps_per_call
    if max_chunk <= 0:
        max_chunk = min(math.gcd(math.gcd(cfg.log_interval, cfg.val_interval),
                                 cfg.save_interval), 100)
    step_fns: dict = {}

    def get_step_fn(c: int):
        if c not in step_fns:
            step_fns[c] = make_scan_train_step(
                model, settings, cfg.num_random_rays, cfg.seed, num_steps=c,
                use_pallas=cfg.use_pallas, epoch_sampling=cfg.epoch_sampling)
        return step_fns[c]

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
        return min(candidates)

    eval_render = make_eval_render(model, settings, fused=cfg.use_pallas)
    schedule = lr_schedule(cfg.learning_rate, cfg.lr_decay, cfg.lr_decay_factor,
                           cfg.lr_min)
    os.makedirs(cfg.save_path, exist_ok=True)
    saver = AsyncCheckpointSaver()
    logger = MetricLogger(log_dir=cfg.log_dir, model_type=cfg.model_type,
                          dataset_name=scene.name, config_text=str(cfg),
                          echo=log)
    if resume_path is None and cfg.distill_from and cfg.distill_steps > 0:
        from nerf_tpu_torch.train.distill import run_distillation

        log(f"Distilling from teacher {cfg.distill_from} "
            f"({cfg.distill_steps} field-matching steps)...")
        state = run_distillation(cfg, state, device=dev, log=log,
                                 log_scalar=logger.log_scalar)
    start_time = datetime.datetime.now()

    def run_validation(step: int) -> None:
        idx = np.random.randint(scene.val_images.shape[0])
        val_img = scene.val_images[idx]
        c2w = np.eye(4, dtype=np.float32)
        c2w[: scene.val_c2w.shape[1]] = scene.val_c2w[idx]
        rays_o, rays_d, _ = compute_rays(val_img[None], c2w[None], scene.focal)
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(cfg.seed, step, VALIDATE))
        out = eval_render(state.params, state.fine_params,
                          torch.from_numpy(rays_o[0]).to(dev),
                          torch.from_numpy(rays_d[0]).to(dev), gen)
        pred = out.rgb.reshape(*scene.hw, 3).cpu().numpy()
        val_psnr = float(mse_to_psnr(float(np.mean((pred - val_img) ** 2))))
        logger.log_validation(step, val_psnr, pred)

    throughput = Throughput(warmup=2)
    step = start_step
    try:
        pos = start_step
        chunk_idx = 0
        while pos < num_iters:
            boundary = min(next_event(pos) + 1, num_iters)
            c = min(max_chunk, boundary - pos)
            if cfg.profile_dir and chunk_idx == 2:
                with trace(cfg.profile_dir):
                    metrics = get_step_fn(c)(state, scene.pool)
            else:
                metrics = get_step_fn(c)(state, scene.pool)
            step = pos + c - 1          # last executed iteration
            throughput.update(c * cfg.num_random_rays)
            chunk_idx += 1

            if step % cfg.log_interval == 0:
                logger.log_train(step, schedule(step), float(metrics["mse"][-1]))
                logger.log_scalar("rays_per_sec", throughput.rays_per_sec, step)
            if step % cfg.save_interval == 0 and 0 < step < num_iters - 1:
                with throughput.exclude():
                    path = saver.save(state, cfg.save_path, cfg.model_type, step)
                log(f"[{format_elapsed_time(start_time)}] Model saved to "
                    f"{path} at iteration {step}")
            if step % cfg.val_interval == 0 and (step > 0 or cfg.first_step_render):
                with throughput.exclude():
                    run_validation(step)
            pos += c

        saver.wait()     # durability before the final (blocking) save
        final = save_train_state(state, cfg.save_path, cfg.model_type, num_iters)
        elapsed = format_elapsed_time(start_time)
        log(f"[{elapsed}] Training complete!")
        log(f"[{elapsed}] Final model saved to {final}")
    except KeyboardInterrupt:
        elapsed = format_elapsed_time(start_time)
        log(f"\n[{elapsed}] Keyboard interrupt! Saving current checkpoint...")
        saver.wait()
        path = save_train_state(state, cfg.save_path, cfg.model_type, step)
        log(f"[{elapsed}] Checkpoint saved to {path}. Exiting training.")
    finally:
        saver.wait()
        logger.close()
    return state
