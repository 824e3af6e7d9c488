"""Multi-scene training driver, as ``nerf_tpu.train.multiscene_loop``: S
scenes trained together (BASELINE.json config 5), one model per scene, on
``parallel/multiscene.py``'s step.

Step for step nerf_tpu's driver: pools trimmed to the smallest, one image
resolution for every scene, the mesh spec's default and its scene-axis
check, chunks of steps between host touchpoints (``next_event``), a
per-scene validation render (LLFF scenes through NDC rays) with
``scene{i}/mse``, ``scene{i}/val_psnr`` and ``val/psnr`` scalars, one
stacked checkpoint ``{model_type}_multiscene`` whose metadata carries
``num_scenes``, ``scenes`` and ``base_model_type``, a resume that refuses
another number of scenes, and interval, final and SIGINT saves. Under a
mesh, the ``scene`` axis splits the scenes over rank groups and the
``data`` axis splits each scene's batch as ``fit`` does; only the primary
rank prints, logs and writes, from states gathered to it.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import RayPool, load_scene
from nerf_tpu_torch.data.rays import compute_rays
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.ops.ndc import ndc_rays
from nerf_tpu_torch.parallel.mesh import create_mesh
from nerf_tpu_torch.parallel.multihost import barrier, world_size
from nerf_tpu_torch.parallel.multiscene import (
    gather_scene_values,
    local_scenes,
    make_multiscene_train_step,
    scene_seed,
)
from nerf_tpu_torch.train.loop import (
    _quiet,
    make_regularizer,
    print_config_summary,
    render_settings_from_config,
)
from nerf_tpu_torch.utils.device import resolve_device


def _gather_payload(states: list, scenes: range, mesh, model_type: str, step: int,
                    num_scenes: int) -> Optional[dict]:
    """The stacked payload of every scene on the primary rank (None on the
    others): the first data rank of each scene group sends its scenes'
    states, on the CPU."""
    from nerf_tpu_torch.utils.checkpoint import scenes_payload, train_payload

    if not dist.is_initialized() or mesh.size("scene") == 1:
        if mesh.rank != 0:
            return None
        return scenes_payload([train_payload(st, model_type, step) for st in states])
    mine = None
    if mesh.index("data") == 0:
        mine = [(i, train_payload(st, model_type, step)) for i, st in zip(scenes, states)]
    got = [None] * dist.get_world_size() if mesh.rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    if mesh.rank != 0:
        return None
    parts = dict(p for g in got if g for p in g)
    return scenes_payload([parts[i] for i in range(num_scenes)])


def fit_multiscene(cfg: Config, dataset_paths: Sequence[str],
                   resume_path: Optional[str] = None, max_steps: Optional[int] = None,
                   device: str | torch.device = "cuda", log=print,
                   enable_tensorboard: bool = True) -> list:
    """Train one model per scene together. ``cfg`` gives the shared schedule
    and model, ``dataset_paths`` the scenes. The mesh comes from
    ``cfg.mesh_shape`` (e.g. ``"scene:2,data:1"``), or puts the scenes on
    the ``scene`` axis when the ranks divide among them, else every rank on
    ``data``. With ``cfg.log_dir`` and ``enable_tensorboard``, the primary
    rank also writes a TensorBoard event file, each validation's per-scene
    images (``scene{i}/val_render``) among its events. Returns this rank's
    scenes' TrainStates."""
    from nerf_tpu_torch.train.optim import lr_schedule
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.train.step import VALIDATE, make_eval_render, step_seed
    from nerf_tpu_torch.utils.checkpoint import (
        AsyncCheckpointSaver,
        load_checkpoint,
        read_metadata,
        restore_scene,
        save_payload,
    )
    from nerf_tpu_torch.utils.logging import MetricLogger
    from nerf_tpu_torch.utils.metrics import mse_to_psnr
    from nerf_tpu_torch.utils.profiling import Throughput
    from nerf_tpu_torch.utils.timer import format_elapsed_time

    if cfg.multihost or cfg.mesh_shape.strip():
        from nerf_tpu_torch.parallel.multihost import init_distributed

        init_distributed(device=device)
    dev = resolve_device(device)
    num_scenes = len(dataset_paths)
    n = world_size()
    mesh_spec = cfg.mesh_shape
    if not mesh_spec:
        mesh_spec = (f"scene:{num_scenes},data:{n // num_scenes}"
                     if n % num_scenes == 0 and n >= num_scenes else f"scene:1,data:{n}")
    mesh = create_mesh(mesh_spec)
    primary = mesh.rank == 0
    if not primary:
        log = _quiet
    np.random.seed(cfg.seed)
    num_iters = int(max_steps if max_steps is not None else cfg.num_iters)
    print_config_summary(cfg, dev, log)
    log(f"Multi-scene training over {num_scenes} scenes: {list(dataset_paths)}")
    if "scene" in mesh.axis_names and num_scenes % mesh.size("scene"):
        raise ValueError(
            f"{num_scenes} scenes do not shard over mesh scene axis of "
            f"size {mesh.size('scene')} (mesh {mesh_spec!r})")
    log(f"Mesh: {mesh.shape}")
    mine = local_scenes(num_scenes, mesh)

    scenes = [load_scene(dataclasses.replace(cfg, dataset_path=p)) for p in dataset_paths]
    m = min(s.pool.size for s in scenes)
    # equal pools, as nerf_tpu stacks them: trim to the smallest (uniform
    # with-replacement sampling is unaffected by dropping the tail)
    pools = [RayPool(*(x[:m].to(dev) for x in scenes[i].pool)) for i in mine]
    hws = {s.hw for s in scenes}
    if len(hws) > 1:
        raise ValueError(
            f"multi-scene training stacks validation renders; all scenes "
            f"must share one image resolution, got {sorted(hws)}")
    cfg = dataclasses.replace(cfg, near=float(scenes[0].near), far=float(scenes[0].far))
    settings = dataclasses.replace(render_settings_from_config(cfg, ndc=scenes[0].ndc),
                                   white_background=scenes[0].white_background)
    log(f"Loaded {num_scenes} scenes x {m} train rays each, "
        f"{scenes[0].hw[0]}x{scenes[0].hw[1]}")

    states = [create_train_state(cfg, seed=scene_seed(cfg.seed, i), device=dev)
              for i in mine]
    models = [st.params for st in states]
    for st in states:
        for model in st.models():
            if hasattr(model, "use_grid_kernel"):
                # as nerf_tpu's vmapped step: the grid families' module path
                model.use_grid_kernel = False
    start_step = 0
    ckpt_name = f"{cfg.model_type}_multiscene"
    if resume_path is not None:
        meta = read_metadata(resume_path)
        if int(meta.get("num_scenes", num_scenes)) != num_scenes:
            raise ValueError(f"checkpoint trained {meta['num_scenes']} scenes, "
                             f"got {num_scenes} dataset paths")
        ckpt = load_checkpoint(resume_path)
        for i, st in zip(mine, states):
            restore_scene(st, ckpt, i)
        del ckpt
        start_step = int(meta["step"])
        log(f"Resuming multi-scene training from iteration {start_step}")

    step_fns: dict = {}

    def get_step_fn(c: int):
        if c not in step_fns:
            step_fns[c] = make_multiscene_train_step(
                models, settings, cfg.num_random_rays, cfg.seed, mesh, num_steps=c,
                use_pallas=cfg.use_pallas, regularizer=make_regularizer(cfg, models[0]))
        return step_fns[c]

    max_chunk = cfg.steps_per_call
    if max_chunk <= 0:
        max_chunk = min(math.gcd(math.gcd(cfg.log_interval, cfg.val_interval),
                                 cfg.save_interval), 100)

    def next_event(i: int) -> int:
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

    schedule = lr_schedule(cfg.learning_rate, cfg.lr_decay, cfg.lr_decay_factor,
                           cfg.lr_min)
    meta_extra = {"num_scenes": num_scenes, "scenes": [s.name for s in scenes],
                  "base_model_type": cfg.model_type}
    val_group = mesh.group("data") if mesh.size("data") > 1 else None
    # the train step's routes: KiloNeRF through its module, as in nerf_tpu
    val_render = make_eval_render(
        models[0], settings, fused=cfg.use_pallas and not isinstance(models[0], KiloNeRFModel),
        group=val_group)
    if primary:
        os.makedirs(cfg.save_path, exist_ok=True)
    saver = AsyncCheckpointSaver()
    logger = MetricLogger(log_dir=cfg.log_dir if primary else None,
                          model_type=f"{cfg.model_type}_x{num_scenes}",
                          dataset_name="multiscene", config_text=str(cfg),
                          enable_tensorboard=enable_tensorboard, echo=log)
    # every rank gathers the validation images for the primary's events; the
    # argument, not the rank's own log_dir, decides, so all ranks join
    log_images = enable_tensorboard
    max_hw = tuple(max(s.hw[k] for s in scenes) for k in (0, 1))

    def run_validation(step: int) -> None:
        psnrs = torch.zeros(len(mine), dtype=torch.float64, device=dev)
        preds = (torch.zeros((len(mine), *max_hw, 3), dtype=torch.float32, device=dev)
                 if log_images else None)
        for i, s in enumerate(scenes):
            idx = np.random.randint(s.val_images.shape[0])    # every rank, every scene
            if i not in mine:
                continue
            img = s.val_images[idx]
            c2w = np.eye(4, dtype=np.float32)
            c2w[: s.val_c2w.shape[1]] = s.val_c2w[idx]
            ro, rd, _ = compute_rays(img[None], c2w[None], s.focal)
            ro, rd = torch.from_numpy(ro[0]), torch.from_numpy(rd[0])
            viewdirs = None
            if s.ndc:
                viewdirs = rd.to(dev)
                ro, rd = ndc_rays(*s.hw, s.focal, 1.0, ro, rd)
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed(scene_seed(cfg.seed, i), step, VALIDATE))
            st = states[mine.index(i)]
            out = val_render(st.params, st.fine_params, ro.to(dev), rd.to(dev), gen,
                             viewdirs=viewdirs, hw=s.hw)
            pred = out.rgb.reshape(*s.hw, 3)
            if preds is not None:
                preds[mine.index(i), : s.hw[0], : s.hw[1]] = pred.float()
            pred = pred.cpu().numpy()
            psnrs[mine.index(i)] = float(mse_to_psnr(float(np.mean((pred - img) ** 2))))
        psnrs = gather_scene_values(psnrs, num_scenes, mesh).cpu().numpy()
        if preds is not None:
            preds = gather_scene_values(preds, num_scenes, mesh).cpu().numpy()
        for i, p in enumerate(psnrs):
            logger.log_scalar(f"scene{i}/val_psnr", float(p), step)
            if preds is not None:
                h, w = scenes[i].hw
                logger.log_image(f"scene{i}/val_render", preds[i, :h, :w], step)
        logger.log_scalar("val/psnr", float(np.mean(psnrs)), step)
        log(f"[Validation Step] Iter {step}  PSNR: {float(np.mean(psnrs)):.2f} "
            f"(scenes {', '.join(f'{p:.2f}' for p in psnrs)})")

    def save(step: int, interval: bool) -> Optional[str]:
        payload = _gather_payload(states, mine, mesh, ckpt_name, step, num_scenes)
        path = None
        if primary:
            path = (saver.save_payload(payload, cfg.save_path, ckpt_name, step, meta_extra)
                    if interval else
                    save_payload(payload, cfg.save_path, ckpt_name, step, meta_extra))
        barrier()
        return path

    start_time = datetime.datetime.now()
    throughput = Throughput(warmup=2)
    step = start_step
    try:
        pos = start_step
        while pos < num_iters:
            boundary = min(next_event(pos) + 1, num_iters)
            c = min(max_chunk, boundary - pos)
            metrics = get_step_fn(c)(states, pools)
            step = pos + c - 1
            throughput.update(c * cfg.num_random_rays * num_scenes)
            if c > 1:          # (c, S): the chunk's last step
                metrics = {k: v[-1] for k, v in metrics.items()}
            if step % cfg.log_interval == 0:
                mses = gather_scene_values(metrics["mse"].double(), num_scenes,
                                           mesh).cpu().numpy()
                logger.log_train(step, schedule(step), float(mses.mean()))
                logger.log_scalar("rays_per_sec", throughput.rays_per_sec, step)
                for i, v in enumerate(mses):
                    logger.log_scalar(f"scene{i}/mse", float(v), step)
            if step % cfg.save_interval == 0 and 0 < step < num_iters - 1:
                with throughput.exclude():
                    path = save(step, interval=True)
                log(f"[{format_elapsed_time(start_time)}] Model saved to {path} "
                    f"at iteration {step}")
            if step % cfg.val_interval == 0 and (step > 0 or cfg.first_step_render):
                with throughput.exclude():
                    run_validation(step)
            pos += c
        saver.wait()
        final = save(num_iters, interval=False)
        elapsed = format_elapsed_time(start_time)
        log(f"[{elapsed}] Multi-scene training complete!")
        log(f"[{elapsed}] Final model saved to {final}")
    except KeyboardInterrupt:
        elapsed = format_elapsed_time(start_time)
        log(f"\n[{elapsed}] Keyboard interrupt! Saving current checkpoint...")
        saver.wait()
        path = save(step, interval=False)
        log(f"[{elapsed}] Checkpoint saved to {path}. Exiting training.")
    finally:
        saver.wait()
        logger.close()
    return states
