"""One rank of the port's two-rank gloo runs (``tests/test_torch_port_parallel.
py`` spawns two): ``fit`` on ``mesh_shape = "data:2"``, a validation image
split over the ranks, and ``fit_multiscene`` on ``scene:2,data:1`` and
``scene:1,data:2``. Rank r writes under ``{root}/rank{r}`` (so the test sees
that only rank 0 writes) and its results to ``{root}/rank{r}.pt``. Imports
torch and the port only."""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from nerf_tpu_torch.config import Config


def fit_config(root: str, tag: str, **kw) -> Config:
    """The small config of the parallel tests' ``fit`` runs (perturbed
    samples, 8 + 8, three tiles of 100 rays a 16 x 16 image)."""
    base = dict(dataset_path=os.path.join(root, "scene_a"), num_random_rays=64,
                num_samples=8, num_fine_samples=8, hidden_dim=32, learning_rate=5e-3,
                num_iters=3, log_interval=1, val_interval=2, save_interval=2,
                chunk_size=100, save_path=os.path.join(root, tag, "models"),
                log_dir=os.path.join(root, tag, "logs"))
    base.update(kw)
    return Config(**base)


def scenes(root: str) -> list:
    return [os.path.join(root, s) for s in ("scene_a", "scene_b")]


def val_rays(root: str):
    """The rays of scene_a's validation view, and a generator seed."""
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.data.rays import compute_rays

    scene = load_scene(fit_config(root, "x"))
    o, d, _ = compute_rays(scene.val_images[:1], scene.val_c2w[:1], scene.focal)
    return torch.from_numpy(o[0]), torch.from_numpy(d[0])


def val_image(state, cfg: Config, rays, group=None) -> torch.Tensor:
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import make_eval_render

    render = make_eval_render(state.params, render_settings_from_config(cfg), group=group)
    gen = torch.Generator().manual_seed(5)
    return render(state.params, state.fine_params, *rays, gen).rgb


def dp_config() -> Config:
    """The explicit data-parallel step's small config (samples at the
    bins' midpoints: a rank's draws do not enter its gradient)."""
    return Config(hidden_dim=32, num_samples=8, num_fine_samples=8, perturb=False,
                  learning_rate=5e-3)


def dp_pool(root: str):
    from nerf_tpu_torch.data.pipeline import load_scene

    return load_scene(fit_config(root, "x")).pool


def dp_steps(root: str, rank: int, steps: int = 2) -> dict:
    """Two steps of ``make_dp_train_step`` (batch 64 over data:2, each
    rank 32 rays from its shard): this rank's metrics and final
    parameters."""
    from nerf_tpu_torch.parallel.dp import make_dp_train_step
    from nerf_tpu_torch.parallel.mesh import create_mesh, shard_pool
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.state import create_train_state

    cfg = dp_config()
    mesh = create_mesh("data:2")
    state = create_train_state(cfg, device="cpu")
    step = make_dp_train_step(state.params, render_settings_from_config(cfg), 64, cfg.seed,
                              mesh)
    pool = shard_pool(dp_pool(root), mesh)
    ms = [step(state, pool) for _ in range(steps)]
    return {"loss": torch.stack([m["loss"] for m in ms]),
            "params": {k: v.clone() for k, v in state.params.state_dict().items()}}


def run(rank: int, root: str, port: int) -> None:
    from nerf_tpu_torch.parallel.multihost import init_distributed
    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.train.multiscene_loop import fit_multiscene

    torch.set_num_threads(1)
    init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo",
                     device="cpu")
    tag = f"rank{rank}"
    quiet = lambda *a: None  # noqa: E731
    out = {}
    cfg = fit_config(root, tag, mesh_shape="data:2")
    state = fit(cfg, device="cpu", log=quiet)
    out["params"] = {k: v.clone() for k, v in state.params.state_dict().items()}
    out["fine_params"] = {k: v.clone() for k, v in state.fine_params.state_dict().items()}
    out["val"] = val_image(state, cfg, val_rays(root), group=dist.group.WORLD)
    out["dp"] = dp_steps(root, rank)
    for spec in ("scene:2,data:1", "scene:1,data:2"):
        name = spec.replace(":", "").replace(",", "_")
        ms = dataclasses.replace(fit_config(root, os.path.join(tag, name)), mesh_shape=spec,
                                 num_iters=4)
        fit_multiscene(ms, scenes(root), device="cpu", log=quiet)
    torch.save(out, os.path.join(root, f"{tag}.pt"))
    dist.barrier()
    dist.destroy_process_group()
