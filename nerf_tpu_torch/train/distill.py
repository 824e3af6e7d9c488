"""Teacher distillation, the KiloNeRF paper's training procedure.

Counterpart of ``nerf_tpu.train.distill``. A pretrained teacher field
supervises the student field directly before photometric training: points
uniform over the scene volume (``registry.py::grid_domain``, the model's
input space) and directions normal then normalised, the student regressing
the teacher's (rgb, sigma) with loss ``mean((s_rgb - t_rgb)^2) +
mean((s_sigma - t_sigma)^2)`` (both post-activation, as the JAX package
matches them), the teacher under ``torch.no_grad()``, one Adam over
(params, fine_params) (the fine model gets no gradient). ``fit()`` runs it
on fresh runs only and then starts the photometric loop at step 0 with
fresh Adam moments.

Each step draws from a generator seeded by ``(seed, step, DISTILL)``
(``train/step.py::step_seed``); the JAX ``_DISTILL_SALT`` key stream has no
torch counterpart. Student and teacher are evaluated through the field
that ``train/step.py::fused_field_for`` picks: a KiloNeRF student through
its field kernels, a NeRF, SIREN or GaborNet teacher or student at hidden
256 on the card through its family's field kernels (``NerfField``,
``SirenField``, ``GaborField``: the teacher's forward, the student's
forward and backward; a teacher of one family distils into a student of
another), a hidden-32 NeRF through its module (as the JAX package runs
it); one that the JAX package would run through a field kernel at a shape
the port's do not cover raises on the card and names that kernel's row of
PERF.md's table. With ``debug_nans`` a non-finite loss or gradient
raises ``FloatingPointError`` naming the step.
"""

from __future__ import annotations

import dataclasses

import torch

from nerf_tpu_torch.train.state import TrainState
from nerf_tpu_torch.train.step import (
    DISTILL,
    check_finite,
    fused_field_for,
    packed_field,
    step_seed,
)


def distill_loss(student, teacher, pts: torch.Tensor, dirs: torch.Tensor):
    """``(loss, rgb_mse, sigma_mse)`` of the student field against the
    teacher field at ``pts`` / ``dirs``; the teacher runs without
    gradient."""
    with torch.no_grad():
        t_rgb, t_sigma = teacher(pts, dirs)
    s_rgb, s_sigma = student(pts, dirs)
    rgb_mse = torch.mean((s_rgb - t_rgb) ** 2)
    sigma_mse = torch.mean((s_sigma - t_sigma) ** 2)
    return rgb_mse + sigma_mse, rgb_mse, sigma_mse


def make_distill_step(student, teacher, batch_size: int, seed: int,
                      domain: tuple, num_steps: int, debug_nans: bool = False):
    """``step_n(state) -> metrics``: ``num_steps`` field-matching iterations
    updating ``state`` in place (its step counter too); ``student`` and
    ``teacher`` are fields ``(points, dirs) -> (rgb, sigma)``, the student
    bound to ``state.params``. ``metrics`` stacks ``loss``, ``rgb_mse`` and
    ``sigma_mse`` to ``(num_steps,)``."""
    lo, hi = float(domain[0]), float(domain[1])

    def one_step(state: TrainState) -> dict:
        dev = next(state.params.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(seed, state.step, DISTILL))
        pts = torch.rand((batch_size, 3), generator=gen, device=dev) * (hi - lo) + lo
        d = torch.randn((batch_size, 3), generator=gen, device=dev)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        for m in state.models():
            m.zero_grad(set_to_none=True)
        loss, rgb_mse, sigma_mse = distill_loss(student, teacher, pts, d)
        loss.backward()
        if debug_nans:
            check_finite(f"distillation step {state.step}", loss, state.models())
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "rgb_mse": rgb_mse.detach(),
                "sigma_mse": sigma_mse.detach()}

    def step_n(state: TrainState) -> dict:
        ms = [one_step(state) for _ in range(num_steps)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step_n


def load_teacher(cfg, ckpt_path: str, device: str | torch.device = "cuda"):
    """The teacher field of a checkpoint written by the port, built over the
    same config with the checkpoint's ``model_type`` and ``grid_res`` (its
    ``.meta.json``), on ``device``, frozen."""
    from nerf_tpu_torch.models.registry import model_from_config
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint, read_metadata
    from nerf_tpu_torch.utils.device import resolve_device

    meta = read_metadata(ckpt_path)
    tcfg = dataclasses.replace(
        cfg, model_type=meta.get("model_type", cfg.model_type).lower(),
        grid_res=int(meta.get("grid_res", cfg.grid_res)))
    teacher = model_from_config(tcfg)
    teacher.load_state_dict(load_checkpoint(ckpt_path)["params"])
    teacher = teacher.to(resolve_device(device)).eval().requires_grad_(False)
    return packed_field(fused_field_for(teacher)) if cfg.use_pallas else teacher


def run_distillation(cfg, state: TrainState, device: str | torch.device = "cuda",
                     log=print, log_scalar=None) -> TrainState:
    """Distill ``cfg.distill_from`` into ``state`` for ``cfg.distill_steps``
    steps in chunks of at most 100 (one log line each; with ``log_scalar``,
    ``(tag, value, step)``, also every step's loss as ``distill_loss``),
    then hand back a state for the photometric loop: the same models, step
    0 and a fresh Adam (the fine-tune is a new optimisation problem)."""
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.train.optim import make_optimizer

    teacher = load_teacher(cfg, cfg.distill_from, device)
    student = fused_field_for(state.params) if cfg.use_pallas else state.params
    domain = grid_domain(cfg)
    total = int(cfg.distill_steps)
    chunk = min(total, 100)
    step_fns: dict = {}
    done = 0
    while done < total:
        c = min(chunk, total - done)
        if c not in step_fns:
            step_fns[c] = make_distill_step(student, teacher, cfg.distill_batch,
                                            cfg.seed, domain, c, cfg.debug_nans)
        metrics = step_fns[c](state)
        if log_scalar is not None:
            for i, v in enumerate(metrics["loss"].tolist()):
                log_scalar("distill_loss", v, done + i)
        done += c
        log(f"[Distill] {done}/{total}  loss: {float(metrics['loss'][-1]):.6f}  "
            f"(rgb {float(metrics['rgb_mse'][-1]):.6f}, "
            f"sigma {float(metrics['sigma_mse'][-1]):.4f})")
    trainable = [p for m in state.models() for p in m.parameters()]
    return TrainState(step=0, params=state.params, fine_params=state.fine_params,
                      optimizer=make_optimizer(cfg, trainable))
