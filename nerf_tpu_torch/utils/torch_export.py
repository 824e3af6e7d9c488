"""Export port checkpoints to the reference's ``.pth`` format, as
``nerf_tpu.utils.torch_export`` (the inverse of ``utils/torch_import.py``):

    python -m nerf_tpu_torch.utils.torch_export --config cfg.txt \\
        --checkpoint ./models/nerf_model_300000 --out nerf_model_300000.pth [--fine]

The file carries the reference's five keys (``step``, ``model_type``,
``model_state_dict``, ``optimizer_state_dict``, ``scheduler_state_dict``)
and loads through the reference's eval (``torch.load(...,
weights_only=True)`` and ``load_state_dict``) and its resume. The optimizer
state is a real ``torch.optim.Adam``'s over placeholder parameters, so
``param_groups`` holds every key that ``load_state_dict`` and ``step()``
need; its per-parameter ``exp_avg`` / ``exp_avg_sq`` are the port Adam's
``mu`` / ``nu`` (the same raw moments) in the reference's registration
order, weights then biases layer by layer, which is the port modules'
``parameters()`` order. The scheduler state continues the reference's
LambdaLR at ``step``. Only nerf and siren travel; ``--fine`` exports the
fine model (the reference is coarse-only).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

# a SIREN's heads: port state-dict prefix -> reference prefix (its base
# layers map base.{i} <-> block1.{i}.layer; the NeRF keeps its keys)
SIREN_HEADS = {"sigma": "density_branch.0", "remap": "feature_remap.0",
               "rgb0": "rgb_head.0.layer", "rgb1": "rgb_head.1"}


def _nerf_key(key: str) -> str:
    return key


def _siren_key(key: str) -> str:
    prefix, _, leaf = key.rpartition(".")
    if prefix.startswith("base."):
        return f"block1.{prefix.split('.')[1]}.layer.{leaf}"
    return f"{SIREN_HEADS[prefix]}.{leaf}"


_ENTRY_MAPS = {"nerf": _nerf_key, "siren": _siren_key}


def _check_family(model_type: str) -> str:
    model_type = model_type.lower()
    if model_type not in _ENTRY_MAPS:
        raise ValueError(
            f"cannot export model_type '{model_type}' to a reference "
            f".pth (reference families: {sorted(_ENTRY_MAPS)})")
    return model_type


def state_dict_from_params(model_type: str, module) -> dict:
    """A port module -> the reference-keyed state dict (CPU float32, in the
    reference's registration order)."""
    rename = _ENTRY_MAPS[_check_family(model_type)]
    return {rename(k): v.detach().to("cpu", torch.float32, copy=True)
            for k, v in module.state_dict().items()}


def _adam_state_dict(module, step: int, cfg, mu=None, nu=None) -> dict:
    """A ``torch.optim.Adam(model.parameters(), lr=learning_rate)`` state
    dict, its moments ``mu`` / ``nu`` (in ``module.parameters()`` order)
    when given."""
    params = list(module.parameters())
    dummies = [torch.nn.Parameter(torch.zeros(1)) for _ in params]
    sd = torch.optim.Adam(dummies, lr=float(cfg.learning_rate)).state_dict()
    if mu is not None:
        sd["state"] = {i: {"step": torch.tensor(float(step)),
                           "exp_avg": m.detach().to("cpu", torch.float32, copy=True),
                           "exp_avg_sq": n.detach().to("cpu", torch.float32, copy=True)}
                       for i, (m, n) in enumerate(zip(mu, nu))}
    return sd


def _scheduler_state_dict(step: int, cfg) -> dict:
    """A ``LambdaLR.state_dict()`` continuing the reference's schedule at
    ``step`` (built from a real LambdaLR, so the keys are what
    ``load_state_dict`` expects; the lambda itself does not travel)."""
    gamma = float(cfg.lr_decay_factor) ** (1.0 / (float(cfg.lr_decay) * 1000.0))
    floor = float(cfg.lr_min) / float(cfg.learning_rate)
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=float(cfg.learning_rate))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=lambda s: max(gamma ** s, floor))
    sd = sched.state_dict()
    sd["last_epoch"] = int(step)
    sd["_step_count"] = int(step) + 1
    sd["_last_lr"] = [float(cfg.learning_rate) * max(gamma ** step, floor)]
    return sd


def export_torch_checkpoint(ckpt_path: str, cfg, out_path: str,
                            use_fine: bool = False) -> str:
    """Convert a port training checkpoint into a reference ``.pth`` at
    ``out_path`` (returns it). ``cfg`` describes the architecture; the
    checkpoint's ``model_type`` wins and the state's step is written.
    ``use_fine`` exports the fine model and its slice of the moments (the
    port's Adam runs over the coarse, then the fine parameters); it raises
    when the checkpoint has no fine model."""
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import read_metadata, restore_train_state

    meta = read_metadata(ckpt_path)
    model_type = _check_family(str(meta.get("model_type", cfg.model_type)))
    cfg = dataclasses.replace(cfg, model_type=model_type)
    state = create_train_state(cfg, device="cpu")
    if use_fine and state.fine_params is None:
        raise ValueError("checkpoint has no fine network to export")
    restore_train_state(state, ckpt_path)
    module = state.fine_params if use_fine else state.params
    n = len(list(state.params.parameters()))
    opt = state.optimizer
    mu, nu = (opt.mu[n:], opt.nu[n:]) if use_fine else (opt.mu[:n], opt.nu[:n])
    ckpt = {
        "step": int(state.step),
        "model_type": model_type,
        "model_state_dict": state_dict_from_params(model_type, module),
        "optimizer_state_dict": _adam_state_dict(module, state.step, cfg, mu, nu),
        "scheduler_state_dict": _scheduler_state_dict(state.step, cfg),
    }
    torch.save(ckpt, out_path)
    return out_path


def main(argv=None) -> None:
    """``python -m nerf_tpu_torch.utils.torch_export --config cfg.txt
    --checkpoint CKPT --out model.pth [--fine]``"""
    from nerf_tpu_torch.config import parse_config_file

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True, help="port checkpoint")
    parser.add_argument("--out", required=True, help=".pth output path")
    parser.add_argument("--fine", action="store_true",
                        help="export the fine network instead of the coarse")
    args = parser.parse_args(argv)
    cfg = parse_config_file(args.config)
    path = export_torch_checkpoint(args.checkpoint, cfg, args.out, use_fine=args.fine)
    print(f"Exported {args.checkpoint} -> {path}")
    print("Load it with the reference's own tooling: "
          f"python eval.py --config <ref config> --checkpoint {path}")


if __name__ == "__main__":
    main()
