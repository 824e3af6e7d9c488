"""Import the reference's PyTorch checkpoints, as
``nerf_tpu.utils.torch_import``.

The reference (``josedelrey/nerf-pytorch``) saves ``{step, model_type,
model_state_dict, ...}`` to ``{model_type}_model_{step:06d}.pth``. This
module maps its state dict onto the port's modules and writes a port
checkpoint (``utils/checkpoint.py``) that ``fit(resume_path=...)``, serving
and the eval CLI take:

    python -m nerf_tpu_torch.utils.torch_import --config cfg.txt \\
        --checkpoint nerf_model_300000.pth --out ./models

Both keep ``nn.Linear``'s (out, in) layout, so nothing transposes. The
NeRF map is the identity (the port's NeRF has the reference's layout);
the SIREN map renames ``block1.{i}.layer``, ``density_branch.0``,
``feature_remap.0``, ``rgb_head.0.layer`` and ``rgb_head.1`` to ``base.{i}``,
``sigma``, ``remap``, ``rgb0`` and ``rgb1``. Only those two families exist
in the reference. The Adam moments are not carried (a fresh Adam), but the
``.pth``'s step becomes the state's step and Adam's count, so a resumed
run continues the learning-rate law and the step-keyed draws from there.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from nerf_tpu_torch.utils.torch_export import SIREN_HEADS


def _nerf_keys(sd: dict) -> dict:
    return {k: k for k in sd}


def _siren_keys(sd: dict) -> dict:
    """Reference ``Siren`` key -> port ``SirenModel`` key (the inverse of
    ``torch_export``'s map)."""
    heads = {ref: port for port, ref in SIREN_HEADS.items()}
    out = {}
    for key in sd:
        prefix, _, leaf = key.rpartition(".")
        if prefix.startswith("block1.") and prefix.endswith(".layer"):
            name = "base." + prefix.split(".")[1]
        else:
            name = heads.get(prefix, prefix)
        out[key] = f"{name}.{leaf}"
    return out


_CONVERTERS = {"nerf": _nerf_keys, "siren": _siren_keys}


def params_from_state_dict(model_type: str, sd: dict) -> dict:
    """A reference state dict -> the port module's ``state_dict`` (float32
    tensors). Raises ``ValueError`` for a family the reference does not
    have."""
    model_type = model_type.lower()
    if model_type not in _CONVERTERS:
        raise ValueError(
            f"cannot import model_type '{model_type}' from a torch "
            f"checkpoint (reference families: {sorted(_CONVERTERS)})")
    keys = _CONVERTERS[model_type](sd)
    return {keys[k]: torch.as_tensor(v, dtype=torch.float32).clone() for k, v in sd.items()}


def _shapes(sd: dict) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


def import_torch_checkpoint(pth_path: str, cfg, save_path: str) -> str:
    """Convert a reference ``.pth`` into a port checkpoint under
    ``save_path`` (returns its path). ``cfg`` describes the architecture the
    reference run used; the checkpoint's ``model_type`` and ``step`` win. A
    layer whose shape the config does not give raises ``ValueError`` with
    both layouts. The fine model (a hierarchical config) starts as a copy of
    the coarse one, as the reference has none."""
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import save_train_state

    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    model_type = str(ckpt.get("model_type", cfg.model_type)).lower()
    step = int(ckpt.get("step", 0))
    params = params_from_state_dict(model_type, ckpt["model_state_dict"])
    cfg = dataclasses.replace(cfg, model_type=model_type)
    state = create_train_state(cfg, device="cpu")
    ref, got = _shapes(state.params.state_dict()), _shapes(params)
    if ref != got:
        raise ValueError(
            "imported parameters do not match the configured architecture:\n"
            f"  config expects: {ref}\n  checkpoint has: {got}")
    for model in state.models():
        model.load_state_dict(params)
    # continue the run where torch left it: the step drives the draws, and
    # Adam's count the learning-rate law
    state.step = step
    state.optimizer.count = step
    return save_train_state(state, save_path, model_type, step)


def main(argv=None) -> None:
    """``python -m nerf_tpu_torch.utils.torch_import --config cfg.txt
    --checkpoint model.pth [--out ./models]``"""
    from nerf_tpu_torch.config import parse_config_file

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True, help=".pth file")
    parser.add_argument("--out", default="./models")
    args = parser.parse_args(argv)
    cfg = parse_config_file(args.config)
    os.makedirs(args.out, exist_ok=True)
    path = import_torch_checkpoint(args.checkpoint, cfg, args.out)
    print(f"Imported {args.checkpoint} -> {path}")
    print("Use it like any port checkpoint: python -m nerf_tpu_torch.cli.eval_cli "
          f"--config {args.config} --checkpoint {path}")


if __name__ == "__main__":
    main()
