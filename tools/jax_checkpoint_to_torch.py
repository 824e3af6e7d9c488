#!/usr/bin/env python
"""Convert a nerf_tpu (Orbax) checkpoint into a checkpoint of the PyTorch
port (nerf_tpu_torch), so a run trained with JAX continues on a GPU:

    python tools/jax_checkpoint_to_torch.py --config cfg.txt \
        --checkpoint ./models/nerf_model_003000 --out ./torch_models

Run it where JAX and Orbax are installed (the GPU machine needs neither).
It restores the train state with ``nerf_tpu.utils.checkpoint`` and writes
the port's (``torch.save`` plus ``.meta.json``) under the same name: the
weights through ``load_jax_params``, Adam's count and moments through
``load_jax_opt_state``, the state's step counter and the checkpoint's
iteration as they were. The port's ``fit(resume_path=...)``, serving and
eval CLI read the result. The config must describe the trained
architecture; the checkpoint's ``model_type`` and ``grid_res`` win.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(config: str, checkpoint: str, out: str) -> str:
    """The port checkpoint written under ``out`` (returns its path)."""
    import jax
    import numpy as np

    from nerf_tpu.config import parse_config_file as jax_parse_config_file
    from nerf_tpu.train.state import create_train_state as jax_create_train_state
    from nerf_tpu.utils.checkpoint import load_checkpoint, read_metadata

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.convert import load_jax_opt_state, load_jax_params
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import save_train_state

    meta = read_metadata(checkpoint)
    over = dict(model_type=str(meta.get("model_type")).lower())
    if "grid_res" in meta:
        over["grid_res"] = int(meta["grid_res"])
    jcfg = dataclasses.replace(jax_parse_config_file(config), **over)
    _, _, template = jax_create_train_state(jcfg, jax.random.key(jcfg.seed))
    jstate = jax.tree.map(np.asarray, load_checkpoint(checkpoint, template))

    cfg = dataclasses.replace(parse_config_file(config), **over)
    state = create_train_state(cfg, device="cpu")
    load_jax_params(state.params, jstate.params)
    if state.fine_params is not None:
        load_jax_params(state.fine_params, jstate.fine_params)
    load_jax_opt_state(state.optimizer, jstate.opt_state)
    state.step = int(jstate.step)
    return save_train_state(state, out, over["model_type"], int(meta["step"]))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True, help="nerf_tpu checkpoint directory")
    parser.add_argument("--out", default="./torch_models")
    args = parser.parse_args(argv)

    from nerf_tpu.utils.platform import apply_platform_env

    apply_platform_env()
    path = convert(args.config, args.checkpoint, args.out)
    print(f"Converted {args.checkpoint} -> {path}")
    print("Resume it on the GPU: python -m nerf_tpu_torch.cli.train_cli "
          f"--config {args.config} --resume {path}")


if __name__ == "__main__":
    main()
