"""Training CLI, as ``nerf_tpu.cli.train_cli``:

    python -m nerf_tpu_torch.cli.train_cli --config cfg.txt [--resume CKPT]
        [--max-steps N] [--device cuda|cpu]

Reads unmodified reference config files. On resume the checkpoint's
``model_type`` overrides the config. ``--device`` defaults to ``cuda`` and
raises without a card; ``cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse

from nerf_tpu_torch.config import parse_config_file
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.utils.checkpoint import read_metadata


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train NeRF on a given dataset using volumetric rendering.")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to configuration file")
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to a checkpoint to resume from")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="Override num_iters (smoke tests)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card raises")
    args = parser.parse_args(argv)

    cfg = parse_config_file(args.config)
    if args.resume is not None:
        meta = read_metadata(args.resume)
        cfg.model_type = meta.get("model_type", cfg.model_type).lower()
        print(f"Resuming training with model type from checkpoint: {cfg.model_type}")
    fit(cfg, resume_path=args.resume, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
