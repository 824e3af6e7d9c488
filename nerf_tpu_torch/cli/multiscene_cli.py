"""Multi-scene training CLI, as ``nerf_tpu.cli.multiscene_cli``:

    python -m nerf_tpu_torch.cli.multiscene_cli --config base.txt \
        --scenes ./datasets/lego ./datasets/chair ./datasets/drums ./datasets/ship
        [--resume CKPT] [--max-steps N] [--device cuda|cpu]

Trains one model per scene together (``train/multiscene_loop.py``; over
several ranks under ``torchrun`` with ``multihost = true``). ``--device``
defaults to ``cuda`` and raises without a card; ``cpu`` runs the kernels'
plain versions.
"""

from __future__ import annotations

import argparse

from nerf_tpu_torch.config import parse_config_file
from nerf_tpu_torch.train.multiscene_loop import fit_multiscene


def main(argv=None, log=print) -> None:
    parser = argparse.ArgumentParser(
        description="Train NeRF on several scenes concurrently.")
    parser.add_argument("--config", type=str, required=True,
                        help="Shared config (schedule/model)")
    parser.add_argument("--scenes", type=str, nargs="+", required=True,
                        help="Dataset paths, one per scene")
    parser.add_argument("--resume", type=str, default=None,
                        help="Stacked multi-scene checkpoint to resume from")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card raises")
    args = parser.parse_args(argv)
    cfg = parse_config_file(args.config)
    fit_multiscene(cfg, args.scenes, resume_path=args.resume, max_steps=args.max_steps,
                   device=args.device, log=log)


if __name__ == "__main__":
    main()
