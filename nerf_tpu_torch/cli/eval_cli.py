"""Evaluation CLI, as ``nerf_tpu.cli.eval_cli``: novel-view rendering to PNG
frames.

    python -m nerf_tpu_torch.cli.eval_cli --config cfg.txt --checkpoint CKPT
        [--output DIR] [--video orbit.gif] [--fps 20] [--bake RES]
        [--metrics] [--occupancy RES] [--device cuda|cpu]

Renders a spherical orbit of ``num_render_poses`` cameras (theta sweep at
phi = -30 deg, radius 4) with the trained field and writes
``frame_{i:04d}.png``; the test split's first frame gives H, W and focal.
An LLFF scene renders the first ``num_render_poses`` poses of its spiral
instead (through NDC rays with ``ndc``). With ``--metrics`` it renders the
test split (an LLFF scene's every 8th view) instead and writes
``pred_{i:03d}.png`` and ``metrics.json`` (per-view and mean PSNR / SSIM).
The checkpoint's ``model_type`` and ``grid_res`` override the config. The
models, the occupancy prior (``--occupancy``) and the baked cache
(``--bake``) are built by ``serve.RenderService.from_checkpoint``, so a
frame is the image the service gives for the same pose and key. ``--video``
writes a looping GIF (``utils/gif.py``; another extension writes the
``.gif`` beside it). ``--device`` defaults to ``cuda`` and raises without a
card; ``cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nerf_tpu_torch.data.blender import load_blender
from nerf_tpu_torch.data.llff import load_llff
from nerf_tpu_torch.data.poses import spherical_orbit
from nerf_tpu_torch.serve import RenderService, checkpoint_config
from nerf_tpu_torch.utils.gif import write_gif
from nerf_tpu_torch.utils.metrics import mse_to_psnr, ssim
from nerf_tpu_torch.utils.png import write_png


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (img * 255).astype(np.uint8)


def _score_test_split(svc: RenderService, cfg, output: str, log) -> None:
    """Render the test split with its own cameras and score each view
    against its ground truth: pred_*.png and metrics.json in ``output``."""
    if cfg.dataset_type == "llff":
        data = load_llff(cfg.dataset_path, factor=cfg.llff_factor)
        images, poses = data["images"][data["i_test"]], data["poses"][data["i_test"]]
    else:
        images, poses, _ = load_blender(cfg.dataset_path, mode="test",
                                        white_background=cfg.white_background,
                                        half_res=cfg.half_res)
    rows = []
    for i in range(images.shape[0]):
        t0 = time.perf_counter()
        pred = svc.render_pose(poses[i], key_idx=i)
        gt = np.asarray(images[i], np.float32)
        mse = float(np.mean((pred - gt) ** 2))
        rows.append({"view": i, "mse": mse, "psnr": float(mse_to_psnr(mse)),
                     "ssim": ssim(pred, gt)})
        path = os.path.join(output, f"pred_{i:03d}.png")
        write_png(path, _to_u8(pred))
        log(f"view {i + 1}/{images.shape[0]}: {path} PSNR {rows[-1]['psnr']:.2f} "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    summary = {
        "num_views": len(rows),
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "mean_ssim": float(np.mean([r["ssim"] for r in rows])),
        "views": rows,
    }
    with open(os.path.join(output, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"Test split ({summary['num_views']} views): PSNR {summary['mean_psnr']:.2f}  "
        f"SSIM {summary['mean_ssim']:.4f}")
    log(f"Wrote {os.path.join(output, 'metrics.json')}")


def main(argv=None, log=print) -> None:
    parser = argparse.ArgumentParser(
        description="Render novel views from a trained NeRF checkpoint.")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--output", type=str, default="rendered_frames")
    parser.add_argument("--video", type=str, default="",
                        help="also write the orbit as a looping GIF at this path (a "
                             "path with another extension gets the .gif beside it)")
    parser.add_argument("--fps", type=int, default=20, help="frame rate for --video")
    parser.add_argument("--bake", type=int, default=0, metavar="GRID_RES",
                        help="bake the field into an MLP-free cache at this grid "
                             "resolution before rendering (fastnerf / plenoctree only)")
    parser.add_argument("--metrics", action="store_true",
                        help="render the dataset's TEST split instead of the orbit and "
                             "report per-view + mean PSNR/SSIM (writes metrics.json and "
                             "pred_*.png to --output)")
    parser.add_argument("--occupancy", type=int, default=0, metavar="GRID_RES",
                        help="bake a binary occupancy prior at this resolution and draw "
                             "the coarse samples from it")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card raises")
    args = parser.parse_args(argv)

    cfg = checkpoint_config(args.config, args.checkpoint)
    os.makedirs(args.output, exist_ok=True)
    log("===== Evaluation Configuration Summary =====")
    log(f"Dataset path: {cfg.dataset_path}")
    log(f"Model type: {cfg.model_type}")
    log(f"Checkpoint: {args.checkpoint}")
    log(f"Output directory: {args.output}")
    log(f"Near/far: {cfg.near}/{cfg.far}  samples: {cfg.num_samples}")
    log(f"Number of render poses: {cfg.num_render_poses}")
    log("=============================================")

    try:
        svc = RenderService.from_checkpoint(cfg, args.checkpoint, bake=args.bake,
                                            occupancy=args.occupancy, device=args.device,
                                            log=log)
    except ValueError as e:
        if not str(e).startswith("bake:"):
            raise
        raise SystemExit(f"--{e}")

    if args.metrics:
        _score_test_split(svc, cfg, args.output, log)
        return

    if svc.render_poses is not None:
        poses = svc.render_poses[: cfg.num_render_poses]
    else:
        poses = spherical_orbit(cfg.num_render_poses)
    frames = []
    for i in range(poses.shape[0]):
        t0 = time.perf_counter()
        frame = _to_u8(svc.render_pose(poses[i], key_idx=i))
        path = os.path.join(args.output, f"frame_{i:04d}.png")
        write_png(path, frame)
        log(f"frame {i + 1}/{poses.shape[0]}: {path} "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
        if args.video:
            frames.append(frame)

    if args.video:
        gif = args.video
        if os.path.splitext(gif)[1].lower() != ".gif":
            gif = os.path.splitext(gif)[0] + ".gif"
            log(f"no encoder for {args.video} here (GIF only); writing {gif} instead")
        write_gif(gif, frames, fps=args.fps)
        log(f"Wrote {gif} ({len(frames)} frames @ {args.fps} fps)")


if __name__ == "__main__":
    main()
