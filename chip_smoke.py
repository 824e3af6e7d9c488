#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero with no result:

  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. the build of every kernel library from the sources in the checkout
     (one nvcc per source, started together), timed;
  3. every kernel against its plain PyTorch version on the card (TF32 off):
     the forward render at the serving shapes (8192 rays x 64 and 192
     samples), the train pass and the render backward at the training
     shapes (1024 rays x 64, 192 and 256 samples), hidden 256, float32 and
     bfloat16: max errors against stated tolerances, the two backward
     routes against each other, median times in turns (plain, kernel,
     kernel, plain), the least time the card could take, and the share
     reached;
  4. serving: a synthetic 400x400 Blender scene, the configs/lego.txt model
     (full width, hierarchical 64+128, bfloat16) initialised from a seed and
     saved as a checkpoint, RenderService on cuda behind the HTTP server on
     loopback, four requests (/health, /pose/0, /pose/1, /render?m=...).
     Each image request must give a 400x400 PNG and launch the fused render
     kernel exactly 2 x ceil(160000/8192) = 40 times; one served image is
     held against the unfused PyTorch render of the same request;
  5. training: fit() on configs/lego.txt with the synthetic scene, 200
     iterations, logs every 10, validation and saves every 100: finite
     losses, the mse at iteration 190 under half of the one at 0, exactly
     2 x 200 train-kernel launches and 40 forward launches (the
     validation image), the interval and final checkpoints; then a resume
     from the step-100 checkpoint to 120 that restores step, parameters and
     Adam moments exactly and repeats the first run's mse bit for bit; then
     three steps through the render route (render_rays through the
     forward kernel, then its backward kernel under autograd); the train
     rate of the lego.txt step;
  6. bench.py's headline protocol (flat NeRF, bf16, 1024 rays x 256
     samples, white background, a 1<<20 synthetic pool on the card, warm-up,
     timed chained steps) in rays/s, and a torch.profiler trace of one
     lego.txt step: the train kernel's share of wall time, the other
     kernels, the device idle share;
  7. the SIREN kernels against their plain versions on the card (TF32
     off): the forward render at configs/lego_siren.txt's chunk and samples
     (1024 rays x 256), a ragged ray count (1000 x 256) and an odd S (1024 x
     37), the train pass and the render backward at 1024 x 256, float32 and
     bfloat16, timed in turns against their plain versions and their bound;
  8. serving configs/lego_siren.txt (SIREN, coarse-only 256 samples, chunk
     1024, bf16) as in 4: each image request must give a 400x400 PNG and
     launch the SIREN forward kernel exactly ceil(160000/1024) = 157 times,
     one image held against the unfused render;
  9. training configs/lego_siren.txt as in 5: 200 iterations, finite losses,
     the mse at 190 under that at 0 (the ratio is printed), exactly 200
     train-kernel launches and 157 forward launches (the validation image),
     a bit-identical resume from step 100 to 120, three render-route steps
     with 3 backward launches, the train rate of the lego_siren step and a
     profile of one step; then bench.py's train_siren protocol (flat SIREN,
     bf16, 1024 x 256, the 1<<20 pool, warm-up, 50 chained steps timed to a
     host fetch) in rays/s;
 10. the GaborNet kernels against their plain versions on the card (TF32
     off): the forward render at 1024 x 256, 1000 x 256 and 1024 x 37, the
     train pass at 1024 x 256 (loss, rgb, acc, weights, every weight
     gradient, the coefficient cotangents dA..dR, and the filter gradients
     after autograd through the prep), float32 and bfloat16, timed in turns
     against their plain versions and their bound;
 11. serving configs/lego_siren.txt with model_type = gabor (GaborNet, 8
     stages, hidden 256, coarse-only 256 samples, chunk 1024, bf16) as in 8:
     157 Gabor forward launches per request, one image held against the
     unfused render;
 12. training it as in 9 (200 train launches, 157 validation forward
     launches, the mse at 190 under that at 0, a bit-identical resume, a
     profile of one step); the forward render under autograd must raise
     NotImplementedError (the JAX render route has no VJP either); then
     bench.py's train_gabor protocol (flat GaborNet, bf16, 1024 x 256, as
     train_siren) in rays/s;
 13. the KiloNeRF field kernels (forward and backward) against their plain
     versions on the card (TF32 off), 512 networks of hidden 32 at L =
     10/4, float32 and bfloat16, on 1024 x 256 camera-ray samples
     normalised like the renderer's, 16,384 points uniform over the domain
     (the distillation batch), 5,000 points in one voxel and 37 points
     (empty networks: exactly zero gradients); both timed in turns at the
     camera set (runs of 20 launches per pair of events) against their
     bound;
 14. serving the kilonerf config (lego_siren.txt with model_type =
     kilonerf, hidden_dim = 32, grid_res = 8: coarse-only 256 samples,
     chunk 1024, bf16) as in 8: 157 forward launches per request, one
     image held against the unfused module render;
 15. training it with distillation: a teacher (the same config with
     model_type = nerf, use_pallas = false) for 100 steps, then fit() of
     kilonerf distilling it (100 steps of 16,384 points; the last loss under
     the first) and training 200 steps (the mse at 190 under that at 0),
     with the launches of both kernels counted, a bit-identical resume from
     step 100 (no distillation) and a profile of one step;
 16. bench.py's train_kilonerf protocol (bf16, 1024 x 256, the 1<<20 pool,
     16 warm-up steps, 40 timed chained steps) in rays/s.

The last lines are a JSON object of per-kernel numbers (all ten kernels),
the card, and ``{"ok": true, "device": {...}}``. Needs a CUDA device and this checkout;
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
R_CHECK = 8192          # rays per launch at serve (chunk_size of lego.txt)
HW = 400                # synthetic scene resolution
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# Kernel vs plain version, same inputs on the card. float32: the two sum
# the same products in another order (a 256-long f32 dot product drifts
# ~1e-7 relative per layer), so 1e-5 on values in [0, 1] and 1e-4 on depth
# (t up to 6). bfloat16: a sum that lands on the other side of a bf16
# rounding boundary changes one activation by 2^-8 relative and carries
# that through the later layers, so 1e-3 and 1e-2 on depth.
TOL = {"float32": {"rgb": 1e-5, "acc": 1e-5, "weights": 1e-5, "depth": 1e-4},
       "bfloat16": {"rgb": 1e-3, "acc": 1e-3, "weights": 1e-3, "depth": 1e-2}}
# A served 8-bit PNG against the unfused render of the same request: the
# PNG truncates to 1/255, and bfloat16 rounding points and the fast sine
# differ between the two paths, which also moves the fine samples a little.
SERVE_TOL_MEAN = 1e-2
R_TRAIN = 1024          # rays per train step (num_random_rays of lego.txt)
# Train pass / backward kernel vs plain version. Loss, rgb, acc, weights as
# the forward above (loss relative). Gradients, atol = tol * max|g| per
# tensor: float32 sums over ~2e5 points in another order, and the b10s and
# w10s gradients are sums of terms that cancel (measured 1.3e-3 of the
# max); bfloat16 rounds every dz to bf16 before each product, so one flipped
# rounding is carried through nine layers (measured 8e-3 of the max).
GRAD_TOL = {"float32": 5e-3, "bfloat16": 5e-2}
# per-sample MACs of the backward's skipped input-gradient products
# (dz1 w1^T, dz6 w6p^T, dzr0 wr0d^T at the real widths 63/63/27)
SKIPPED_MACS = 256 * 63 + 256 * 63 + 128 * 27
# SIREN at the real widths, per sample: forward MACs (3x256, 7 x 256x256,
# the 256 density row, 256x256, 283x128, 128x3), sines of the forward
# (8 x 256 + 128; the backward takes as many cosines), and the backward's
# skipped input products (dz1 w1^T, dzr0 wr0d^T)
SIREN_MACS = 3 * 256 + 7 * 256 * 256 + 256 + 256 * 256 + 283 * 128 + 128 * 3
SIREN_TRIG = 8 * 256 + 128
SIREN_SKIPPED = 256 * 3 + 128 * 27
R_SIREN, S_SIREN = 1024, 256   # lego_siren.txt: chunk_size, num_samples
# GaborNet at the real widths, per sample: forward MACs (7 x 256x256, the
# 256 density row, 256x256, 283x128, 128x3), transcendentals of the forward
# (a sine and an exponential per filter element, 8 x 256; the backward
# takes a sine and a cosine), and the backward's skipped input product
# (dzr0 wr0d^T). The kernels also read the per-ray coefficients (5 x 8 x
# 256 floats a ray; the train pass writes as many cotangents).
GABOR_MACS = 7 * 256 * 256 + 256 + 256 * 256 + 283 * 128 + 128 * 3
GABOR_TRIG = 2 * 8 * 256
GABOR_SKIPPED = 128 * 27
GABOR_COEF_BYTES = 5 * 8 * 256 * 4
# KiloNeRF at bench.py's shape (512 networks of hidden 32, L = 10/4), per
# point: forward MACs (63x32 + 32x32 + 32x33 + 59x32 + 32x3) and sines (the
# 84 encoding columns past the coordinates, one operation each on the CUDA
# cores); the backward recomputes the forward, takes the cotangent products
# (dz W^T, without dz1 W1^T and dzy Wr1d^T) and the gradient products
# (A^T dz). Bytes a point: its position and direction in (24) and its rgb
# and sigma out (16), or position, direction and the (rgb, sigma) cotangent
# in; the packed weights in (4 bytes a value in f32, 2 in bf16) and,
# backward, the float32 gradients out.
KILO_OVERRIDES = {"hidden_dim": 32, "grid_res": 8}   # lego_siren.txt -> kilonerf
KILO_MACS = 63 * 32 + 32 * 32 + 32 * 33 + 59 * 32 + 32 * 3
KILO_BWD_MACS = 3 * KILO_MACS - 63 * 32 - 27 * 32
KILO_TRIG = 60 + 24
KILO_R = 6212                    # packed floats per network
KILO_DOMAIN = (-2.75, -1.25)     # grid_domain of lego_siren.txt's settings
# Kernel vs plain version, same inputs on the card. Outputs (rgb, sigma):
# float32 sums of 32-63 products in another order, 1e-5 (as the NeRF
# kernels); bfloat16 roundings flip after such sums and move one activation
# by 2^-8 relative, 1e-3. Gradients, max abs over max |g| per tensor (the
# max floored at 1e-2 of the model's largest gradient): float32 sums over
# up to 262,144 points in another order, 1e-4; bfloat16 rounds every
# activation and cotangent before each gradient product, so one flipped
# rounding of a cotangent moves a network's sum by one term's 2^-8: 5e-4.
KILO_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
KILO_BATCH = 20        # launches per timed run of a KiloNeRF kernel
KILO_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-4}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3


def mlp_macs(h: int, real_p: int, real_d: int) -> int:
    """MACs per sample of the NeRF MLP at its real widths."""
    return (real_p * h + 4 * h * h + (h + real_p) * h + 3 * h * h
            + h * (h + 1) + (h + real_d) * (h // 2) + (h // 2) * 3)


def bound_ms(num_rays: int, s: int, cdt: str, weight_bytes: int, macs: int,
             trig: int = 0, grad_bytes: int | None = None,
             train: bool = False) -> tuple:
    """Least time of a forward render (``grad_bytes`` None) or of a train
    pass / render backward over num_rays x s samples: the products (``macs``
    per sample, 2 operations each) over the compute dtype's peak, and the
    sines and cosines (``trig`` per sample, one operation each) over the
    float32 CUDA-core rate; in float32 both share the CUDA cores (their
    sum), in bfloat16 the products have the tensor cores beside them (the
    larger). Against the bytes that must move: rays, t, weights, the
    target or cotangent and the gradients, and the outputs (rgb, acc,
    depth, compositing weights)."""
    n = num_rays * s
    nbytes = 3 * num_rays * 3 * 4 + n * 4 + weight_bytes
    if grad_bytes is None:
        nbytes += num_rays * 5 * 4 + n * 4
    else:
        nbytes += grad_bytes + num_rays * (3 if train else 8) * 4
        if train:
            nbytes += num_rays * 4 * 4 + n * 4
    t_mm = 2 * macs * n / PEAK_FLOPS[cdt] * 1e3
    t_trig = trig * n / PEAK_FLOPS["float32"] * 1e3
    t_ops = t_mm + t_trig if cdt == "float32" else max(t_mm, t_trig)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_calls(torch, fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def camera_batch(torch, dev, num_rays: int, s: int, seed: int) -> tuple:
    """(rays_o, rays_d, t, target): cameras on a radius-4 sphere looking
    at the scene, as an orbit, sorted t in [2, 6], random targets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.nn.functional.normalize(
        torch.randn(num_rays, 3, generator=g, device=dev), dim=-1) * 4.0
    look = torch.randn(num_rays, 3, generator=g, device=dev) * 0.3 - cam
    rays_d = torch.nn.functional.normalize(look, dim=-1)
    t = torch.sort(2.0 + 4.0 * torch.rand(num_rays, s, generator=g, device=dev),
                   dim=-1).values
    return cam, rays_d, t, torch.rand(num_rays, 3, generator=g, device=dev)


def check_kernel(torch, dev):
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_render import (
        FusedNerfRender, fused_render_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = NeRFModel(compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedNerfRender(model, 2.0, 6.0, normalize=True)
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        for s in (64, 192):
            rays_o, rays_d, t, _ = camera_batch(torch, dev, R_CHECK, s, 1000 + s)
            o_aff, d_aff = fr.affine(rays_o, rays_d)

            def plain():
                return fused_render_plain(packed, o_aff, d_aff, rays_d, t,
                                          model.pos_encoding_dim,
                                          model.dir_encoding_dim)

            def kern():
                return fr(packed, rays_o, rays_d, rays_d, t)

            with torch.no_grad():
                ref = plain()
                out = kern()
                torch.cuda.synchronize()
                errs = {}
                for i, k in enumerate(("rgb", "acc", "depth", "weights")):
                    x = out[k]
                    if not torch.isfinite(x).all():
                        fail(f"kernel {cdt} S={s}: non-finite {k}")
                    errs[k] = float((x - ref[i]).abs().max())
                del ref, out
                torch.cuda.empty_cache()
                times = {"plain": [], "kernel": []}
                plain(); kern()                       # warm-up
                for name in ("plain", "kernel", "kernel", "plain"):
                    fn = plain if name == "plain" else kern
                    times[name] += time_calls(torch, fn, 3)
                torch.cuda.empty_cache()
            ms = statistics.median(times["kernel"])
            plain_ms = statistics.median(times["plain"])
            bms, by = bound_ms(R_CHECK, s, cdt, weight_bytes,
                               mlp_macs(256, 63, 27))
            bad = {k: v for k, v in errs.items() if v > TOL[cdt][k]}
            say(f"kernel fused_render_fwd {cdt} R={R_CHECK} S={s}: max_abs_err "
                + " ".join(f"{k}={v:.3e}(tol {TOL[cdt][k]:.0e})"
                           for k, v in errs.items())
                + f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"bound {bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
            if bad:
                fail(f"kernel {cdt} S={s} disagrees with its plain version: {bad}")
            results[(cdt, s)] = dict(err=max(errs.values()), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return results


# ---------------------------------------------------------------- phase 4

CAMERA_ANGLE_X = 0.6911112070083618  # Blender synthetic FOV


def write_sphere_scene(root: str, hw: int) -> None:
    """A Blender-format scene (one frame per split) of a shaded sphere, a
    small copy of the repository's tests/synthetic.py writer."""
    from nerf_tpu_torch.data.poses import pose_spherical
    from nerf_tpu_torch.data.rays import compute_rays_single
    from nerf_tpu_torch.utils.png import write_png

    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    for split, theta in (("train", 10.0), ("val", 100.0), ("test", 200.0)):
        c2w = pose_spherical(theta, -30.0, 4.0)
        o, d = compute_rays_single(hw, hw, focal, c2w)
        b = 2.0 * np.sum(o * d, axis=-1)
        c = np.sum(o * o, axis=-1) - 1.0
        disc = b * b - 4 * c
        tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
        hit = (disc > 0) & (tt > 0)
        p = o + tt[:, None] * d
        n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
        shade = 0.5 + 0.5 * np.clip(n @ np.array([0.3, 0.5, 0.8]), -1, 1)
        img = np.zeros((hw * hw, 4), np.float32)
        img[hit, :3] = np.array([0.9, 0.3, 0.2])[None] * shade[hit, None]
        img[hit, 3] = 1.0
        os.makedirs(os.path.join(root, split), exist_ok=True)
        write_png(os.path.join(root, split, "r_0.png"),
                  (img.reshape(hw, hw, 4) * 255).astype(np.uint8))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X,
                       "frames": [{"file_path": f"./{split}/r_0",
                                   "transform_matrix": c2w.tolist()}]}, f)


def get(url: str) -> tuple:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def serve(torch, dev, tmp: str, config: str, fused_cls, kernel: str,
          model_type: str | None = None, overrides: dict | None = None):
    """Phase 4 (``config`` lego.txt, the NeRF kernels), 8 (lego_siren.txt,
    the SIREN kernels), 11 (lego_siren.txt with ``model_type`` gabor, the
    GaborNet kernels) or 14 (the kilonerf config: lego_siren.txt with
    ``model_type`` kilonerf and ``overrides`` hidden_dim 32, grid_res 8;
    the KiloNeRF field kernels): a checkpoint of ``config`` from its seed,
    served on cuda over loopback; returns the kernel launches of the three
    image requests."""
    label = config if model_type is None else f"{config} (model_type = {model_type})"
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.registry import model_from_config
    from nerf_tpu_torch.serve import RenderService, make_http_server, request_seed
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import make_eval_render
    from nerf_tpu_torch.utils.checkpoint import save_checkpoint
    from nerf_tpu_torch.utils.png import decode_png

    scene = os.path.join(tmp, "scene")
    if not os.path.isdir(scene):
        write_sphere_scene(scene, HW)
    cfg = parse_config_file(os.path.join(ROOT, "configs", config))
    cfg = dataclasses.replace(cfg, dataset_path=scene,
                              save_path=os.path.join(tmp, "models"),
                              model_type=model_type or cfg.model_type,
                              **(overrides or {}))
    gen = torch.Generator().manual_seed(cfg.seed)
    model = model_from_config(cfg, generator=gen)
    fine = None
    if cfg.num_fine_samples > 0 and cfg.separate_fine_model:
        fine = model_from_config(cfg, generator=gen)
    ckpt = save_checkpoint(model, fine, cfg.save_path, cfg.model_type, 0)
    svc = RenderService.from_checkpoint(cfg, ckpt, device=dev, log=say)
    if svc.hw != (HW, HW):
        fail(f"service hw {svc.hw}")
    passes = 2 if cfg.num_fine_samples > 0 else 1
    per_image = passes * math.ceil(HW * HW / cfg.chunk_size)

    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    m = ",".join(str(x) for x in svc.orbit_pose(5)[:3].reshape(-1))
    images, times = {}, []
    fused_cls.launches = 0              # the main path's count starts here
    try:
        code, ctype, body = get(base + "/health")
        health = json.loads(body)
        if code != 200 or health["status"] != "ok" or health["hw"] != [HW, HW]:
            fail(f"/health: {code} {health}")
        for route in ("/pose/0", "/pose/1", f"/render?m={m}"):
            before = fused_cls.launches
            t0 = time.perf_counter()
            code, ctype, body = get(base + route)
            dt = time.perf_counter() - t0
            n = fused_cls.launches - before
            if code != 200 or ctype != "image/png" or body[:8] != b"\x89PNG\r\n\x1a\n":
                fail(f"{label} {route}: status {code}, type {ctype}")
            img = decode_png(body)
            if img.shape != (HW, HW, 3):
                fail(f"{label} {route}: image shape {img.shape}")
            if n != per_image:
                fail(f"{label} {route}: {n} fused render launches, want {per_image}")
            images[route.split("?")[0]] = img
            times.append(dt)
            say(f"serve {label} {route.split('?')[0]}: 200 image/png {HW}x{HW}, "
                f"{n} kernel launches, {dt * 1e3:.1f} ms, "
                f"{HW * HW / dt:.0f} rays/s")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = fused_cls.launches
    if launches != 3 * per_image:
        fail(f"{label}: main path launched the kernel {launches} times")

    # the served /pose/1 against the unfused render of the same request
    ref_render = make_eval_render(svc.params[0], render_settings_from_config(cfg),
                                  fused=False)
    h, w = svc.hw
    from nerf_tpu_torch.data.rays import compute_rays_single

    o, d = compute_rays_single(h, w, svc.focal, svc.orbit_pose(1))
    g = torch.Generator(device=dev).manual_seed(request_seed(cfg.seed, 1))
    ref = ref_render(*svc.params, torch.from_numpy(o).to(dev),
                     torch.from_numpy(d).to(dev), g).rgb
    ref = ref.reshape(h, w, 3).clamp(0, 1).cpu().numpy()
    if not np.isfinite(ref).all():
        fail(f"{label}: unfused reference render is not finite")
    diff = np.abs(images["/pose/1"].astype(np.float32) / 255.0 - ref)
    say(f"serve {label} /pose/1 vs unfused render: mean abs {diff.mean():.3e} "
        f"(tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}")
    if diff.mean() > SERVE_TOL_MEAN:
        fail(f"{label}: served image disagrees with the unfused render")
    med = statistics.median(times)
    say(f"serve: {med * 1e3:.1f} ms per {HW}x{HW} request (median of "
        f"{len(times)}), {HW * HW / med:.0f} rays/s, {per_image} launches "
        f"per request, model {label} ({cfg.compute_dtype}, "
        f"{cfg.num_samples}+{cfg.num_fine_samples})")
    profile_device(torch, lambda: svc.render_pose(svc.orbit_pose(2), key_idx=2),
                   kernel, f"one {label} request")
    return launches


def profile_device(torch, fn, kernel: str, what: str) -> None:
    """A torch.profiler trace of ``fn()``: wall time, device busy and idle
    share, the named kernel's share and the other kernels' time and count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        say("profile: the trace holds no device events; device busy share "
            "not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    mine = [e for e in dev_events if kernel in e.name]
    others = [e for e in dev_events if kernel not in e.name]
    t_mine = sum(e.time_range.elapsed_us() for e in mine)
    t_other = sum(e.time_range.elapsed_us() for e in others)
    say(f"profile: {what} {wall_us / 1e3:.1f} ms wall; device busy "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.4f} of wall, idle "
        f"{1 - busy / wall_us:.4f}); {kernel} {t_mine / 1e3:.1f} ms "
        f"({t_mine / wall_us:.4f}) in {len(mine)} launches, other kernels "
        f"{t_other / 1e3:.1f} ms in {len(others)} launches")
    for label, events, top in (("kernel", mine, 3), ("other", others, 6)):
        by_name: dict = {}
        for e in events:
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
        if label == "kernel" and len(by_name) < 2:
            continue
        for name, (c, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:top]:
            say(f"  {label}: {t / 1e3:.2f} ms in {c} launches: {name[:90]}")


# ---------------------------------------------------------------- phase 3b


def grad_errors(torch, got, ref, views=None) -> dict:
    """Per gradient tensor, max |kernel - plain| over max |plain|, the max
    floored at 1e-2 of the model's largest gradient element (b10s is one
    sum of terms of both signs, whose residue alone is no scale). ``views``
    names the tensors of a flat pair (default: the NeRF layout)."""
    from nerf_tpu_torch.ops.cuda.fused_render import grad_views

    views = views or grad_views
    g, r = views(*got, 256), views(*ref, 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    out = {}
    for k in r:
        if not torch.isfinite(g[k]).all():
            fail(f"non-finite gradient {k}")
        out[k] = float((g[k] - r[k]).abs().max()) / max(float(r[k].abs().max()), floor)
    return out


def check_grad_kernels(torch, dev):
    """The train pass and the render backward against their plain
    versions at 1024 rays x S in {64, 192, 256}, and the two backward
    routes (train kernel; backward kernel from the MSE head's cotangent)
    against each other."""
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_render import (
        FusedNerfRender, fused_render_bwd_plain, fused_train_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = NeRFModel(compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedNerfRender(model, 2.0, 6.0, normalize=True)
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        for s in (64, 192, 256):
            cam, rd, t, tgt = camera_batch(torch, dev, R_TRAIN, s, 2000 + s)
            o_aff, d_aff = fr.affine(cam, rd)
            with torch.no_grad():
                ref = fused_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, 10, 4)
                got = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
                torch.cuda.synchronize()
                errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
                for i, k in ((1, "rgb"), (2, "acc"), (3, "weights")):
                    if not torch.isfinite(got[i]).all():
                        fail(f"train kernel {cdt} S={s}: non-finite {k}")
                    errs[k] = float((got[i] - ref[i]).abs().max())
                gerr = grad_errors(torch, got[4], ref[4])
                # the MSE head's cotangent, for the backward kernel
                scale = 1.0 / (3.0 * R_TRAIN)
                err = ref[1] + (1.0 - ref[2])[:, None] - tgt
                g_ray = torch.zeros(R_TRAIN, 8, device=dev)
                g_ray[:, :3] = 2.0 * scale * err
                g_ray[:, 3] = -g_ray[:, :3].sum(-1)
                ref_b = fused_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray,
                                               10, 4)
                got_b = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
                torch.cuda.synchronize()
                berr = grad_errors(torch, got_b, ref_b)
                cross = grad_errors(torch, got_b, got[4])
                del ref, got, ref_b, got_b
                torch.cuda.empty_cache()
                fns = {
                    ("fused_render_train", "plain"): lambda: fused_train_plain(
                        packed, o_aff, d_aff, rd, t, tgt, True, 10, 4),
                    ("fused_render_train", "kernel"): lambda: fr._train(
                        packed, o_aff, d_aff, rd, t, tgt, True),
                    ("fused_render_bwd", "plain"): lambda: fused_render_bwd_plain(
                        packed, o_aff, d_aff, rd, t, g_ray, 10, 4),
                    ("fused_render_bwd", "kernel"): lambda: fr._backward(
                        packed, o_aff, d_aff, rd, t, g_ray),
                }
                times = {k: [] for k in fns}
                for f in fns.values():
                    f()                                # warm-up
                for name in ("fused_render_train", "fused_render_bwd"):
                    for which in ("plain", "kernel", "kernel", "plain"):
                        times[(name, which)] += time_calls(torch, fns[(name, which)], 2)
                torch.cuda.empty_cache()
            tol = TOL[cdt]
            bad = {k: v for k, v in errs.items() if v > tol["rgb"]}
            for label, e in (("train", gerr), ("bwd", berr), ("bwd vs train", cross)):
                worst = max(e, key=e.get)
                say(f"kernel {label} {cdt} R={R_TRAIN} S={s}: gradient error "
                    f"(max abs over max |g|) worst {worst}={e[worst]:.3e} "
                    f"(tol {GRAD_TOL[cdt]:.0e}), median "
                    f"{statistics.median(e.values()):.3e}; "
                    + " ".join(f"{k}={v:.1e}" for k, v in e.items()))
                bad.update({f"{label}:{k}": v for k, v in e.items()
                            if v > GRAD_TOL[cdt]})
            say(f"kernel train {cdt} R={R_TRAIN} S={s}: "
                + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                + f" (tol {tol['rgb']:.0e})")
            for name in ("fused_render_train", "fused_render_bwd"):
                ms = statistics.median(times[(name, "kernel")])
                plain_ms = statistics.median(times[(name, "plain")])
                bms, by = bound_ms(R_TRAIN, s, cdt, weight_bytes,
                                   3 * mlp_macs(256, 63, 27) - SKIPPED_MACS,
                                   grad_bytes=grad_bytes,
                                   train=name == "fused_render_train")
                say(f"kernel {name} {cdt} R={R_TRAIN} S={s}: kernel {ms:.3f} ms, "
                    f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), "
                    f"share of bound {bms / ms:.4f}")
                e = gerr if name == "fused_render_train" else berr
                worst = max(list(e.values()) + (list(errs.values())
                                                if name == "fused_render_train" else []))
                results[(name, cdt, s)] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                               bound_ms=bms, bound_by=by)
            if bad:
                fail(f"train/backward kernels {cdt} S={s} disagree: {bad}")
    return results


# ---------------------------------------------------------------- phase 7


def check_siren_kernels(torch, dev):
    """The SIREN forward at 1024 x 256 (lego_siren.txt's chunk and
    samples), 1000 x 256 (ragged) and 1024 x 37 (odd S); the train pass and
    the render backward at 1024 x 256, and the two backward routes against
    each other; float32 and bfloat16, TF32 off; the tolerances of the NeRF
    kernels."""
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_render_bwd_plain, fused_siren_render_plain,
        fused_siren_train_plain, grad_views)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = SirenModel(compute_dtype=cdt,
                           generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedSirenRender(model, 2.0, 6.0, normalize=True)
        k = fr.consts
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        worst = 0.0
        for r, s in ((R_SIREN, S_SIREN), (1000, S_SIREN), (R_SIREN, 37)):
            ro, rd, t, _ = camera_batch(torch, dev, r, s, 3000 + r + s)
            o_aff, d_aff = fr.affine(ro, rd)

            def plain():
                return fused_siren_render_plain(packed, o_aff, d_aff, rd, t, k)

            def kern():
                return fr._forward(packed, o_aff, d_aff, rd, t)

            with torch.no_grad():
                ref = plain()
                out = kern()
                torch.cuda.synchronize()
                errs = {}
                for i, name in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[i]).all():
                        fail(f"siren kernel {cdt} R={r} S={s}: non-finite {name}")
                    errs[name] = float((out[i] - ref[i]).abs().max())
                del ref, out
                torch.cuda.empty_cache()
                timed = (r, s) == (R_SIREN, S_SIREN)
                if timed:
                    times = {"plain": [], "kernel": []}
                    plain(); kern()                       # warm-up
                    for name in ("plain", "kernel", "kernel", "plain"):
                        fn = plain if name == "plain" else kern
                        times[name] += time_calls(torch, fn, 3)
                    torch.cuda.empty_cache()
            bad = {n: v for n, v in errs.items() if v > TOL[cdt][n]}
            line = (f"kernel fused_render_siren_fwd {cdt} R={r} S={s}: max_abs_err "
                    + " ".join(f"{n}={v:.3e}(tol {TOL[cdt][n]:.0e})"
                               for n, v in errs.items()))
            if timed:
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                bms, by = bound_ms(r, s, cdt, weight_bytes, SIREN_MACS, SIREN_TRIG)
                line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                         f"{bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
                results[("fused_render_siren_fwd", cdt)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            say(line)
            if bad:
                fail(f"siren kernel {cdt} R={r} S={s} disagrees with its plain "
                     f"version: {bad}")
            worst = max(worst, max(errs.values()))
        results[("fused_render_siren_fwd", cdt)]["err"] = worst

        # the train pass and the render backward at lego_siren.txt's shape
        r, s = R_TRAIN, S_SIREN
        cam, rd, t, tgt = camera_batch(torch, dev, r, s, 4000 + s)
        o_aff, d_aff = fr.affine(cam, rd)
        with torch.no_grad():
            ref = fused_siren_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, k)
            got = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
            torch.cuda.synchronize()
            errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
            for i, name in ((1, "rgb"), (2, "acc"), (3, "weights")):
                if not torch.isfinite(got[i]).all():
                    fail(f"siren train kernel {cdt}: non-finite {name}")
                errs[name] = float((got[i] - ref[i]).abs().max())
            gerr = grad_errors(torch, got[4], ref[4], grad_views)
            scale = 1.0 / (3.0 * r)
            err = ref[1] + (1.0 - ref[2])[:, None] - tgt
            g_ray = torch.zeros(r, 8, device=dev)
            g_ray[:, :3] = 2.0 * scale * err
            g_ray[:, 3] = -g_ray[:, :3].sum(-1)
            ref_b = fused_siren_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, k)
            got_b = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
            torch.cuda.synchronize()
            berr = grad_errors(torch, got_b, ref_b, grad_views)
            cross = grad_errors(torch, got_b, got[4], grad_views)
            del ref, got, ref_b, got_b
            torch.cuda.empty_cache()
            fns = {
                ("fused_render_siren_train", "plain"): lambda: fused_siren_train_plain(
                    packed, o_aff, d_aff, rd, t, tgt, True, k),
                ("fused_render_siren_train", "kernel"): lambda: fr._train(
                    packed, o_aff, d_aff, rd, t, tgt, True),
                ("fused_render_siren_bwd", "plain"): lambda: fused_siren_render_bwd_plain(
                    packed, o_aff, d_aff, rd, t, g_ray, k),
                ("fused_render_siren_bwd", "kernel"): lambda: fr._backward(
                    packed, o_aff, d_aff, rd, t, g_ray),
            }
            times = {key: [] for key in fns}
            for f in fns.values():
                f()                                    # warm-up
            for name in ("fused_render_siren_train", "fused_render_siren_bwd"):
                for which in ("plain", "kernel", "kernel", "plain"):
                    times[(name, which)] += time_calls(torch, fns[(name, which)], 2)
            torch.cuda.empty_cache()
        bad = {n: v for n, v in errs.items() if v > TOL[cdt]["rgb"]}
        for label, e in (("train", gerr), ("bwd", berr), ("bwd vs train", cross)):
            w = max(e, key=e.get)
            say(f"kernel siren {label} {cdt} R={r} S={s}: gradient error (max abs "
                f"over max |g|) worst {w}={e[w]:.3e} (tol {GRAD_TOL[cdt]:.0e}), "
                f"median {statistics.median(e.values()):.3e}; "
                + " ".join(f"{n}={v:.1e}" for n, v in e.items()))
            bad.update({f"{label}:{n}": v for n, v in e.items() if v > GRAD_TOL[cdt]})
        say(f"kernel siren train {cdt} R={r} S={s}: "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items())
            + f" (tol {TOL[cdt]['rgb']:.0e})")
        for name in ("fused_render_siren_train", "fused_render_siren_bwd"):
            ms = statistics.median(times[(name, "kernel")])
            plain_ms = statistics.median(times[(name, "plain")])
            bms, by = bound_ms(r, s, cdt, weight_bytes,
                               3 * SIREN_MACS - SIREN_SKIPPED, 2 * SIREN_TRIG,
                               grad_bytes, name == "fused_render_siren_train")
            say(f"kernel {name} {cdt} R={r} S={s}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share of bound "
                f"{bms / ms:.4f}")
            e = gerr if name == "fused_render_siren_train" else berr
            worst = max(list(e.values()) + (list(errs.values()) if name ==
                                            "fused_render_siren_train" else []))
            results[(name, cdt)] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bms, bound_by=by)
        if bad:
            fail(f"siren train/backward kernels {cdt} disagree: {bad}")
    return results


# ---------------------------------------------------------------- phase 10


def check_gabor_kernels(torch, dev):
    """The GaborNet forward at 1024 x 256 (lego_siren.txt's chunk and
    samples), 1000 x 256 (ragged) and 1024 x 37 (odd S: chunks span rays);
    the train pass at 1024 x 256, its coefficient cotangents dA..dR (max abs
    over max |d| per coefficient) and the filter gradients after autograd
    through the prep (as grad_errors); float32 and bfloat16, TF32 off; the
    tolerances of the NeRF kernels."""
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_render_plain, fused_gabor_train_plain,
        gabor_coeffs, grad_views, stack_filters)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = GaborModel(compute_dtype=cdt,
                           generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedGaborRender(model, 2.0, 6.0, normalize=True)
        k = fr.consts
        gpack = fr.pack(model)
        packed = gpack.packed
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        worst = 0.0
        for r, s in ((R_SIREN, S_SIREN), (1000, S_SIREN), (R_SIREN, 37)):
            ro, rd, t, _ = camera_batch(torch, dev, r, s, 5000 + r + s)
            o_aff, d_aff = fr.affine(ro, rd)
            with torch.no_grad():
                coeffs = gabor_coeffs(*gpack.filters, o_aff, d_aff)

            def plain():
                return fused_gabor_render_plain(packed, coeffs, rd, t, k)

            def kern():
                return fr._forward(packed, coeffs, rd, t)

            with torch.no_grad():
                ref = plain()
                out = kern()
                torch.cuda.synchronize()
                errs = {}
                for i, name in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[i]).all():
                        fail(f"gabor kernel {cdt} R={r} S={s}: non-finite {name}")
                    errs[name] = float((out[i] - ref[i]).abs().max())
                del ref, out
                torch.cuda.empty_cache()
                timed = (r, s) == (R_SIREN, S_SIREN)
                if timed:
                    times = {"plain": [], "kernel": []}
                    plain(); kern()                       # warm-up
                    for name in ("plain", "kernel", "kernel", "plain"):
                        fn = plain if name == "plain" else kern
                        times[name] += time_calls(torch, fn, 3)
                    torch.cuda.empty_cache()
            bad = {n: v for n, v in errs.items() if v > TOL[cdt][n]}
            line = (f"kernel fused_render_gabor_fwd {cdt} R={r} S={s}: max_abs_err "
                    + " ".join(f"{n}={v:.3e}(tol {TOL[cdt][n]:.0e})"
                               for n, v in errs.items()))
            if timed:
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                bms, by = bound_ms(r, s, cdt, weight_bytes + r * GABOR_COEF_BYTES,
                                   GABOR_MACS, GABOR_TRIG)
                line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                         f"{bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
                results[("fused_render_gabor_fwd", cdt)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            say(line)
            if bad:
                fail(f"gabor kernel {cdt} R={r} S={s} disagrees with its plain "
                     f"version: {bad}")
            worst = max(worst, max(errs.values()))
        results[("fused_render_gabor_fwd", cdt)]["err"] = worst

        # the train pass at lego_siren.txt's shape, then the filter gradients
        # through the prep from each side's dA..dR
        r, s = R_TRAIN, S_SIREN
        cam, rd, t, tgt = camera_batch(torch, dev, r, s, 6000 + s)
        o_aff, d_aff = fr.affine(cam, rd)
        filters = stack_filters(model)
        coeffs = gabor_coeffs(*filters, o_aff, d_aff)
        cdet = coeffs.detach()
        with torch.no_grad():
            ref = fused_gabor_train_plain(packed, cdet, rd, t, tgt, True, k)
            got = fr._train(packed, cdet, rd, t, tgt, True)
            torch.cuda.synchronize()
        errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
        for i, name in ((1, "rgb"), (2, "acc"), (3, "weights")):
            if not torch.isfinite(got[i]).all():
                fail(f"gabor train kernel {cdt}: non-finite {name}")
            errs[name] = float((got[i] - ref[i]).abs().max())
        gerr = grad_errors(torch, got[4], ref[4], grad_views)
        if not torch.isfinite(got[5]).all():
            fail(f"gabor train kernel {cdt}: non-finite coefficient cotangents")
        derr = {f"d{c}": float((got[5][j] - ref[5][j]).abs().max() / ref[5][j].abs().max())
                for j, c in enumerate("ABPQR")}
        h = model.hidden_dim

        def per_stage(grads):
            om, ph, mu, ga = grads
            out = {}
            for i in range(model.num_layers):
                cols = slice(i * h, (i + 1) * h)
                out.update({f"omega{i}": om[:, cols], f"phi{i}": ph[cols],
                            f"mu{i}": mu[cols], f"gamma{i}": ga[cols]})
            return out

        ref_f = per_stage(torch.autograd.grad(coeffs, filters, ref[5], retain_graph=True))
        got_f = per_stage(torch.autograd.grad(coeffs, filters, got[5]))
        floor = 1e-2 * max(float(v.abs().max()) for v in ref_f.values())
        ferr = {n: float((got_f[n] - ref_f[n]).abs().max())
                / max(float(ref_f[n].abs().max()), floor) for n in ref_f}
        del ref, got, ref_f, got_f, coeffs, filters
        torch.cuda.empty_cache()
        with torch.no_grad():
            fns = {"plain": lambda: fused_gabor_train_plain(packed, cdet, rd, t, tgt,
                                                             True, k),
                   "kernel": lambda: fr._train(packed, cdet, rd, t, tgt, True)}
            times = {key: [] for key in fns}
            for f in fns.values():
                f()                                    # warm-up
            for which in ("plain", "kernel", "kernel", "plain"):
                times[which] += time_calls(torch, fns[which], 2)
            torch.cuda.empty_cache()
        bad = {n: v for n, v in errs.items() if v > TOL[cdt]["rgb"]}
        for label, e in (("train", gerr), ("dA..dR", derr), ("filters", ferr)):
            w = max(e, key=e.get)
            say(f"kernel gabor {label} {cdt} R={r} S={s}: gradient error (max abs "
                f"over max |g|) worst {w}={e[w]:.3e} (tol {GRAD_TOL[cdt]:.0e}), "
                f"median {statistics.median(e.values()):.3e}"
                + ("" if label == "filters" else "; " + " ".join(
                    f"{n}={v:.1e}" for n, v in e.items())))
            bad.update({f"{label}:{n}": v for n, v in e.items() if v > GRAD_TOL[cdt]})
        say(f"kernel gabor train {cdt} R={r} S={s}: "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items())
            + f" (tol {TOL[cdt]['rgb']:.0e})")
        ms = statistics.median(times["kernel"])
        plain_ms = statistics.median(times["plain"])
        bms, by = bound_ms(r, s, cdt, weight_bytes + r * GABOR_COEF_BYTES,
                           3 * GABOR_MACS - GABOR_SKIPPED, 2 * GABOR_TRIG,
                           grad_bytes + r * GABOR_COEF_BYTES, True)
        say(f"kernel fused_render_gabor_train {cdt} R={r} S={s}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share of bound "
            f"{bms / ms:.4f}")
        worst = max(list(gerr.values()) + list(derr.values()) + list(ferr.values())
                    + list(errs.values()))
        results[("fused_render_gabor_train", cdt)] = dict(
            err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        if bad:
            fail(f"gabor train kernel {cdt} disagrees: {bad}")
    return results


# ---------------------------------------------------------------- phase 13


def kilo_bound_ms(n: int, cdt: str, g3: int, backward: bool) -> tuple:
    """Least time of the KiloNeRF forward (or backward) over ``n`` points:
    the products (2 operations a MAC) over the compute dtype's peak and the
    sines over the float32 CUDA-core rate (their sum in float32, the larger
    in bfloat16), against the bytes that must move (see KILO_MACS)."""
    macs = KILO_BWD_MACS if backward else KILO_MACS
    wbytes = g3 * KILO_R * (4 if cdt == "float32" else 2)
    nbytes = n * (24 + 16) + wbytes + (g3 * KILO_R * 4 if backward else 0)
    t_mm = 2 * macs * n / PEAK_FLOPS[cdt] * 1e3
    t_trig = KILO_TRIG * n / PEAK_FLOPS["float32"] * 1e3
    t_ops = t_mm + t_trig if cdt == "float32" else max(t_mm, t_trig)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kilo_point_sets(torch, dev) -> dict:
    """The phase-13 point sets: 1024 x 256 camera-ray samples normalised as
    the renderer normalises them (the serve and train shape), 16,384 points
    uniform over the domain (the distillation batch), 5,000 points in one
    voxel, and 37 points (most of the 512 networks empty)."""
    g = torch.Generator(device=dev).manual_seed(13)
    ro, rd, t, _ = camera_batch(torch, dev, R_SIREN, S_SIREN, 13)
    pts = ro[:, None, :] + t[..., None] * rd[:, None, :]
    pts = 2.0 * (pts - 2.0) / (6.0 - 2.0) - 1.0
    dirs = rd[:, None, :].expand(pts.shape)
    lo, hi = KILO_DOMAIN

    def unit(n):
        d = torch.randn(n, 3, generator=g, device=dev)
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    uni = torch.rand(16384, 3, generator=g, device=dev) * (hi - lo) + lo
    vox = lo + (hi - lo) * (0.3 + 0.0125 * torch.rand(5000, 3, generator=g, device=dev))
    few = torch.rand(37, 3, generator=g, device=dev) * (hi - lo) + lo
    return {"camera 1024x256": (pts.reshape(-1, 3), dirs.reshape(-1, 3)),
            "uniform 16384": (uni, unit(16384)), "one voxel 5000": (vox, unit(5000)),
            "37 points": (few, unit(37))}


def check_kilonerf_kernels(torch, dev):
    """Both KiloNeRF kernels against their plain versions on every phase-13
    point set, float32 and bfloat16 with TF32 off: outputs (max abs) and
    gradients (max abs over max |g| per tensor), the exact zeros of empty
    networks; both timed in turns (plain, kernel, kernel, plain) at the
    camera set against their bound."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        KiloNeRFField, cast_packed, dispatch, kilonerf_bwd_plain, kilonerf_fwd_plain,
        pack_f32, unpack)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    sets = kilo_point_sets(torch, dev)
    for cdt in ("float32", "bfloat16"):
        model = KiloNeRFModel(grid_res=8, hidden_dim=32, compute_dtype=cdt,
                              domain=KILO_DOMAIN,
                              generator=torch.Generator().manual_seed(7)).to(dev)
        field = KiloNeRFField(model)
        with torch.no_grad():
            wc = cast_packed(pack_f32(model), model.cdt)
        worst = {"fwd": 0.0, "bwd": 0.0}
        for label, (pts, dirs) in sets.items():
            n = pts.shape[0]
            disp = dispatch(model, pts, dirs)
            cot = torch.randn(n, 4, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(n))
            with torch.no_grad():
                ref = kilonerf_fwd_plain(wc, disp, 32, 10, 4)
                out = field._forward(wc, disp)
                ref_g = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4)
                got_g = field._backward(wc, disp, cot)
                torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and torch.isfinite(got_g).all()):
                fail(f"kilonerf kernels {cdt} {label}: non-finite output or gradient")
            err = float((out - ref).abs().max())
            g, r = unpack(got_g, 32, 63, 27), unpack(ref_g, 32, 63, 27)
            floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
            gerr = {k: float((g[k] - r[k]).abs().max()) / max(float(r[k].abs().max()), floor)
                    for k in r}
            empty = disp.counts == 0
            zeros = bool((got_g[empty] == 0).all())
            w = max(gerr, key=gerr.get)
            say(f"kernel kilonerf {cdt} {label}: forward max_abs_err {err:.3e} "
                f"(tol {KILO_TOL[cdt]:.0e}); gradient error (max abs over max |g|) "
                f"worst {w}={gerr[w]:.3e} (tol {KILO_GRAD_TOL[cdt]:.0e}), median "
                f"{statistics.median(gerr.values()):.3e}; {int(empty.sum())} empty "
                f"networks, gradients exactly 0: {zeros}")
            if err > KILO_TOL[cdt] or gerr[w] > KILO_GRAD_TOL[cdt] or not zeros:
                fail(f"kilonerf kernels {cdt} {label} disagree with their plain versions")
            worst["fwd"] = max(worst["fwd"], err)
            worst["bwd"] = max(worst["bwd"], gerr[w])
            if label.startswith("camera"):
                with torch.no_grad():
                    fns = {
                        ("fused_kilonerf_fwd", "plain"):
                            lambda: kilonerf_fwd_plain(wc, disp, 32, 10, 4),
                        ("fused_kilonerf_fwd", "kernel"):
                            lambda: field._forward(wc, disp),
                        ("fused_kilonerf_bwd", "plain"):
                            lambda: kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4),
                        ("fused_kilonerf_bwd", "kernel"):
                            lambda: field._backward(wc, disp, cot),
                    }
                    times = {k: [] for k in fns}
                    for f in fns.values():
                        f()                                    # warm-up
                    # a kernel of ~0.4 ms is as long as the host takes to
                    # issue it: time runs of KILO_BATCH launches between
                    # two events, so that the queue stays full and host
                    # gaps do not count
                    for name in ("fused_kilonerf_fwd", "fused_kilonerf_bwd"):
                        for which in ("plain", "kernel", "kernel", "plain"):
                            f = fns[(name, which)]
                            times[(name, which)] += [
                                t / KILO_BATCH for t in time_calls(
                                    torch, lambda f=f: [f() for _ in range(KILO_BATCH)], 3)]
                    torch.cuda.empty_cache()
                for name in ("fused_kilonerf_fwd", "fused_kilonerf_bwd"):
                    ms = statistics.median(times[(name, "kernel")])
                    plain_ms = statistics.median(times[(name, "plain")])
                    bms, by = kilo_bound_ms(n, cdt, 512, name.endswith("bwd"))
                    say(f"kernel {name} {cdt} {label}: kernel {ms:.3f} ms, plain "
                        f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share of bound "
                        f"{bms / ms:.4f}")
                    results[(name, cdt)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                                bound_by=by)
            del ref, out, ref_g, got_g, disp
            torch.cuda.empty_cache()
        results[("fused_kilonerf_fwd", cdt)]["err"] = worst["fwd"]
        results[("fused_kilonerf_bwd", cdt)]["err"] = worst["bwd"]
    return results


# ---------------------------------------------------------------- phase 15


def train_kilonerf(torch, dev, tmp: str) -> dict:
    """Phase 15: the kilonerf config's teacher (model_type nerf, hidden 32,
    use_pallas = false: the module path, as the JAX package runs a hidden-32
    NeRF) for 100 steps; then fit() of kilonerf distilling it (100 steps of
    16,384 points, the last loss under the first) and training 200
    photometric steps (the mse at 190 under that at 0) through the field
    kernels; a bit-identical resume from step 100 (no distillation); the
    launch counts; a profile of one step."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config

    base = parse_config_file(os.path.join(ROOT, "configs", "lego_siren.txt"))
    common = dict(dataset_path=os.path.join(tmp, "scene"), log_interval=10,
                  val_interval=100, save_interval=100, **KILO_OVERRIDES)
    tcfg = dataclasses.replace(base, model_type="nerf", use_pallas=False, num_iters=100,
                               save_path=os.path.join(tmp, "teacher_models"),
                               log_dir=os.path.join(tmp, "teacher_logs"), **common)
    t0 = time.perf_counter()
    fit(tcfg, device=dev, log=lambda *_: None)
    teacher = os.path.join(tcfg.save_path, "nerf_model_000100")
    tloss = read_scalars(tcfg.log_dir)["loss"]
    say(f"train: teacher (lego_siren.txt, model_type = nerf, hidden 32, module path) "
        f"100 iterations in {time.perf_counter() - t0:.1f} s, mse {tloss[0]:.6f} at 0 -> "
        f"{tloss[90]:.6f} at 90")
    cfg = dataclasses.replace(base, model_type="kilonerf", num_iters=200,
                              distill_from=teacher, distill_steps=100, distill_batch=16384,
                              save_path=os.path.join(tmp, "train_models_kilonerf"),
                              log_dir=os.path.join(tmp, "train_logs_kilonerf"), **common)
    lines: list = []
    KiloNeRFField.launches = KiloNeRFField.bwd_launches = 0   # the main path's counts
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (KiloNeRFField.launches, KiloNeRFField.bwd_launches)
    say(f"train: fit kilonerf (distillation 100 x 16384 points, then 200 iterations) in "
        f"{wall:.1f} s; launches: forward {counts[0]}, backward {counts[1]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Distill" in line:
            say(f"  {line}")
    per_image = math.ceil(HW * HW / cfg.chunk_size)
    want = (100 + 200 + per_image, 100 + 200)
    if counts != want:
        fail(f"fit kilonerf launched (forward, backward) {counts}, want {want}")
    scal = read_scalars(cfg.log_dir)
    dl = scal["distill_loss"]
    if sorted(dl) != list(range(100)) or not dl[99] < dl[0]:
        fail(f"distillation loss {dl.get(0)} at 0 -> {dl.get(99)} at 99 does not fall")
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 200, 10)) or not all(
            math.isfinite(v) for v in loss.values()):
        fail(f"kilonerf logged mse {loss}")
    if not loss[190] < loss[0]:
        fail(f"kilonerf: mse at 190 ({loss[190]}) is not under that at 0 ({loss[0]})")
    step_rps = scal["rays_per_sec"][190]
    say(f"train: distill loss {dl[0]:.6f} at 0 -> {dl[99]:.6f} at 99; mse {loss[0]:.6f} "
        f"at 0 -> {loss[190]:.6f} at 190 (ratio {loss[190] / loss[0]:.4f}); kilonerf "
        f"step {step_rps:.0f} rays/s ({cfg.num_random_rays} rays, {cfg.num_samples} "
        f"samples, {cfg.compute_dtype})")
    check_resume(torch, dev, tmp, cfg, "kilonerf", loss)
    from nerf_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device=dev)
    scene = load_scene(cfg, device=dev)
    profile_step(torch, state, scene.pool, render_settings_from_config(cfg), cfg,
                 "fused_kilonerf", "kilonerf")
    return {"fwd_launches": counts[0], "bwd_launches": counts[1], "step_rps": step_rps}


def bench_kilonerf(torch, dev) -> float:
    """bench.py's train_kilonerf row: 512 networks of hidden 32 (grid 8,
    L = 10/4) over grid_domain, bf16, 1024 x 256, the 1<<20 pool, warm-up
    (2 calls of 8 steps there: 16 steps), then 5 x 8 = 40 timed steps."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel

    model = KiloNeRFModel(grid_res=8, hidden_dim=32, compute_dtype="bfloat16",
                          domain=KILO_DOMAIN,
                          generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 40, 16, "bench train_kilonerf (bench.py "
                       "protocol, KiloNeRF 512 x h32 bf16 1024x256)")


# ---------------------------------------------------------------- phase 5


def read_scalars(log_dir: str) -> dict:
    """{tag: {step: value}} from the train.log of the one run under
    ``log_dir``."""
    runs = os.listdir(log_dir)
    if len(runs) != 1:
        fail(f"{log_dir}: expected one run directory, found {runs}")
    out: dict = {}
    with open(os.path.join(log_dir, runs[0], "train.log")) as f:
        for line in f:
            if line.startswith("scalar "):
                _, tag, step, value = line.split()
                out.setdefault(tag, {})[int(step)] = float(value)
    return out


def check_resume(torch, dev, tmp: str, cfg, name: str, loss: dict) -> None:
    """A resume from the step-100 checkpoint of ``fit``'s run: the restore
    is exact, and every resumed step to 120 repeats the first run's mse
    (``loss``) at the same state.step (the loop restarts at the saved
    iteration while state.step is one ahead)."""
    import dataclasses

    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state

    ckpt = os.path.join(cfg.save_path, f"{name}_model_000100")
    saved = load_checkpoint(ckpt)
    probe = create_train_state(cfg, device=dev)
    restore_train_state(probe, ckpt)
    same = probe.step == saved["train_step"] == 101
    for m, sd in ((probe.params, saved["params"]), (probe.fine_params, saved["fine_params"])):
        if m is None:
            same &= sd == {}
            continue
        same &= all(torch.equal(v.cpu(), sd[k]) for k, v in m.state_dict().items())
    for mine, theirs in ((probe.optimizer.mu, saved["optimizer"]["mu"]),
                         (probe.optimizer.nu, saved["optimizer"]["nu"])):
        same &= all(torch.equal(a.cpu(), b) for a, b in zip(mine, theirs))
    if not same:
        fail("the restored step, parameters or Adam moments differ from the save")
    del probe
    cfg2 = dataclasses.replace(cfg, num_iters=120, log_interval=1,
                               save_path=os.path.join(tmp, f"resume_models_{name}"),
                               log_dir=os.path.join(tmp, f"resume_logs_{name}"))
    lines2: list = []
    resumed = fit(cfg2, resume_path=ckpt, device=dev, log=lines2.append)
    loss2 = read_scalars(cfg2.log_dir)["loss"]
    pairs = [(i, i + 1) for i in sorted(loss2) if i + 1 in loss]
    if resumed.step != 121 or len(pairs) != 2:
        fail(f"resume: state.step {resumed.step}, comparable steps {pairs}")
    for i, j in pairs:
        say(f"train: resumed iteration {i} (state.step {i + 2}) mse "
            f"{loss2[i]!r}, first run iteration {j} mse {loss[j]!r}")
        if loss2[i] != loss[j]:
            fail("the resumed run does not repeat the first run bit for bit")
    del resumed


def train(torch, dev, tmp: str, config: str, fused_cls, kernel: str,
          max_ratio: float, model_type: str | None = None) -> dict:
    """Phase 5 (``config`` lego.txt, the NeRF kernels, the mse at 190 under
    ``max_ratio`` = 0.5 of that at 0), 9 (lego_siren.txt, the SIREN kernels,
    ``max_ratio`` 1) or 12 (lego_siren.txt with ``model_type`` gabor, the
    GaborNet kernels, ``max_ratio`` 1; its forward render has no backward,
    so the render route must raise instead)."""
    label = config if model_type is None else f"{config} (model_type = {model_type})"
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.render.renderer import render_rays
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config

    cfg = parse_config_file(os.path.join(ROOT, "configs", config))
    name = model_type or cfg.model_type
    cfg = dataclasses.replace(
        cfg, model_type=name, dataset_path=os.path.join(tmp, "scene"), num_iters=200,
        log_interval=10, val_interval=100, save_interval=100,
        save_path=os.path.join(tmp, f"train_models_{name}"),
        log_dir=os.path.join(tmp, f"train_logs_{name}"))
    passes = 2 if cfg.num_fine_samples > 0 else 1
    lines: list = []
    fused_cls.launches = fused_cls.train_launches = 0
    fused_cls.bwd_launches = 0              # the main path's counts start here
    t0 = time.perf_counter()
    state = fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fused_cls.train_launches, fused_cls.launches, fused_cls.bwd_launches)
    say(f"train: fit {label} 200 iterations in {wall:.1f} s; launches: "
        f"train {counts[0]}, forward {counts[1]}, backward {counts[2]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line:
            say(f"  {line}")
    want = (passes * cfg.num_iters, passes * math.ceil(HW * HW / cfg.chunk_size), 0)
    if counts != want:
        fail(f"fit {label} launched (train, forward, backward) {counts}, want {want}")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 200, 10)):
        fail(f"logged iterations {sorted(loss)}")
    if not all(math.isfinite(v) for v in loss.values()):
        fail(f"non-finite logged loss {loss}")
    if not loss[190] < max_ratio * loss[0]:
        fail(f"{label}: mse at 190 ({loss[190]}) is not under {max_ratio} of "
             f"that at 0 ({loss[0]})")
    for step in (100, 200):
        path = os.path.join(cfg.save_path, f"{name}_model_{step:06d}")
        if not (os.path.exists(path) and os.path.exists(path + ".meta.json")):
            fail(f"missing checkpoint {path}")
    step_rps = scal["rays_per_sec"][190]
    say(f"train: mse {loss[0]:.6f} at 0 -> {loss[190]:.6f} at 190 (ratio "
        f"{loss[190] / loss[0]:.4f}); {label} step {step_rps:.0f} rays/s "
        f"({cfg.num_random_rays} rays, {cfg.num_samples}+{cfg.num_fine_samples} "
        f"samples, {cfg.compute_dtype})")

    check_resume(torch, dev, tmp, cfg, name, loss)

    scene = load_scene(cfg, device=dev)
    settings = render_settings_from_config(cfg)
    fr = fused_cls(state.params, cfg.near, cfg.far)
    if model_type == "gabor":
        # the forward render has no backward (the JAX one's VJP raises): under
        # autograd it must refuse before launching anything
        g = torch.Generator(device=dev).manual_seed(cfg.seed)
        batch = scene.pool.sample(g, cfg.num_random_rays)
        fused_cls.launches = 0
        try:
            render_rays(state.params, batch.rays_o, batch.rays_d, settings,
                        generator=g, viewdirs=batch.viewdirs, fused_render=fr)
        except NotImplementedError as e:
            say(f"train: {label} render route under autograd raises "
                f"NotImplementedError ({e}); forward launches {fused_cls.launches}")
        else:
            fail(f"{label}: the forward render under autograd did not raise")
        if fused_cls.launches != 0:
            fail(f"{label}: the refused render route launched a kernel")
        profile_step(torch, state, scene.pool, settings, cfg, kernel, label)
        return {"train_launches": cfg.num_iters, "bwd_launches": 0,
                "step_rps": step_rps}

    # the render route: render_rays through the forward kernel, the loss,
    # and its backward under autograd (the backward kernel), then Adam
    fused_cls.launches = fused_cls.train_launches = 0
    fused_cls.bwd_launches = 0              # this path's counts start here
    mses = []
    for i in range(3):
        g = torch.Generator(device=dev).manual_seed(cfg.seed + i)
        batch = scene.pool.sample(g, cfg.num_random_rays)
        for m in state.models():
            m.zero_grad(set_to_none=True)
        out = render_rays(state.params, batch.rays_o, batch.rays_d, settings,
                          generator=g, fine_params=state.fine_params,
                          viewdirs=batch.viewdirs, fused_render=fr)
        mse = torch.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if passes == 2:
            loss = loss + torch.mean((out.rgb_coarse - batch.rgb) ** 2)
        loss.backward()
        state.optimizer.step()
        mses.append(float(mse.detach()))
    counts = (fused_cls.train_launches, fused_cls.launches, fused_cls.bwd_launches)
    say(f"train: {label} render route 3 steps, mse {mses}; launches: train "
        f"{counts[0]}, forward {counts[1]}, backward {counts[2]}")
    want = (0, 3 * passes, 3 * passes)
    if counts != want or not all(math.isfinite(v) for v in mses):
        fail(f"{label} render route launched {counts}, want {want}")
    profile_step(torch, state, scene.pool, settings, cfg, kernel, label)
    return {"train_launches": passes * cfg.num_iters, "bwd_launches": counts[2],
            "step_rps": step_rps}


def profile_step(torch, state, pool, settings, cfg, kernel: str,
                 config: str) -> None:
    """One train step of ``config`` under torch.profiler."""
    from nerf_tpu_torch.train.step import make_train_step

    step = make_train_step(state.params, settings, cfg.num_random_rays, cfg.seed)
    step(state, pool)
    profile_device(torch, lambda: step(state, pool), kernel,
                   f"one {config} train step")


# ---------------------------------------------------------------- phase 6


def bench_train(torch, dev, model, steps: int, warmup: int, label: str) -> float:
    """bench.py's train protocol for ``model`` (bf16): 1024 rays x 256
    samples per ray (per-ray jitter), white background, a 1<<20 synthetic
    pool made on the card, ``warmup`` steps, then ``steps`` chained steps
    timed to a scalar fetched on the host."""
    from nerf_tpu_torch.config import Config
    from nerf_tpu_torch.data.pipeline import RayPool
    from nerf_tpu_torch.render.renderer import RenderSettings
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import TrainState
    from nerf_tpu_torch.train.step import make_train_step

    state = TrainState(step=0, params=model, fine_params=None,
                       optimizer=make_optimizer(Config(), list(model.parameters())))
    g = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 20
    rays_d = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g, device=dev), dim=-1)
    pool = RayPool(rays_o=torch.randn(n, 3, generator=g, device=dev) * 0.1,
                   rays_d=rays_d, rgb=torch.rand(n, 3, generator=g, device=dev),
                   viewdirs=rays_d)
    settings = RenderSettings(near=2.0, far=6.0, num_samples=256,
                              white_background=True, jitter_mode="per_ray")
    step = make_train_step(model, settings, 1024, seed=2)
    for _ in range(warmup):
        m = step(state, pool)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, pool)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail(f"{label}: non-finite loss")
    rps = steps * 1024 / dt
    say(f"{label}: {rps:.0f} rays/s, {dt / steps * 1e3:.2f} ms per step "
        f"({steps} chained steps)")
    return rps


def bench_headline(torch, dev) -> float:
    """bench.py's headline: flat NeRF, bf16, 5 warm-up steps, 30 timed."""
    from nerf_tpu_torch.models.nerf import NeRFModel

    model = NeRFModel(compute_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 30, 5, "bench headline (bench.py "
                       "protocol, flat NeRF bf16 1024x256)")


def bench_siren(torch, dev) -> float:
    """bench.py's train_siren row: flat SIREN, bf16, warm-up (two calls of
    10 steps there: 20 steps), then 5 x 10 = 50 timed steps."""
    from nerf_tpu_torch.models.siren import SirenModel

    model = SirenModel(compute_dtype="bfloat16",
                       generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 50, 20, "bench train_siren (bench.py "
                       "protocol, flat SIREN bf16 1024x256)")


def bench_gabor(torch, dev) -> float:
    """bench.py's train_gabor row: flat GaborNet, bf16, the train_siren
    protocol (20 warm-up steps, 50 timed)."""
    from nerf_tpu_torch.models.gabor import GaborModel

    model = GaborModel(compute_dtype="bfloat16",
                       generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 50, 20, "bench train_gabor (bench.py "
                       "protocol, flat GaborNet bf16 1024x256)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from nerf_tpu_torch.ops.cuda import build
        from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
        from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
        from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
        from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
    except ImportError as e:
        print(f"chip_smoke: nerf_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    infos = build.build()
    say(f"build: {len(infos)} libraries in {time.perf_counter() - t0:.1f} s "
        "(one nvcc per source, in parallel)")
    for info in infos:
        say(f"build: {info.name} {info.seconds:.1f} s -> "
            f"{os.path.relpath(info.path, ROOT)}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas: {line.strip()}")

    checks = check_kernel(torch, dev)
    grad_checks = check_grad_kernels(torch, dev)
    siren_checks = check_siren_kernels(torch, dev)
    gabor_checks = check_gabor_kernels(torch, dev)
    kilo_checks = check_kilonerf_kernels(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve(torch, dev, tmp, "lego.txt", FusedNerfRender,
                         "fused_render_fwd")
        trained = train(torch, dev, tmp, "lego.txt", FusedNerfRender,
                        "fused_render_grad", 0.5)
        siren_launches = serve(torch, dev, tmp, "lego_siren.txt", FusedSirenRender,
                               "fused_siren_fwd")
        siren_trained = train(torch, dev, tmp, "lego_siren.txt", FusedSirenRender,
                              "fused_siren_grad", 1.0)
        gabor_launches = serve(torch, dev, tmp, "lego_siren.txt", FusedGaborRender,
                               "fused_gabor_fwd", "gabor")
        gabor_trained = train(torch, dev, tmp, "lego_siren.txt", FusedGaborRender,
                              "fused_gabor_train", 1.0, "gabor")
        kilo_launches = serve(torch, dev, tmp, "lego_siren.txt", KiloNeRFField,
                              "fused_kilonerf_fwd", "kilonerf", KILO_OVERRIDES)
        kilo_trained = train_kilonerf(torch, dev, tmp)
    bench_headline(torch, dev)
    bench_siren(torch, dev)
    bench_gabor(torch, dev)
    bench_kilonerf(torch, dev)

    def row(name, source, line, launched, c, err):
        return {"name": name, "route": "cuda",
                "source": f"nerf_tpu_torch/csrc/{source}", "replaces": line,
                "launches": launched, "max_abs_err": err, "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None}

    nerf_tpu = "nerf_tpu/ops/pallas/"
    kernels = [row("fused_render_fwd", "fused_render_fwd.cu",
                   f"{nerf_tpu}fused_render.py:222", launches,
                   checks[("bfloat16", 192)],
                   max(c["err"] for c in checks.values()))]
    for name, line, launched in (
            ("fused_render_train", 315, trained["train_launches"]),
            ("fused_render_bwd", 242, trained["bwd_launches"])):
        kernels.append(row(name, "fused_render_train.cu",
                           f"{nerf_tpu}fused_render.py:{line}", launched,
                           grad_checks[(name, "bfloat16", 192)],
                           max(v["err"] for k, v in grad_checks.items()
                               if k[0] == name)))
    for name, source, line, launched in (
            ("fused_render_siren_fwd", "fused_render_siren_fwd.cu", 60,
             siren_launches),
            ("fused_render_siren_train", "fused_render_siren_train.cu", 110,
             siren_trained["train_launches"]),
            ("fused_render_siren_bwd", "fused_render_siren_train.cu", 82,
             siren_trained["bwd_launches"])):
        kernels.append(row(name, source, f"{nerf_tpu}fused_render_siren.py:{line}",
                           launched, siren_checks[(name, "bfloat16")],
                           max(siren_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched in (
            ("fused_render_gabor_fwd", 166, gabor_launches),
            ("fused_render_gabor_train", 186, gabor_trained["train_launches"])):
        kernels.append(row(name, f"{name}.cu", f"{nerf_tpu}fused_render_gabor.py:{line}",
                           launched, gabor_checks[(name, "bfloat16")],
                           max(gabor_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched in (
            ("fused_kilonerf_fwd", 367, kilo_launches + kilo_trained["fwd_launches"]),
            ("fused_kilonerf_bwd", 394, kilo_trained["bwd_launches"])):
        kernels.append(row(name, f"{name}.cu", f"{nerf_tpu}fused_kilonerf.py:{line}",
                           launched, kilo_checks[(name, "bfloat16")],
                           max(kilo_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
