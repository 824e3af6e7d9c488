#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero with no result:

  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. the build of every kernel from the sources in the checkout, timed;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it (8192 rays x 64 and 192 samples,
     hidden 256, float32 and bfloat16; TF32 off): max abs errors against
     stated tolerances, median times in turns (plain, kernel, kernel,
     plain), the least time the card could take, and the share reached;
  4. serving: a synthetic 400x400 Blender scene, the configs/lego.txt model
     (full width, hierarchical 64+128, bfloat16) initialised from a seed and
     saved as a checkpoint, RenderService on cuda behind the HTTP server on
     loopback, four requests (/health, /pose/0, /pose/1, /render?m=...).
     Each image request must give a 400x400 PNG and launch the fused render
     kernel exactly 2 x ceil(160000/8192) = 40 times; one served image is
     held against the unfused PyTorch render of the same request.

The last lines are a JSON object of per-kernel numbers, the card, and
``{"ok": true, "device": {...}}``. Needs a CUDA device and this checkout;
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


def bound_ms(num_rays: int, s: int, cdt: str, weight_bytes: int) -> tuple:
    flops = 2 * mlp_macs(256, 63, 27) * num_rays * s
    nbytes = (3 * num_rays * 3 * 4 + num_rays * s * 4 + weight_bytes
              + num_rays * 3 * 4 + 2 * num_rays * 4 + num_rays * s * 4)
    t_ops = flops / PEAK_FLOPS[cdt] * 1e3
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
            g = torch.Generator(device=dev).manual_seed(1000 + s)
            # cameras on a radius-4 sphere looking at the scene, as an orbit
            cam = torch.nn.functional.normalize(
                torch.randn(R_CHECK, 3, generator=g, device=dev), dim=-1) * 4.0
            look = torch.randn(R_CHECK, 3, generator=g, device=dev) * 0.3 - cam
            rays_d = torch.nn.functional.normalize(look, dim=-1)
            rays_o = cam
            t = torch.sort(2.0 + 4.0 * torch.rand(R_CHECK, s, generator=g,
                                                  device=dev), dim=-1).values
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
            bms, by = bound_ms(R_CHECK, s, cdt, weight_bytes)
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


def serve(torch, dev, tmp: str):
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.registry import model_from_config
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.serve import RenderService, make_http_server, request_seed
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import make_eval_render
    from nerf_tpu_torch.utils.checkpoint import save_checkpoint
    from nerf_tpu_torch.utils.png import decode_png

    scene = os.path.join(tmp, "scene")
    write_sphere_scene(scene, HW)
    cfg = parse_config_file(os.path.join(ROOT, "configs", "lego.txt"))
    cfg = dataclasses.replace(cfg, dataset_path=scene,
                              save_path=os.path.join(tmp, "models"))
    gen = torch.Generator().manual_seed(cfg.seed)
    model = model_from_config(cfg, generator=gen)
    fine = model_from_config(cfg, generator=gen)
    ckpt = save_checkpoint(model, fine, cfg.save_path, cfg.model_type, 0)
    svc = RenderService.from_checkpoint(cfg, ckpt, device=dev, log=say)
    if svc.hw != (HW, HW):
        fail(f"service hw {svc.hw}")
    per_image = 2 * math.ceil(HW * HW / cfg.chunk_size)

    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    m = ",".join(str(x) for x in svc.orbit_pose(5)[:3].reshape(-1))
    images, times = {}, []
    FusedNerfRender.launches = 0        # the main path's count starts here
    try:
        code, ctype, body = get(base + "/health")
        health = json.loads(body)
        if code != 200 or health["status"] != "ok" or health["hw"] != [HW, HW]:
            fail(f"/health: {code} {health}")
        for route in ("/pose/0", "/pose/1", f"/render?m={m}"):
            before = FusedNerfRender.launches
            t0 = time.perf_counter()
            code, ctype, body = get(base + route)
            dt = time.perf_counter() - t0
            n = FusedNerfRender.launches - before
            if code != 200 or ctype != "image/png" or body[:8] != b"\x89PNG\r\n\x1a\n":
                fail(f"{route}: status {code}, type {ctype}")
            img = decode_png(body)
            if img.shape != (HW, HW, 3):
                fail(f"{route}: image shape {img.shape}")
            if n != per_image:
                fail(f"{route}: {n} fused render launches, want {per_image}")
            images[route.split("?")[0]] = img
            times.append(dt)
            say(f"serve {route.split('?')[0]}: 200 image/png {HW}x{HW}, "
                f"{n} kernel launches, {dt * 1e3:.1f} ms, "
                f"{HW * HW / dt:.0f} rays/s")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = FusedNerfRender.launches
    if launches != 3 * per_image:
        fail(f"main path launched the kernel {launches} times")

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
        fail("unfused reference render is not finite")
    diff = np.abs(images["/pose/1"].astype(np.float32) / 255.0 - ref)
    say(f"serve /pose/1 vs unfused render: mean abs {diff.mean():.3e} "
        f"(tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}")
    if diff.mean() > SERVE_TOL_MEAN:
        fail("served image disagrees with the unfused render")
    med = statistics.median(times)
    say(f"serve: {med * 1e3:.1f} ms per {HW}x{HW} request (median of "
        f"{len(times)}), {HW * HW / med:.0f} rays/s, {per_image} launches "
        f"per request, model lego.txt ({cfg.compute_dtype}, "
        f"{cfg.num_samples}+{cfg.num_fine_samples})")
    profile_request(torch, svc)
    return launches


def profile_request(torch, svc) -> None:
    """Where one request's time goes: a torch.profiler trace of a direct
    render_pose call (after the launch count was read), its device busy
    share and the fused render kernel's share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.render_pose(svc.orbit_pose(2), key_idx=2)
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
    fused = sum(e.time_range.elapsed_us() for e in dev_events
                if "fused_render_fwd" in e.name)
    other = sum(e.time_range.elapsed_us() for e in dev_events
                if "fused_render_fwd" not in e.name)
    say(f"profile: one request {wall_us / 1e3:.1f} ms wall; device busy "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.4f} of wall, idle "
        f"{1 - busy / wall_us:.4f}); fused_render_fwd {fused / 1e3:.1f} ms "
        f"({fused / wall_us:.4f}), other kernels {other / 1e3:.1f} ms in "
        f"{len(dev_events) - sum('fused_render_fwd' in e.name for e in dev_events)} "
        "launches")


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
        from nerf_tpu_torch.ops.cuda import fused_render
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
    info = fused_render.build()
    say(f"build: fused_render_fwd in {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")

    checks = check_kernel(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve(torch, dev, tmp)

    main_shape = checks[("bfloat16", 192)]
    kernels = [{
        "name": "fused_render_fwd",
        "route": "cuda",
        "source": "nerf_tpu_torch/csrc/fused_render_fwd.cu",
        "replaces": "nerf_tpu/ops/pallas/fused_render.py:222",
        "launches": launches,
        "max_abs_err": max(c["err"] for c in checks.values()),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }]
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
