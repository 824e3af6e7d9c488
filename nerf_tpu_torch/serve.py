"""Serving: load a checkpoint once, render many poses.

Counterpart of ``nerf_tpu.serve``. ``RenderService`` owns the full-image
renderer (the fused render kernel on the card; the field kernels for
KiloNeRF; the fused grid render for Plenoxels, over rays in 8x8 pixel
blocks), optionally guided by an occupancy prior baked once at start-up
(``--occupancy``), optionally from an MLP-free cache baked once at start-up
(``--bake``: a FastNeRF or PlenOctree checkpoint, rendered through the
fused grid render's factor or SH form), and renders arbitrary camera
poses (an LLFF scene's through NDC rays with ``cfg.ndc``, the pre-warp
world directions as view directions); ``serve_http`` wraps a service in a
stdlib threaded HTTP server:

    GET /health            -> {"status": "ok", ...}
    GET /pose/<idx>        -> PNG of orbit pose idx (LLFF: the spiral's)
    GET /render?m=<12 or 16 comma-separated floats, row-major c2w>  -> PNG

Requests serialise through one lock (a render fills the card); the
threads overlap only PNG encoding and socket IO. Each request draws its
randomness from a generator seeded by ``(cfg.seed, key_idx)``, so the same
request gives the same image.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional

import numpy as np
import torch

from nerf_tpu_torch.config import Config, parse_config_file
from nerf_tpu_torch.data.blender import load_blender
from nerf_tpu_torch.data.llff import load_llff
from nerf_tpu_torch.data.poses import spherical_orbit
from nerf_tpu_torch.data.rays import compute_rays_single
from nerf_tpu_torch.models.registry import model_from_config
from nerf_tpu_torch.ops.ndc import ndc_rays
from nerf_tpu_torch.train.loop import render_settings_from_config
from nerf_tpu_torch.train.step import fused_field_for, make_eval_render, packed_field
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, read_metadata
from nerf_tpu_torch.utils.device import resolve_device
from nerf_tpu_torch.utils.png import encode_png


def build_renderer(model, fine_model, cfg: Config, settings, bake: int = 0,
                   occupancy: int = 0, log=print, devices: Optional[list] = None):
    """The renderer behind ``RenderService``, as nerf_tpu's
    ``build_renderer``: ``(renderer, render_params)``, called as
    ``renderer(*render_params, rays_o, rays_d, generator, viewdirs=...)``.
    With ``occupancy = R`` an R^3 occupancy prior is baked first, from the
    fine model of a hierarchical config (else the model), through the field
    of ``fused_field_for`` (the NeRF, SIREN or GaborNet field kernels at
    hidden 256 on the card; a grid family's module), over
    ``grid_domain(cfg)``; the renderer's coarse pass then samples from it
    (``renderer.occupancy``). With ``bake = R`` the same model (the fine
    one of a hierarchical config) is baked into its R^3 cache, which then
    renders both passes: a FastNeRF into a ``BakedFastNeRF``, a PlenOctree
    into a Plenoxels model whose render-time copy is made here, once; any
    other family raises ``ValueError``. ``devices`` splits each image's
    tiles over those devices (``make_eval_render``)."""
    src = fine_model if cfg.num_fine_samples > 0 and fine_model is not None else model
    if bake and not hasattr(src, "bake"):
        raise ValueError(f"bake: model '{cfg.model_type}' has no baked cache "
                         "(fastnerf and plenoctree bake)")
    occ = None
    if occupancy:
        from nerf_tpu_torch.models.registry import grid_domain
        from nerf_tpu_torch.ops.occupancy import (
            OccupancyGrid,
            bake_occupancy,
            sigma_field,
        )

        log(f"Baking a {occupancy}^3 occupancy prior...")
        field = packed_field(fused_field_for(src)) if cfg.use_pallas else src
        dom = grid_domain(cfg)
        occ = OccupancyGrid(
            grid=bake_occupancy(sigma_field(field), grid_res=occupancy, domain=dom,
                                device=next(src.parameters()).device),
            domain=dom)
    if not bake:
        renderer = make_eval_render(model, settings, fused=cfg.use_pallas, occupancy=occ,
                                    devices=devices)
        return renderer, (model, fine_model)
    log(f"Baking {cfg.model_type} field into a {bake}^3 cache...")
    baked = src.bake(grid_res=bake)
    params = baked.precompute() if hasattr(baked, "precompute") else baked
    renderer = make_eval_render(baked, settings, fused=cfg.use_pallas, occupancy=occ,
                                devices=devices)
    return renderer, (params, None)


def checkpoint_config(config, checkpoint: str) -> Config:
    """``config`` (a config file path or a ``Config``, not modified) with
    the checkpoint's ``model_type`` and ``grid_res`` from its metadata (a
    grid may have been upsampled mid-training): the configuration that the
    service and the eval CLI build their models from."""
    cfg = (dataclasses.replace(config) if isinstance(config, Config)
           else parse_config_file(config))
    meta = read_metadata(checkpoint)
    cfg.model_type = meta.get("model_type", cfg.model_type).lower()
    cfg.grid_res = int(meta.get("grid_res", cfg.grid_res))
    return cfg


def request_seed(seed: int, key_idx: int) -> int:
    """One 63-bit generator seed per (config seed, request key)."""
    state = np.random.SeedSequence([int(seed), int(key_idx)]).generate_state(2)
    return (int(state[0]) << 31) ^ int(state[1])


class RenderService:
    """Novel-view rendering from a checkpoint.

    >>> svc = RenderService.from_checkpoint("cfg.txt", "./models/nerf_model_300000")
    >>> img = svc.render_pose(c2w)           # (H, W, 3) float32 in [0, 1]
    """

    def __init__(self, cfg: Config, renderer, render_params, hw, focal: float,
                 device: torch.device, ndc: bool = False,
                 render_poses: Optional[np.ndarray] = None):
        self.cfg = cfg
        self._renderer = renderer
        self.params = render_params
        self.hw = hw
        self.focal = float(focal)
        self.device = device
        self.ndc = ndc
        # LLFF: the loader's forward-facing spiral (a radius-4 orbit would
        # look away from the cameras)
        self.render_poses = render_poses
        self._lock = threading.Lock()   # one render on the card at a time

    @classmethod
    def from_checkpoint(cls, config, checkpoint: str, bake: int = 0,
                        occupancy: int = 0, hw: Optional[tuple] = None,
                        device: str | torch.device = "cuda",
                        log=print, devices: Optional[list] = None) -> "RenderService":
        """``config`` is a config file path or a ``Config``; the dataset
        supplies H/W/focal (override with ``hw``): a Blender scene's first
        test frame, or an LLFF scene (``load_llff``), which also gives the
        spiral poses and the sampling interval (NDC's [0, 1] with
        ``cfg.ndc``, else its depth bounds), set before the models are
        built. ``devices`` splits each image's tiles over them, the models
        on ``device`` and a replica on each other device."""
        dev = resolve_device(device)
        cfg = checkpoint_config(config, checkpoint)
        render_poses = None
        if cfg.dataset_type == "llff":
            data = load_llff(cfg.dataset_path, factor=cfg.llff_factor)
            h, w = data["hw"]
            focal = data["focal"]
            ndc = cfg.ndc
            render_poses = np.asarray(data["render_poses"])
            cfg.near, cfg.far = ((0.0, 1.0) if ndc else
                                 (float(data["near_world"]), float(data["far_world"])))
        else:
            images, _, focal = load_blender(
                cfg.dataset_path, mode="test", single_image=True,
                white_background=cfg.white_background, half_res=cfg.half_res)
            h, w = images.shape[1:3]
            ndc = False
        if hw is not None:
            focal = focal * hw[1] / w   # same field of view
            h, w = hw

        state = load_checkpoint(checkpoint)
        model = model_from_config(cfg)
        model.load_state_dict(state["params"])
        fine_model = None
        if state["fine_params"]:
            fine_model = model_from_config(cfg)
            fine_model.load_state_dict(state["fine_params"])
            fine_model = fine_model.to(dev).eval()
        model = model.to(dev).eval()
        settings = render_settings_from_config(cfg, ndc=ndc)
        renderer, render_params = build_renderer(
            model, fine_model, cfg, settings, bake=bake, occupancy=occupancy, log=log,
            devices=devices)
        log(f"Loaded {cfg.model_type} from {checkpoint} on {dev} "
            f"({int(h)}x{int(w)}, {cfg.compute_dtype}{', NDC' if ndc else ''})")
        return cls(cfg, renderer, render_params, (int(h), int(w)), focal, dev, ndc=ndc,
                   render_poses=render_poses)

    def render_pose(self, c2w, key_idx: int = 0) -> np.ndarray:
        """Render one camera pose (c2w: (3|4, 4) world-from-camera) ->
        (H, W, 3) float32 in [0, 1]."""
        h, w = self.hw
        m = np.eye(4, dtype=np.float32)
        c2w = np.asarray(c2w, np.float32)
        m[: c2w.shape[0]] = c2w
        rays_o, rays_d = compute_rays_single(h, w, self.focal, m)
        rays_o, rays_d = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
        viewdirs = None
        if self.ndc:
            viewdirs = rays_d.to(self.device)
            rays_o, rays_d = ndc_rays(h, w, self.focal, 1.0, rays_o, rays_d)
        rays_o, rays_d = rays_o.to(self.device), rays_d.to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(request_seed(self.cfg.seed, key_idx))
        with self._lock:
            out = self._renderer(*self.params, rays_o, rays_d, gen, viewdirs=viewdirs,
                                 hw=(h, w))
            img = out.rgb.reshape(h, w, 3).cpu().numpy()
        return np.clip(img, 0.0, 1.0)

    def orbit_pose(self, idx: int) -> np.ndarray:
        """Pose ``idx`` of the eval path: an LLFF scene's spiral, else the
        spherical orbit of ``num_render_poses``."""
        if self.render_poses is not None:
            return self.render_poses[idx % len(self.render_poses)]
        poses = spherical_orbit(self.cfg.num_render_poses)
        return poses[idx % len(poses)]


def _png_bytes(img01: np.ndarray) -> bytes:
    return encode_png((img01 * 255).astype(np.uint8))


def serve_http(service: RenderService, port: int = 8000,
               host: str = "127.0.0.1", log=print):
    """Blocking threaded HTTP server over a ``RenderService`` (routes in the
    module docstring); returns on KeyboardInterrupt. Binds loopback by
    default: the endpoint is unauthenticated."""
    server = make_http_server(service, port, host)
    log(f"Serving {service.cfg.model_type} renders on "
        f"{host or '0.0.0.0'}:{server.server_address[1]} "
        "(/health, /pose/<i>, /render?m=...)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()


def make_http_server(service: RenderService, port: int = 0,
                     host: str = "127.0.0.1"):
    """The HTTP server, not yet started (run ``serve_forever`` on a thread)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # request parsing -> 400; render/encode failures -> 500 (a
            # device error is not the client's fault)
            try:
                url = urlparse(self.path)
                if url.path == "/health":
                    h, w = service.hw
                    body = json.dumps({
                        "status": "ok",
                        "model_type": service.cfg.model_type,
                        "hw": [h, w],
                        "device": str(service.device),
                    }).encode()
                    return self._send(200, body, "application/json")
                if url.path.startswith("/pose/"):
                    idx = int(url.path.split("/")[-1])
                    c2w, key_idx = service.orbit_pose(idx), idx
                elif url.path == "/render":
                    q = parse_qs(url.query)
                    vals = [float(x) for x in q["m"][0].split(",")]
                    if len(vals) not in (12, 16):
                        raise ValueError("m wants 12 or 16 floats")
                    c2w, key_idx = np.asarray(vals, np.float32).reshape(-1, 4), 0
                else:
                    return self._send(404, b"not found", "text/plain")
            except Exception as e:  # noqa: BLE001 — malformed request
                return self._send(
                    400, f"{type(e).__name__}: {e}".encode(), "text/plain")
            try:
                img = service.render_pose(c2w, key_idx=key_idx)
                return self._send(200, _png_bytes(img), "image/png")
            except Exception:  # noqa: BLE001 — server-side failure
                import traceback

                traceback.print_exc()
                return self._send(500, b"render failed", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    """``nerf-tpu-torch-serve --config cfg.txt --checkpoint ckpt [--port 8000]
    [--occupancy RES] [--bake RES] [--hw H W] [--device cuda|cpu]``"""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default loopback; the endpoint "
                             "is unauthenticated, widen deliberately)")
    parser.add_argument("--occupancy", type=int, default=0,
                        help="bake a RES^3 occupancy prior and sample the coarse "
                             "pass from it (0: off)")
    parser.add_argument("--bake", type=int, default=0,
                        help="bake a fastnerf / plenoctree checkpoint into a RES^3 "
                             "MLP-free cache and serve that (0: off)")
    parser.add_argument("--hw", type=int, nargs=2, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card raises")
    args = parser.parse_args(argv)

    svc = RenderService.from_checkpoint(
        args.config, args.checkpoint, bake=args.bake, occupancy=args.occupancy,
        hw=tuple(args.hw) if args.hw else None, device=args.device)
    svc.render_pose(svc.orbit_pose(0))   # build the kernel before traffic
    serve_http(svc, port=args.port, host=args.host)


if __name__ == "__main__":
    main()
