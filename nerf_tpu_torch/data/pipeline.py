"""Device-resident data pipeline, as ``nerf_tpu.data.pipeline``.

The whole ray pool is copied to the device once; a training step draws a
uniform batch with ``torch.randint`` from a ``torch.Generator`` and gathers
it there, so steps never touch the host. ``epoch_sampling`` draws without
replacement instead: position ``p`` of epoch ``e`` maps to ray
``cipher_e(p)``, a 4-round balanced Feistel network over [0, M) with
cycle-walking, whose four round keys derive from (seed, epoch). The cipher
core takes the round keys as given, so a test can hand it the JAX
package's keys; the keys the port draws itself differ from JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from nerf_tpu_torch.data.blender import load_blender
from nerf_tpu_torch.data.llff import load_llff
from nerf_tpu_torch.data.rays import compute_rays
from nerf_tpu_torch.ops.ndc import ndc_rays

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 tensors holding uint32 values (the
    product of two 32-bit values overflows int64, so multiply in 16-bit
    halves)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def feistel_permute(round_keys, x: torch.Tensor, domain: int) -> torch.Tensor:
    """The exact pseudorandom permutation of [0, domain) of
    ``nerf_tpu.data.pipeline._feistel_permute``, applied elementwise to the
    integer tensor ``x``, with the four 32-bit round keys given."""
    nb = max(2, (max(domain - 1, 1)).bit_length())
    nb += nb % 2
    half = nb // 2
    mask = (1 << half) - 1
    rks = [int(k) & _M32 for k in round_keys]

    def feistel(v):
        left, right = v >> half, v & mask
        for r in range(4):
            f = _mul32(right ^ rks[r], 0x9E3779B1)
            f = f ^ (f >> 15)
            f = _mul32(f, 0x85EBCA6B)
            f = f ^ (f >> 13)
            left, right = right, left ^ (f & mask)
        return (left << half) | right

    v = feistel(x.to(torch.int64) & _M32)
    while bool((v >= domain).any()):
        v = torch.where(v >= domain, feistel(v), v)
    return v


def epoch_round_keys(seed: int, epoch: int) -> list[int]:
    """Four 32-bit round keys of one epoch's cipher, from (seed, epoch)."""
    ss = np.random.SeedSequence([int(seed) & _M32, 0x7FFFFFFF, int(epoch)])
    return [int(k) for k in ss.generate_state(4, dtype=np.uint32)]


def epoch_indices(keys_of_epoch, step: int, batch_size: int,
                  pool_size: int, device=None) -> torch.Tensor:
    """Ray indices of training step ``step`` under without-replacement
    sampling: linear position ``p = step*batch + i`` lies in epoch
    ``p // pool_size`` at offset ``p % pool_size``; each epoch permutes the
    offsets with its own cipher (``keys_of_epoch(e)`` gives its four round
    keys). A batch straddling an epoch boundary wraps into the next
    epoch's permutation."""
    if batch_size > pool_size:
        raise ValueError(
            f"epoch_sampling needs batch_size ({batch_size}) <= pool size "
            f"({pool_size}): a batch may straddle at most two epochs")
    pos = int(step) * batch_size + torch.arange(batch_size, dtype=torch.int64,
                                                device=device)
    epoch = pos // pool_size
    offset = pos % pool_size
    e0 = int(step) * batch_size // pool_size
    idx0 = feistel_permute(keys_of_epoch(e0), offset, pool_size)
    idx1 = feistel_permute(keys_of_epoch(e0 + 1), offset, pool_size)
    return torch.where(epoch > e0, idx1, idx0)


class RayBatch(NamedTuple):
    rays_o: torch.Tensor    # (B, 3)
    rays_d: torch.Tensor    # (B, 3)
    rgb: torch.Tensor       # (B, 3) target pixels
    viewdirs: torch.Tensor  # (B, 3) unit view directions


class RayPool(NamedTuple):
    """Flattened ray pool in device memory."""

    rays_o: torch.Tensor    # (M, 3)
    rays_d: torch.Tensor    # (M, 3)
    rgb: torch.Tensor       # (M, 3)
    viewdirs: torch.Tensor  # (M, 3)

    @property
    def size(self) -> int:
        return self.rays_o.shape[0]

    def sample(self, generator: torch.Generator, batch_size: int) -> RayBatch:
        """Uniform batch with replacement, drawn on the pool's device."""
        idx = torch.randint(0, self.size, (batch_size,), generator=generator,
                            device=self.rays_o.device)
        return self._take(idx)

    def sample_epoch(self, seed: int, step: int, batch_size: int) -> RayBatch:
        """Without-replacement batch (see ``epoch_indices``); ``seed`` is the
        same every step (the epoch, not the step, reseeds the cipher)."""
        idx = epoch_indices(lambda e: epoch_round_keys(seed, e), step,
                            batch_size, self.size, device=self.rays_o.device)
        return self._take(idx)

    def _take(self, idx: torch.Tensor) -> RayBatch:
        return RayBatch(*(x.index_select(0, idx) for x in self))


def build_ray_pool(rays_o: np.ndarray, rays_d: np.ndarray, rgb: np.ndarray,
                   viewdirs: Optional[np.ndarray] = None,
                   device: str | torch.device = "cpu") -> RayPool:
    """Flatten (N, HW, 3) host arrays into a pool on ``device``;
    ``viewdirs`` defaults to ``rays_d`` normalised."""
    def flat(x):
        return np.ascontiguousarray(x.reshape(-1, 3), dtype=np.float32)

    rays_o, rays_d, rgb = flat(rays_o), flat(rays_d), flat(rgb)
    viewdirs = rays_d if viewdirs is None else flat(viewdirs)
    viewdirs = viewdirs / np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    return RayPool(*(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
                     for x in (rays_o, rays_d, rgb, viewdirs)))


@dataclass
class Scene:
    """Everything the trainer needs for one scene."""

    pool: RayPool                 # training rays on the device
    val_images: np.ndarray        # (Nv, H, W, 3)
    val_c2w: np.ndarray           # (Nv, 4, 4)
    focal: float
    hw: tuple[int, int]
    near: float
    far: float
    white_background: bool
    ndc: bool = False
    render_poses: Optional[np.ndarray] = None  # eval path (LLFF spiral)
    name: str = "scene"


def load_scene(cfg, device: str | torch.device = "cpu") -> Scene:
    """The dataset a ``Config`` names, its ray pool on ``device``: a Blender
    scene, or an LLFF scene (``cfg.llff_factor``), whose pool holds NDC rays
    with t in [0, 1] and the pre-warp world directions as ``viewdirs`` when
    ``cfg.ndc``, else world rays over the scene's depth bounds; an LLFF
    scene validates on its test split, over black."""
    name = cfg.dataset_path.rstrip("/").split("/")[-1]
    if cfg.dataset_type == "blender":
        images, c2w, focal = load_blender(cfg.dataset_path, mode="train",
                                          white_background=cfg.white_background,
                                          half_res=cfg.half_res)
        val_images, val_c2w, val_focal = load_blender(
            cfg.dataset_path, mode="val", white_background=cfg.white_background,
            half_res=cfg.half_res)
        rays_o, rays_d, rgb = compute_rays(images, c2w, focal)
        return Scene(pool=build_ray_pool(rays_o, rays_d, rgb, device=device),
                     val_images=val_images, val_c2w=val_c2w, focal=val_focal,
                     hw=(images.shape[1], images.shape[2]), near=cfg.near,
                     far=cfg.far, white_background=cfg.white_background, name=name)

    if cfg.dataset_type == "llff":
        data = load_llff(cfg.dataset_path, factor=cfg.llff_factor)
        images, poses = data["images"], data["poses"]
        h, w = data["hw"]
        focal = data["focal"]
        i_train, i_test = data["i_train"], data["i_test"]
        c2w44 = np.tile(np.eye(4, dtype=np.float32), (poses.shape[0], 1, 1))
        c2w44[:, :3, :4] = poses
        rays_o, rays_d, rgb = compute_rays(images, c2w44, focal)
        if cfg.ndc:
            world_d = rays_d[i_train]
            o_ndc, d_ndc = ndc_rays(h, w, focal, 1.0, torch.from_numpy(rays_o[i_train]),
                                    torch.from_numpy(world_d))
            pool = build_ray_pool(o_ndc.numpy(), d_ndc.numpy(), rgb[i_train],
                                  viewdirs=world_d, device=device)
            near, far = 0.0, 1.0
        else:
            pool = build_ray_pool(rays_o[i_train], rays_d[i_train], rgb[i_train],
                                  device=device)
            near, far = data["near_world"], data["far_world"]
        return Scene(pool=pool, val_images=images[i_test], val_c2w=c2w44[i_test],
                     focal=focal, hw=(h, w), near=near, far=far,
                     white_background=False, ndc=cfg.ndc,
                     render_poses=data["render_poses"], name=name)

    raise ValueError(f"Unknown dataset_type: {cfg.dataset_type}")
