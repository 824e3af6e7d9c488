"""Typed configuration, reading the same ``key = value`` files as ``nerf_tpu``.

A line-oriented text file with ``#`` comments feeds a typed dataclass:
unknown keys warn, malformed lines warn, known keys are cast once. The
fields and defaults are those of ``nerf_tpu.config.Config``, so every file
under ``configs/`` parses to the same values in both packages. Fields that
only the JAX package acts on (mesh, Pallas tiles, optimizer knobs of a
slice not yet ported) are kept so that a shared config file stays valid.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass


def parse_kv_file(path: str) -> dict[str, str]:
    """Parse ``key = value`` lines; ``#`` starts a comment (full-line or
    inline). Lines without ``=`` warn and are skipped; values stay strings."""
    out: dict[str, str] = {}
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                print(f"Warning: Invalid line in config file: {line}", file=sys.stderr)
                continue
            key, value = line.split("=", maxsplit=1)
            out[key.strip()] = value.strip()
    return out


def _as_bool(s: str) -> bool:
    return str(s).strip().lower() in ("true", "1", "yes", "on")


@dataclass
class Config:
    """All knobs for training and rendering (see ``nerf_tpu.config.Config``
    for the meaning of each; the two dataclasses carry the same fields)."""

    # --- dataset ---
    dataset_path: str = "./datasets/lego"
    dataset_type: str = "blender"  # "blender" | "llff"
    white_background: bool = True
    half_res: bool = False
    llff_factor: int = 8
    ndc: bool = True

    # --- sampling ---
    num_random_rays: int = 1024
    chunk_size: int = 8192
    eval_chunk_size: int = 0       # ray tile for full-image renders; 0 = chunk_size
    num_samples: int = 256
    num_fine_samples: int = 0      # >0 enables hierarchical coarse/fine
    perturb: bool = True
    jitter_mode: str = "per_ray"   # "per_ray" | "shared"
    fine_sampling: str = "merge"   # "merge" | "resample"

    # --- training ---
    num_iters: int = 150000
    learning_rate: float = 5e-4
    near: float = 2.0
    far: float = 6.0
    lr_decay: float = 150.0        # in units of 1000 steps
    lr_decay_factor: float = 0.1
    lr_min: float = 1e-5
    seed: int = 42
    tv_lambda: float = 0.0
    tv_sh_lambda: float = 0.0
    upsample_steps: str = ""
    distill_from: str = ""
    distill_steps: int = 0
    distill_batch: int = 16384
    occupancy_res: int = 0
    occupancy_interval: int = 1000
    occupancy_thresh: float = 1e-2

    # --- checkpointing ---
    save_path: str = "./models"
    save_interval: int = 5000

    # --- monitoring ---
    log_interval: int = 10
    val_interval: int = 1000
    first_step_render: bool = False
    log_dir: str = "./logs"

    # --- model ---
    model_type: str = "nerf"
    hidden_dim: int = 256
    pos_encoding_dim: int = 10
    dir_encoding_dim: int = 4
    separate_fine_model: bool = True
    grid_res: int = 0
    reference_init: bool = False
    scene_bound: float = 1.5

    # --- eval ---
    num_render_poses: int = 40

    # --- performance ---
    compute_dtype: str = "float32"   # "float32" | "bfloat16" matmul inputs
    use_pallas: bool = True          # false: render through the unfused
                                     # module path instead of the fused
                                     # render kernel
    steps_per_call: int = 0
    mesh_shape: str = ""
    multihost: bool = False
    epoch_sampling: bool = False
    donate_state: bool = True
    debug_nans: bool = False
    profile_dir: str = ""

    def __post_init__(self) -> None:
        self.model_type = self.model_type.lower()

    @property
    def lr_schedule_gamma(self) -> float:
        """Per-step decay: gamma = factor ** (1/(lr_decay*1000))."""
        return float(self.lr_decay_factor) ** (1.0 / (float(self.lr_decay) * 1000.0))


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def config_from_dict(d: dict[str, str], warn_unknown: bool = True) -> Config:
    kwargs = {}
    for key, value in d.items():
        f = _FIELDS.get(key)
        if f is None:
            if warn_unknown:
                print(f"Warning: Unknown config key: {key}", file=sys.stderr)
            continue
        if f.type in ("bool", bool):
            kwargs[key] = _as_bool(value)
        elif f.type in ("int", int):
            kwargs[key] = int(float(value))
        elif f.type in ("float", float):
            kwargs[key] = float(value)
        else:
            kwargs[key] = str(value)
    return Config(**kwargs)


def parse_config_file(path: str) -> Config:
    return config_from_dict(parse_kv_file(path))


def parse_config(path: str) -> dict[str, str]:
    """The raw string dict of a config file."""
    return parse_kv_file(path)
