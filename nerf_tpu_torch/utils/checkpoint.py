"""Checkpoint save and restore with ``torch.save``.

A checkpoint is one file ``{save_path}/{model_type}_model_{step:06d}``
holding ``{step, model_type, params, fine_params}`` (state dicts; an empty
dict when there is no separate fine model) and, for a training state,
``train_step`` (the state's step counter) and ``optimizer`` (Adam's count
and moments), beside a ``.meta.json`` sidecar with the step, the model
type and, for a family that has one (KiloNeRF), ``grid_res``, as
``nerf_tpu.utils.checkpoint`` lays them out; resume, serving and a
distillation teacher read the family and ``grid_res`` back from it.
Serving reads only the models. A multi-scene run writes one payload of all
its scenes, each tensor stacked along a leading scene axis
(``scenes_payload``), with ``num_scenes``, ``scenes`` and
``base_model_type`` in its sidecar. The file is written under a temporary name and renamed, so a
checkpoint that exists is complete. ``AsyncCheckpointSaver`` copies the
tensors to the CPU and writes on a thread while training goes on.
Checkpoints of the JAX package (Orbax directories) are not read here.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Optional

import torch

_CKPT_RE = re.compile(r"^(?P<model>[a-z0-9_]+)_model_(?P<step>\d{6,})$")


def _state_path(save_path: str, model_type: str, step: int) -> str:
    return os.path.join(os.path.abspath(save_path), f"{model_type}_model_{step:06d}")


def _cpu_state(module) -> dict:
    if module is None:
        return {}
    # a copy even for CPU tensors: an async save must not see later updates
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def _write(payload: dict, save_path: str, model_type: str, step: int,
           extra: Optional[dict] = None) -> str:
    path = _state_path(save_path, model_type, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {"step": int(step), "model_type": model_type}
    if "grid_res" in payload:
        meta["grid_res"] = payload["grid_res"]
    meta.update(extra or {})
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def _payload(model, fine_model, model_type: str, step: int, optimizer=None,
             train_step: Optional[int] = None) -> dict:
    out = {"step": int(step), "model_type": model_type,
           "params": _cpu_state(model), "fine_params": _cpu_state(fine_model)}
    if hasattr(model, "grid_res"):
        out["grid_res"] = int(model.grid_res)
    if optimizer is not None:
        out["optimizer"] = optimizer.state_dict()
        out["train_step"] = int(train_step)
    return out


def save_checkpoint(model, fine_model, save_path: str, model_type: str,
                    step: int, optimizer=None,
                    train_step: Optional[int] = None) -> str:
    """Save ``model`` (and ``fine_model``, or None) at ``step``, with the
    optimizer state and the train state's step counter when given; returns
    the checkpoint path."""
    return _write(_payload(model, fine_model, model_type, step, optimizer,
                           train_step), save_path, model_type, step)


def save_payload(payload: dict, save_path: str, model_type: str, step: int,
                 extra: Optional[dict] = None) -> str:
    """Write a payload (``scenes_payload``) with ``extra`` metadata;
    returns the checkpoint path."""
    return _write(payload, save_path, model_type, step, extra)


def save_train_state(state, save_path: str, model_type: str, step: int) -> str:
    """Save a whole ``TrainState`` (models, optimizer, step counter) under
    the loop's ``step``."""
    return _write(train_payload(state, model_type, step), save_path, model_type, step)


def restore_train_state(state, path: str):
    """Load a checkpoint written by ``save_train_state`` into ``state`` in
    place (models, optimizer, step counter); returns ``state``."""
    return restore_payload(state, load_checkpoint(path), path)


def restore_payload(state, ckpt: dict, what: str):
    """``restore_train_state`` from a loaded payload (``what`` names it in
    errors)."""
    if "optimizer" not in ckpt:
        raise ValueError(f"{what} holds models only, not a training state")
    state.params.load_state_dict(ckpt["params"])
    if state.fine_params is not None:
        state.fine_params.load_state_dict(ckpt["fine_params"])
    elif ckpt["fine_params"]:
        raise ValueError(f"{what} has a fine model; this state has none")
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["train_step"])
    return state


def train_payload(state, model_type: str, step: int) -> dict:
    """What ``save_train_state`` writes, on the CPU."""
    return _payload(state.params, state.fine_params, model_type, step,
                    state.optimizer, state.step)


def scenes_payload(parts: list) -> dict:
    """One payload of several scenes' ``train_payload``s (a multi-scene run,
    in scene order), as ``nerf_tpu``'s scene-stacked state: every tensor
    stacked along a leading scene axis (the Adam counts and step counters,
    equal across scenes, stay scalars)."""
    def stack(key):
        return {k: torch.stack([p[key][k] for p in parts]) for k in parts[0][key]}

    out = dict(parts[0], params=stack("params"), fine_params=stack("fine_params"),
               num_scenes=len(parts))
    out["optimizer"] = {"count": parts[0]["optimizer"]["count"],
                        **{m: [torch.stack(xs) for xs in
                               zip(*(p["optimizer"][m] for p in parts))]
                           for m in ("mu", "nu")}}
    return out


def restore_scene(state, ckpt: dict, scene: int):
    """Scene ``scene`` of a ``scenes_payload`` (as ``load_checkpoint`` gives
    it) into ``state`` in place; returns ``state``."""
    opt = ckpt["optimizer"]
    restore_payload(state, {
        "params": {k: v[scene] for k, v in ckpt["params"].items()},
        "fine_params": {k: v[scene] for k, v in ckpt["fine_params"].items()},
        "optimizer": {"count": opt["count"], "mu": [x[scene] for x in opt["mu"]],
                      "nu": [x[scene] for x in opt["nu"]]},
        "train_step": ckpt["train_step"]}, "a multi-scene checkpoint")
    return state


class AsyncCheckpointSaver:
    """Interval saves that overlap with training: ``save`` copies the state
    to the CPU (so training may go on changing it) and writes the file on a
    thread; a second save first waits for the one in flight. Call ``wait``
    before the final save and before exit; it re-raises a failed write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state, save_path: str, model_type: str, step: int) -> str:
        return self.save_payload(train_payload(state, model_type, step), save_path,
                                 model_type, step)

    def save_payload(self, payload: dict, save_path: str, model_type: str, step: int,
                     extra: Optional[dict] = None) -> str:
        """``save`` of a payload already on the CPU (``scenes_payload``),
        with ``extra`` metadata."""
        self.wait()

        def run():
            try:
                _write(payload, save_path, model_type, step, extra)
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return _state_path(save_path, model_type, step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_checkpoint(path: str) -> dict:
    """The dict ``save_checkpoint`` wrote, tensors on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def read_metadata(path: str) -> dict:
    path = os.path.abspath(path)
    # the sidecar is written after the checkpoint itself; a sidecar whose
    # checkpoint is missing is left over from an interrupted save
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no committed checkpoint at {path} (an orphaned .meta.json from "
            "an interrupted save does not count)")
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no checkpoint metadata for {path}")
    with open(meta_path, "r") as f:
        return json.load(f)


def latest_checkpoint(save_path: str,
                      model_type: Optional[str] = None) -> Optional[str]:
    """Most recent checkpoint under ``save_path`` (optionally of one model
    type), or None."""
    save_path = os.path.abspath(save_path)
    if not os.path.isdir(save_path):
        return None
    best: tuple[int, str] | None = None
    for name in os.listdir(save_path):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        if model_type is not None and m.group("model") != model_type:
            continue
        step = int(m.group("step"))
        if best is None or step > best[0]:
            best = (step, name)
    return os.path.join(save_path, best[1]) if best else None
