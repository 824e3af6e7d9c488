"""Metric logging: the console, TensorBoard event files, a plain log file
and validation PNGs.

The console and file lines are those of ``nerf_tpu.utils.logging``:
``[HH:MM:SS] [Iter 0000000] LR: x MSE: y PSNR: z`` and ``[Validation Step]
Iter n  PSNR: p``. The log directory is ``{log_dir}/{model_type}_{dataset}_
{timestamp}``; it holds ``config.txt``, ``train.log`` (every line, plus every
scalar, unrounded, as ``scalar <tag> <step> <value>``), ``val_{step:07d}.png``
and, with ``enable_tensorboard``, the event file (``utils/events.py``) with
the events the JAX package's logger writes in the same calls: the ``config``
text, the ``loss`` / ``psnr`` / ``learning_rate`` scalars, ``val/psnr`` and
the ``val/render`` image, and every ``log_scalar`` and ``log_image``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np

from nerf_tpu_torch.utils.events import EventWriter
from nerf_tpu_torch.utils.metrics import mse_to_psnr
from nerf_tpu_torch.utils.png import write_png
from nerf_tpu_torch.utils.timer import format_elapsed_time


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, model_type: str = "nerf",
                 dataset_name: str = "scene", config_text: str = "",
                 enable_tensorboard: bool = True, echo=print) -> None:
        self.start_time = datetime.datetime.now()
        self.echo = echo
        self.log_path = None
        self._file = None
        self.writer = None
        if log_dir is not None:
            stamp = self.start_time.strftime("%Y-%m-%d_%H-%M-%S")
            self.log_path = os.path.join(log_dir, f"{model_type}_{dataset_name}_{stamp}")
            os.makedirs(self.log_path, exist_ok=True)
            if config_text:
                with open(os.path.join(self.log_path, "config.txt"), "w") as f:
                    f.write(config_text)
            self._file = open(os.path.join(self.log_path, "train.log"), "a")
            if enable_tensorboard:
                self.writer = EventWriter(self.log_path)
                if config_text:
                    self.writer.add_text("config", config_text)

    def log_train(self, step: int, lr: float, mse: float) -> None:
        psnr = float(mse_to_psnr(float(mse)))
        elapsed = format_elapsed_time(self.start_time)
        self._write(f"[{elapsed}] [Iter {step:07d}] LR: {lr:.6f} "
                    f"MSE: {float(mse):.4f} PSNR: {psnr:.2f}")
        for tag, value in (("loss", mse), ("psnr", psnr), ("learning_rate", lr)):
            self.log_scalar(tag, value, step)

    def log_validation(self, step: int, psnr: float, image: np.ndarray) -> None:
        self._write(f"[Validation Step] Iter {step}  PSNR: {psnr:.2f}")
        self.log_scalar("val/psnr", psnr, step)
        self.log_image("val/render", image, step)
        if self.log_path is not None:
            img = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            write_png(os.path.join(self.log_path, f"val_{step:07d}.png"), img)

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._file is not None:
            self._file.write(f"scalar {tag} {step} {float(value)!r}\n")
            self._file.flush()
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """An (H, W, 3) image in [0, 1] as a TensorBoard image event, clipped
        and moved to CHW as ``nerf_tpu.utils.logging`` does."""
        if self.writer is not None:
            self.writer.add_image(tag, np.clip(image, 0.0, 1.0).transpose(2, 0, 1), step)

    def _write(self, msg: str) -> None:
        if self._file is not None:
            self._file.write(msg + "\n")
            self._file.flush()
        self.echo(msg)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self.writer is not None:
            self.writer.close()
            self.writer = None
