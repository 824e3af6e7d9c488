"""Tracing and throughput, as ``nerf_tpu.utils.profiling``.

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (CPU
  and, where there is a card, CUDA activity), written as a Chrome trace
  ``{logdir}/trace.json`` and returned as the profiler object.
- ``Throughput``: a rays/s counter with a warm-up skip and an ``exclude``
  window for host work that is not training (validation, saves).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block: ``with trace('./logs/profile') as prof:
    step()``; ``prof.key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class Throughput:
    """Streaming rays/s counter. Call ``update(num_rays)`` once per step or
    chunk; read ``rays_per_sec``. The first ``warmup`` updates (kernel
    builds, allocator growth) are skipped. Wrap host work that is not
    training in ``with throughput.exclude():``."""

    warmup: int = 2
    _steps: int = 0
    _rays: int = 0
    _t0: float = field(default=0.0)
    _excluded: float = field(default=0.0)

    def update(self, num_rays: int) -> None:
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = time.perf_counter()
            self._rays = 0
            self._excluded = 0.0
        elif self._steps > self.warmup:
            self._rays += num_rays

    @contextlib.contextmanager
    def exclude(self):
        """Stop the clock for the enclosed block."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if self._steps >= self.warmup:
                self._excluded += time.perf_counter() - t

    @property
    def rays_per_sec(self) -> float:
        if self._steps <= self.warmup or self._t0 == 0.0:
            return 0.0
        dt = time.perf_counter() - self._t0 - self._excluded
        return self._rays / dt if dt > 0 else 0.0
