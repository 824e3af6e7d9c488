"""The build of the port's kernel libraries.

Every CUDA source under the package's ``csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, in
``build/`` beside the package, on the first CUDA call: one ``nvcc`` per
source, all started together. The families' modules load their libraries
with ``library`` and declare their C signatures there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
# one library per .cu source: the NeRF, SIREN and GaborNet forward renders,
# their train passes (NeRF and SIREN with the render backward), the
# KiloNeRF, NeRF, SIREN and GaborNet field forward and backward, and the
# voxel grids' interpolation, fused grid render and sorted scatter-add
LIBS = ("fused_render_fwd", "fused_render_train",
        "fused_render_siren_fwd", "fused_render_siren_train",
        "fused_render_gabor_fwd", "fused_render_gabor_train",
        "fused_kilonerf_fwd", "fused_kilonerf_bwd",
        "fused_nerf_fwd", "fused_nerf_bwd",
        "fused_siren_fwd", "fused_siren_bwd",
        "fused_gabor_fwd", "fused_gabor_bwd",
        "fused_grid", "fused_grid_render", "scatter_add")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    name: str
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the kernels are built from source at first use")


@functools.cache
def build() -> tuple[BuildInfo, ...]:
    """Compile every kernel library into ``build/``: one ``nvcc`` per
    source, all started together. A library's file name carries the hash of
    every source in ``csrc/`` and of the flags, so a change to a shared
    header rebuilds them all. Raises ``RuntimeError`` if any build fails."""
    sources = sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode() + p.read_bytes())
    digest = h.hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, infos = {}, {}
    for name in LIBS:
        out = _BUILD_DIR / f"{name}-{digest}.so"
        if out.exists():
            infos[name] = BuildInfo(name, out, 0.0, "cached")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        infos[name] = BuildInfo(name, out, time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return tuple(infos[n] for n in LIBS)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (one of ``LIBS``), building them all
    first if needed."""
    return ctypes.CDLL(str({b.name: b.path for b in build()}[name]))
