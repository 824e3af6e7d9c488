"""The build of the port's kernel libraries.

Every CUDA source under the package's ``csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, in
``build/`` beside the package, on the first CUDA call: one ``nvcc`` per
source, all started together. The NeRF, SIREN and GaborNet libraries are
also compiled at the other shapes they take (``nerf_plan.py``,
``siren_plan.py``, ``gabor_plan.py``), each on the first launch at that
shape, with the shape in its file name beside the hash. The families'
modules load their libraries with ``library`` and declare their C
signatures there.
"""

from __future__ import annotations

import atexit
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
# one library per .cu source: the NeRF, SIREN and GaborNet forward renders
# and train passes (each in bfloat16 on the tensor cores; NeRF and SIREN
# with the render backward), the KiloNeRF, NeRF, SIREN and GaborNet field
# forward and backward (each in bfloat16 on the tensor cores too), and the
# voxel grids' interpolation, fused grid render and sorted scatter-add
LIBS = ("fused_render_fwd", "fused_render_fwd_tc", "fused_render_train",
        "fused_render_train_tc",
        "fused_render_siren_fwd", "fused_render_siren_fwd_tc",
        "fused_render_siren_train", "fused_render_siren_train_tc",
        "fused_render_gabor_fwd", "fused_render_gabor_fwd_tc",
        "fused_render_gabor_train", "fused_render_gabor_train_tc",
        "fused_kilonerf_fwd", "fused_kilonerf_fwd_tc", "fused_kilonerf_bwd",
        "fused_kilonerf_bwd_tc",
        "fused_nerf_fwd", "fused_nerf_fwd_tc", "fused_nerf_bwd", "fused_nerf_bwd_tc",
        "fused_siren_fwd", "fused_siren_fwd_tc", "fused_siren_bwd", "fused_siren_bwd_tc",
        "fused_gabor_fwd", "fused_gabor_fwd_tc", "fused_gabor_bwd", "fused_gabor_bwd_tc",
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


def _digest(flags: tuple) -> str:
    """The hash of every source in ``csrc/`` and of the flags: a change to a
    shared header rebuilds every library."""
    sources = sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for p in sources:
        h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()[:16]


# builds started and not yet waited for: (name, defines) -> (process,
# temporary output, output, log file, start time)
_RUNNING: dict = {}


def _start(jobs: dict, nice: int = 0) -> None:
    """Start one ``nvcc`` for each ``(name, defines)`` of ``jobs`` (its
    output path the value) neither in ``build/`` nor being built, at
    niceness ``nice`` (0: the caller's)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    prefix = ["nice", "-n", str(nice)] if nice and shutil.which("nice") else []
    for (name, defines), out in jobs.items():
        if out.exists() or (name, defines) in _RUNNING:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = out.with_name(f"{out.stem}.{os.getpid()}.log")
        with open(log, "w") as f:   # a file, not a pipe: a build waited for late never blocks
            proc = subprocess.Popen(
                [*prefix, _nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
                 str(_CSRC / f"{name}.cu")], stdout=f, stderr=subprocess.STDOUT)
        _RUNNING[name, defines] = (proc, tmp, out, log, time.perf_counter())


@atexit.register
def _stop() -> None:
    """Kill the builds still running when the process exits."""
    for proc, tmp, _, log, _ in _RUNNING.values():
        proc.kill()
        proc.wait()
        tmp.unlink(missing_ok=True)
        log.unlink(missing_ok=True)
    _RUNNING.clear()


def _compile(jobs: dict) -> dict:
    """Build each ``(name, defines)`` of ``jobs`` (its output path the value)
    not yet in ``build/``: one ``nvcc`` per library, all started together,
    or waited for where ``start_shaped`` started it. Returns their
    ``BuildInfo`` by key (``seconds`` from its start to the wait's end);
    raises ``RuntimeError`` if any build fails."""
    _start(jobs)
    infos, errors = {}, []
    for (name, defines), out in jobs.items():
        if (name, defines) not in _RUNNING:
            infos[name, defines] = BuildInfo(name, out, 0.0, "cached")
            continue
        proc, tmp, out, log_path, t0 = _RUNNING.pop((name, defines))
        proc.wait()
        log = log_path.read_text()
        log_path.unlink()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu {' '.join(defines)} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        infos[name, defines] = BuildInfo(name, out, time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return infos


@functools.cache
def build() -> tuple[BuildInfo, ...]:
    """Compile every kernel library at the default shape into ``build/``:
    one ``nvcc`` per source, all started together. A library's file name
    carries the hash of every source in ``csrc/`` and of the flags."""
    digest = _digest(())
    infos = _compile({(n, ()): _BUILD_DIR / f"{n}-{digest}.so" for n in LIBS})
    return tuple(infos[n, ()] for n in LIBS)


def _shaped_path(name: str, tag: str, defines: tuple) -> Path:
    return _BUILD_DIR / f"{name}-{tag}-{_digest(defines)}.so"


def build_shaped(wanted) -> tuple[BuildInfo, ...]:
    """Compile the libraries ``wanted``, each ``(name, tag, defines)``: one
    of ``LIBS`` at the shape the -D flags ``defines`` set (the NeRF, SIREN
    and GaborNet libraries at another width or depth,
    ``nerf_plan.NerfPlan.defines``, ``siren_plan.SirenPlan.defines``,
    ``gabor_plan.GaborPlan.defines``), named
    with ``tag``; empty ``defines`` name the default build. All are started
    together, with the default shape's libraries if not built yet. Built
    once; each later call finds them in ``build/``."""
    digest = _digest(())
    jobs = {(n, ()): _BUILD_DIR / f"{n}-{digest}.so" for n in LIBS}
    jobs.update({(n, d): _shaped_path(n, t, d) for n, t, d in wanted if d})
    infos = _compile(jobs)
    return tuple(infos[n, d] for n, _, d in wanted)


def start_shaped(wanted, nice: int = 0) -> None:
    """Start the builds of ``wanted`` (``build_shaped``'s jobs; the default
    shape's are left out) at niceness ``nice`` and return at once: a later
    ``build_shaped`` or ``library`` call at those shapes waits for them,
    and those still running when the process exits are killed. With
    ``nice`` > 0 the libraries wanted first (``build()``, started after)
    take the CPU from them."""
    _start({(n, d): _shaped_path(n, t, d) for n, t, d in wanted if d}, nice)


@functools.cache
def library(name: str, tag: str = "", defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library ``name`` (one of ``LIBS``), at the default shape
    (building them all first if needed) or, with ``defines``, at the shape
    they set (``build_shaped``)."""
    if not defines:
        return ctypes.CDLL(str({b.name: b.path for b in build()}[name]))
    return ctypes.CDLL(str(build_shaped(((name, tag, defines),))[0].path))
