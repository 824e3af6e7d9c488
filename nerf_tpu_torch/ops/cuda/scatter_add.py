"""Exact, deterministic row scatter-add by id, in a CUDA kernel.

``scatter_add_rows(ids, vals, num_rows)`` is ``zeros((num_rows, C)).at[ids]
.add(vals)`` of ``nerf_tpu/ops/pallas/scatter_add.py`` (C <= 32). The
wrapper sorts the ids once (a stable ``torch.sort``, as nerf_tpu sorts with
``lax.sort_key_val`` outside its kernel); the kernel
(``csrc/scatter_add.cu``, which replaces ``_scatter_kernel``) sums each run
of equal ids in a fixed order, reading the values through the sort
permutation, and writes each touched row once: no float atomics, the same
bits on every run. In the port it is the grid gradient of
``ops/interp.py::trilinear``'s backward.

On CPU tensors the plain version runs (the sort and a segment sum in
PyTorch); on CUDA tensors the kernel launches or the call raises, never
the plain version. ``index_add_`` is no plain version: on the card its
order varies from run to run. ``ScatterKernel.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_tpu_torch.ops.cuda.build import library

LANES = 32          # channels the kernel covers


class ScatterKernel:
    """Launch count of ``csrc/scatter_add.cu`` over all calls."""

    launches = 0


def _check(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> None:
    if ids.dim() != 1 or vals.dim() != 2 or ids.shape[0] != vals.shape[0]:
        raise ValueError(f"ids (M,) and vals (M, C) wanted, got {tuple(ids.shape)} and "
                         f"{tuple(vals.shape)}")
    if vals.dtype != torch.float32 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"float32 values and int32/int64 ids wanted, got {vals.dtype}, "
                         f"{ids.dtype}")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, values on {vals.device}")
    if num_rows < 1 or num_rows >= 2 ** 31:
        raise ValueError(f"num_rows {num_rows} out of range")


def scatter_add_plain(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a stable sort of the ids and
    a segment sum of the sorted rows (each run summed in order)."""
    _check(ids, vals, num_rows)
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    if ids.shape[0] == 0:
        return out
    sid, perm = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(sid, return_counts=True)
    out[uniq] = torch.segment_reduce(vals[perm], "sum", lengths=counts, axis=0)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("scatter_add")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scatter_add_sorted.argtypes = [vp, vp, vp, cl, ci, ci, vp, vp, vp, vp]
    lib.scatter_add_sorted.restype = ci
    lib.scatter_add_chunk.argtypes = []
    lib.scatter_add_chunk.restype = ci
    lib.scatter_add_error.argtypes = [ci]
    lib.scatter_add_error.restype = ctypes.c_char_p
    return lib


def scatter_add_rows(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``(num_rows, C)`` float32: the sum of the rows of ``vals`` (M, C) by
    their ``ids`` (M,) in [0, num_rows). The plain version for CPU tensors,
    the kernel for CUDA tensors (``NotImplementedError`` for C > 32)."""
    _check(ids, vals, num_rows)
    if vals.device.type == "cpu":
        return scatter_add_plain(ids, vals, num_rows)
    if vals.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cuda or cpu, not {vals.device}")
    c = vals.shape[1]
    if not 1 <= c <= LANES:
        raise NotImplementedError(
            f"the scatter-add kernel (PERF.md row 19, scatter_add.py::_scatter_kernel) "
            f"covers 1..{LANES} channels, got {c}")
    out = torch.zeros((num_rows, c), dtype=torch.float32, device=vals.device)
    m = ids.shape[0]
    if m == 0:
        return out
    sid, perm = torch.sort(ids.to(torch.int32), stable=True)
    vals = vals.contiguous()
    lib = _library()
    chunks = -(-m // lib.scatter_add_chunk())
    head = torch.empty((chunks, c), dtype=torch.float32, device=vals.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.scatter_add_sorted(sid.data_ptr(), perm.data_ptr(), vals.data_ptr(), m, c,
                                      num_rows, head.data_ptr(), tail.data_ptr(),
                                      out.data_ptr(), stream)
    if code != 0:
        raise RuntimeError("scatter-add kernel: " + lib.scatter_add_error(code).decode())
    ScatterKernel.launches += 1
    return out
