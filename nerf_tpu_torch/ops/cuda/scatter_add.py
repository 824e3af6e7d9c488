"""Exact, deterministic row scatter-add by id, in a CUDA kernel.

``scatter_add_rows(ids, vals, num_rows)`` is ``zeros((num_rows, C)).at[ids]
.add(vals)`` of ``nerf_tpu/ops/pallas/scatter_add.py`` (C <= 32; ids outside
[0, num_rows) skipped). The kernel library (``csrc/scatter_add.cu``, which
replaces ``_scatter_kernel``) sorts the ids itself (a stable radix sort over
``radix_plan(num_rows)``'s bits), builds a row pointer and gives each output
row to one group of lanes, which sums its value rows in their input order
(runs longer than a chunk as pieces, joined in order): every output row
written once, zeros included, no float atomics, the same bits on every run.
In the port it is the grid gradient of ``ops/interp.py::trilinear``'s
backward.

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


def radix_plan(num_rows: int) -> tuple[int, int]:
    """``(passes, digit_bits)`` of the kernel's LSD radix sort: its keys are
    the row ids and ``num_rows`` (the key of skipped ids), so it sorts
    ``num_rows.bit_length()`` bits in passes of at most 8 bits, split
    evenly (3 passes of 8 bits at 128^3 rows, 2 of 7 at 5,000)."""
    bits = max(1, int(num_rows).bit_length())
    passes = -(-bits // 8)
    return passes, -(-bits // passes)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("scatter_add")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scatter_add.argtypes = [vp, ci, vp, cl, ci, ci, ci, ci, vp, vp, vp]
    lib.scatter_add.restype = ci
    lib.scatter_add_workspace.argtypes = [cl, ci, ci, ci, ci]
    lib.scatter_add_workspace.restype = cl
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
    m = ids.shape[0]
    ids, vals = ids.contiguous(), vals.contiguous()
    lib = _library()
    passes, bits = radix_plan(num_rows)
    ws_bytes = lib.scatter_add_workspace(m, c, num_rows, passes, bits)
    if ws_bytes <= 0:
        raise ValueError(f"scatter-add of {m} rows into {num_rows}: "
                         + lib.scatter_add_error(-1).decode())
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=vals.device)
    out = torch.empty((num_rows, c), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.scatter_add(ids.data_ptr(), int(ids.dtype == torch.int64), vals.data_ptr(),
                               m, c, num_rows, passes, bits, ws.data_ptr(), out.data_ptr(),
                               stream)
    if code != 0:
        raise RuntimeError("scatter-add kernel: " + lib.scatter_add_error(code).decode())
    ScatterKernel.launches += 1
    return out
