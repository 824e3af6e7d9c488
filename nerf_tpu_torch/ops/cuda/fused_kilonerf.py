"""KiloNeRF field evaluation and its parameter gradient in CUDA kernels.

Two kernels, each replacing one of ``nerf_tpu/ops/pallas/fused_kilonerf.py``
(their sources say what bounds each on an H100 and how the design answers):

  * ``_fwd_kernel_mx``: every point through its voxel's tiny MLP, over
    points sorted by network, read through the sort order and written in
    point order; in bfloat16 on the tensor cores
    (``csrc/fused_kilonerf_fwd_tc.cu``), in float32 on the CUDA cores
    (``csrc/fused_kilonerf_fwd.cu``);
  * ``_bwd_kernel_mk``: each network's weight and bias gradients from the
    (rgb, sigma) cotangent of its points, summed without atomics (per-run
    partials added in order); in bfloat16 on the tensor cores
    (``csrc/fused_kilonerf_bwd_tc.cu``: row 15's chain recomputes the
    forward, the payload and the cotangent read through the sort order),
    in float32 on the CUDA cores (``csrc/fused_kilonerf_bwd.cu``).

This module holds

  * the dispatch glue, stock PyTorch as in the JAX package (outside its
    kernels too): ``voxel_of``, one stable sort by network carrying the
    point index, segment offsets (``bincount`` + ``cumsum``) and the (n, 8)
    payload in point order. The forward kernels and the bfloat16 backward
    read it through the sort (the forwards write their output in point
    order), so they run no gather; the float32 backward, which reads a
    sorted payload and a sorted cotangent, gathers both by the sort order
    when it runs;
  * ``pack_f32`` / ``cast_packed``: the parameters as one (G^3, R) block
    per network, differentiable float32 (autograd maps the kernel's packed
    gradient back onto each layer's ``w``/``b``) and cast whole to the
    compute dtype as the TPU kernel casts its block, biases included;
  * the plain PyTorch versions ``kilonerf_fwd_plain`` and
    ``kilonerf_bwd_plain`` (batched matmuls over tiles of one network's
    points; outputs and cotangents in point order), with the kernels'
    arithmetic and rounding: matmul inputs
    rounded to the compute dtype, float32 sums, the density from the
    unrounded x2 and the rounded density row, the cosine as sin(x + pi/2);
  * ``KiloNeRFField``: the field ``(points, dirs) -> (rgb, sigma)`` of one
    ``KiloNeRFModel``. On CPU tensors it runs the plain versions; on CUDA
    tensors it launches the kernels or raises. It never falls back from one
    to the other. With the model's parameters requiring grad it is
    differentiable in them (the backward kernel behind a
    ``torch.autograd.Function``); ``launches`` and ``bwd_launches`` count
    the kernels' launches over all instances.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from functools import cached_property

import torch

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.models.kilonerf import (
    LAYERS,
    KiloNeRFModel,
    dispatch_plan_sorted,
    pad_rows,
)
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.fused_render import _encode

FWD_RUN = 128       # points per forward CTA (csrc/fused_kilonerf_fwd{,_tc}.cu)
BWD_RUN = 512       # points per backward run (csrc/fused_kilonerf_bwd{,_tc}.cu)
PLAIN_TILE = 128    # points per tile of the plain versions' batched matmuls
HIDDEN, PMAX, DMAX = 32, 64, 32   # the widths the kernels take


def layer_shapes(h: int, p: int, d: int) -> list[tuple[str, tuple]]:
    """``(name, per-network shape)`` of every parameter in packed order."""
    return [("l1.w", (p, h)), ("l1.b", (h,)), ("l2.w", (h, h)), ("l2.b", (h,)),
            ("trunk.w", (h, h + 1)), ("trunk.b", (h + 1,)),
            ("rgb1.w", (h + d, h)), ("rgb1.b", (h,)),
            ("rgb2.w", (h, 3)), ("rgb2.b", (3,))]


def pack_f32(model: KiloNeRFModel) -> torch.Tensor:
    """(G^3, R) float32: each network's parameters in the packed order,
    differentiable."""
    g = model.num_networks
    parts = []
    for name in LAYERS:
        lyr = model.layer(name)
        parts += [lyr.w.reshape(g, -1), lyr.b]
    return torch.cat(parts, dim=1).float()


def cast_packed(wpack: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """The packing as the kernels read it: the whole block in ``cdt``."""
    return wpack.detach().to(cdt).contiguous()


def unpack(wpack: torch.Tensor, h: int, p: int, d: int) -> dict:
    """Views (G^3, *shape) of a packed block, by parameter name."""
    out, off = {}, 0
    for name, shape in layer_shapes(h, p, d):
        n = math.prod(shape)
        out[name] = wpack[:, off:off + n].reshape(wpack.shape[0], *shape)
        off += n
    return out


@dataclass(frozen=True)
class Dispatch:
    """Points sorted by network: ``order`` (n,) the stable sort, ``pay``
    the (n, 8) payload in point order (cols 0-2 voxel-local position, 4-6
    direction), ``counts`` (G^3,) points per network and ``offsets``
    (G^3 + 1,) int32 segment starts in sorted order."""

    order: torch.Tensor
    pay: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor

    @property
    def n(self) -> int:
        return self.order.shape[0]

    @cached_property
    def sorted_pay(self) -> torch.Tensor:
        """The payload in sorted order, made on first use: the float32
        backward kernel and the plain versions read it; the forward kernels
        and the bfloat16 backward do not."""
        return self.pay[self.order].contiguous()


@torch.no_grad()
def dispatch(model: KiloNeRFModel, points: torch.Tensor, dirs: torch.Tensor) -> Dispatch:
    """The dispatch glue of ``make_fused_kilonerf_apply``'s ``apply``:
    points (n, 3) in the renderer's normalised space and unit dirs (n, 3)."""
    n = points.shape[0]
    vid, local = model.voxel_of(points.float())
    order = torch.sort(vid, stable=True).indices
    pay = torch.zeros((n, 8), dtype=torch.float32, device=points.device)
    pay[:, :3] = local
    pay[:, 4:7] = dirs
    counts = torch.bincount(vid, minlength=model.num_networks)
    offsets = torch.zeros(model.num_networks + 1, dtype=torch.int32, device=points.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return Dispatch(order=order, pay=pay, counts=counts, offsets=offsets)


def run_end(counts: torch.Tensor, run: int) -> torch.Tensor:
    """int32 running count of ``run``-point runs over the networks (a CTA's
    run: ``csrc/fused_kilonerf_common.cuh::find_run``)."""
    return torch.cumsum(torch.div(counts + run - 1, run, rounding_mode="floor"),
                        0).to(torch.int32)


def run_plan(counts: torch.Tensor, n: int, run: int) -> tuple:
    """``(run_end, ctas)`` of a kernel over ``n`` points in runs of ``run``
    points of one network: the running count of runs, and a grid that
    covers any placement of the points (ceil(n / run) full runs plus one
    ragged run a network), so that no count is read back to the host; CTAs
    past the last run return at once."""
    return run_end(counts, run), -(-n // run) + counts.shape[0]


# ---------------------------------------------------------------- plain


@dataclass(frozen=True)
class _Tiles:
    gid: torch.Tensor     # (tiles,) network of each tile
    src: torch.Tensor     # (tiles, t) sorted row of each slot, n when empty
    pos: torch.Tensor     # (n,) each sorted row's flat slot


def _tiles(disp: Dispatch, t: int) -> _Tiles:
    g3 = disp.counts.shape[0]
    dev = disp.pay.device
    svid = torch.repeat_interleave(torch.arange(g3, device=dev), disp.counts)
    gid, src, _, counts = dispatch_plan_sorted(svid, g3, t)
    rank = torch.arange(disp.n, device=dev) - disp.offsets[:-1].long()[svid]
    tpg = torch.div(counts + t - 1, t, rounding_mode="floor")
    tstart = torch.cumsum(tpg, 0) - tpg
    pos = (tstart[svid] + torch.div(rank, t, rounding_mode="floor")) * t + rank % t
    return _Tiles(gid=gid, src=src, pos=pos)


def unit_masks(masks: torch.Tensor, h: int) -> tuple:
    """The (..., 4) int32 ReLU masks of ``fused_kilonerf_bwd_tc``'s debug
    output (bit k of columns 0-2: unit k of x1, x2, y on; column 3: sigma
    > 0) as bool tensors (..., h) x 3 and (...,)."""
    bits = torch.arange(h, device=masks.device)
    m = [(masks[..., i, None] >> bits) & 1 == 1 for i in range(3)]
    return (*m, masks[..., 3] != 0)


def _acts(wc: torch.Tensor, disp: Dispatch, tiles: _Tiles, h: int,
          pos_freqs: int, dir_freqs: int, masks: torch.Tensor | None = None) -> dict:
    """Every activation of the kernels' forward in the tile layout
    (tiles, t, width), float32, and the per-tile weights (``"w"``): matmul
    inputs rounded to the packing's dtype as the kernels round them (the
    weights already are), x2 and the density pre-activation unrounded; the
    ReLU masks of x1, x2, y and sigma (``"m1"``, ``"m2"``, ``"my"``,
    ``"msig"``: pre-activation > 0, or the given (n, 4) ``masks`` in point
    order, ``unit_masks``' layout, where a check imposes another forward's)."""
    cdt = wc.dtype
    p, d = 3 * (1 + 2 * pos_freqs), 3 * (1 + 2 * dir_freqs)
    v = {k: x[tiles.gid] for k, x in unpack(wc.float(), h, p, d).items()}
    pay = pad_rows(disp.sorted_pay)[tiles.src]               # (tiles, t, 8)

    def r(x):
        return round_to(x, cdt)

    def b(name):
        return v[name][:, None, :]

    given = None if masks is None else unit_masks(pad_rows(masks[disp.order])[tiles.src], h)

    def act(name, pre):
        m = pre > 0 if given is None else given[("m1", "m2", "my").index(name)]
        a[name] = m
        return torch.where(m, pre, torch.zeros_like(pre))

    a = {"w": v}
    a["penc"] = r(_encode(pay[..., :3], pos_freqs, p, torch.sin))
    a["denc"] = r(_encode(pay[..., 4:7], dir_freqs, d, torch.sin))
    a["x1"] = act("m1", a["penc"] @ v["l1.w"] + b("l1.b"))
    a["x2"] = act("m2", r(a["x1"]) @ v["l2.w"] + b("l2.b"))
    wt, bt = v["trunk.w"], v["trunk.b"]
    a["sigma_pre"] = torch.sum(a["x2"] * wt[:, None, :, h], dim=-1) + bt[:, None, h]
    a["msig"] = a["sigma_pre"] > 0 if given is None else given[3]
    a["feat"] = r(a["x2"]) @ wt[..., :h] + bt[:, None, :h]
    wr1 = v["rgb1.w"]
    a["y"] = act("my", r(a["feat"]) @ wr1[:, :h] + a["denc"] @ wr1[:, h:] + b("rgb1.b"))
    a["rgb"] = torch.sigmoid(r(a["y"]) @ v["rgb2.w"] + b("rgb2.b"))
    return a


def packed_size(h: int, pos_freqs: int, dir_freqs: int) -> int:
    """R, the floats per network of the packing."""
    p, d = 3 * (1 + 2 * pos_freqs), 3 * (1 + 2 * dir_freqs)
    return sum(math.prod(s) for _, s in layer_shapes(h, p, d))


def kilonerf_fwd_plain(wc: torch.Tensor, disp: Dispatch, h: int, pos_freqs: int,
                       dir_freqs: int) -> torch.Tensor:
    """The forward kernels' function in plain PyTorch: the (n, 4) float32
    (rgb, sigma) of the dispatch's points, in point order; ``wc`` the
    packing as ``cast_packed`` gives it, ``h`` the width."""
    tiles = _tiles(disp, PLAIN_TILE)
    a = _acts(wc, disp, tiles, h, pos_freqs, dir_freqs)
    out = torch.cat([a["rgb"], torch.relu(a["sigma_pre"])[..., None]], dim=-1)
    out = out.reshape(-1, 4)[tiles.pos]
    return torch.empty_like(out).index_copy(0, disp.order, out)


def kilonerf_bwd_plain(wc: torch.Tensor, disp: Dispatch, cot: torch.Tensor, h: int,
                       pos_freqs: int, dir_freqs: int,
                       masks: torch.Tensor | None = None) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: the (G^3, R)
    float32 gradient, in the packed layout, of sum(cot * [rgb, sigma]) over
    the points (``cot`` the (n, 4) cotangent in point order). Matrix
    gradients are products of rounded activations and rounded cotangents,
    bias gradients (and the density row's) float32 sums of unrounded ones
    (``_bwd_tile_multi``); networks without points get exact zeros.
    ``masks`` (``_acts``) imposes another forward's ReLU masks."""
    cdt = wc.dtype
    tiles = _tiles(disp, PLAIN_TILE)
    a = _acts(wc, disp, tiles, h, pos_freqs, dir_freqs, masks)
    v = a["w"]
    g = pad_rows(cot[disp.order])[tiles.src]                  # (tiles, t, 4)

    def r(x):
        return round_to(x, cdt)

    def mm_t(x, dz):                  # per tile x^T dz
        return r(x).transpose(1, 2) @ r(dz)

    def colsum(dz):
        return dz.sum(dim=1)

    grads = {}
    rgb = a["rgb"]
    dzr2 = g[..., :3] * rgb * (1.0 - rgb)
    grads["rgb2.w"] = mm_t(a["y"], dzr2)
    grads["rgb2.b"] = colsum(dzr2)
    dzy = (r(dzr2) @ v["rgb2.w"].transpose(1, 2)) * a["my"]
    wr1 = v["rgb1.w"]
    grads["rgb1.w"] = torch.cat([mm_t(a["feat"], dzy), mm_t(a["denc"], dzy)], dim=1)
    grads["rgb1.b"] = colsum(dzy)
    dfeat = r(dzy) @ wr1[:, :h].transpose(1, 2)
    dsig = g[..., 3] * a["msig"]
    wt = v["trunk.w"]
    grads["trunk.w"] = torch.cat(
        [mm_t(a["x2"], dfeat), torch.sum(a["x2"] * dsig[..., None], dim=1)[..., None]],
        dim=2)
    grads["trunk.b"] = torch.cat([colsum(dfeat), dsig.sum(dim=1)[:, None]], dim=1)
    dx2 = r(dfeat) @ wt[..., :h].transpose(1, 2) + dsig[..., None] * wt[:, None, :, h]
    dz2 = dx2 * a["m2"]
    grads["l2.w"] = mm_t(a["x1"], dz2)
    grads["l2.b"] = colsum(dz2)
    dz1 = (r(dz2) @ v["l2.w"].transpose(1, 2)) * a["m1"]
    grads["l1.w"] = mm_t(a["penc"], dz1)
    grads["l1.b"] = colsum(dz1)
    g3 = disp.counts.shape[0]
    p, d = a["penc"].shape[-1], a["denc"].shape[-1]
    out = []
    for name, _ in layer_shapes(h, p, d):
        per_tile = grads[name].reshape(grads[name].shape[0], -1)
        out.append(torch.zeros(g3, per_tile.shape[1], dtype=torch.float32,
                               device=per_tile.device).index_add_(0, tiles.gid, per_tile))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------- libraries


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = library(name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name.startswith("fused_kilonerf_fwd"):
        fn, err = getattr(lib, name), getattr(lib, name + "_error")
        fn.argtypes = [vp] * 4 + [ci, vp] + [ci] * 7 + [vp, vp]
        fn.restype = ci
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
    elif name == "fused_kilonerf_bwd":
        lib.fused_kilonerf_bwd.argtypes = [vp] * 4 + [ci, vp] + [ci] * 8 + [vp] * 3
        lib.fused_kilonerf_bwd.restype = ci
        lib.fused_kilonerf_bwd_error.argtypes = [ci]
        lib.fused_kilonerf_bwd_error.restype = ctypes.c_char_p
        lib.fused_kilonerf_partial_floats.argtypes = []
        lib.fused_kilonerf_partial_floats.restype = ci
    else:
        lib.fused_kilonerf_bwd_tc.argtypes = [vp] * 5 + [ci, vp] + [ci] * 8 + [vp] * 5
        lib.fused_kilonerf_bwd_tc.restype = ci
        lib.fused_kilonerf_bwd_tc_error.argtypes = [ci]
        lib.fused_kilonerf_bwd_tc_error.restype = ctypes.c_char_p
        lib.fused_kilonerf_bwd_tc_partial_floats.argtypes = []
        lib.fused_kilonerf_bwd_tc_partial_floats.restype = ci
    return lib


# ---------------------------------------------------------------- autograd


class _FieldFn(torch.autograd.Function):
    """The field as a function of the float32 packing: (rgb, sigma) in
    point order; its backward is the backward kernel (the plain version on
    the CPU). The points carry no gradient."""

    @staticmethod
    def forward(ctx, wpack, field, disp):
        wc = cast_packed(wpack, field.cdt)
        out = field._forward(wc, disp)
        ctx.field, ctx.disp, ctx.wc = field, disp, wc
        return out[:, :3], out[:, 3]

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        disp = ctx.disp
        cot = torch.zeros((disp.n, 4), dtype=torch.float32, device=disp.pay.device)
        if g_rgb is not None:
            cot[:, :3] = g_rgb
        if g_sigma is not None:
            cot[:, 3] = g_sigma
        return ctx.field._backward(ctx.wc, disp, cot), None, None


# ---------------------------------------------------------------- wrapper


class KiloNeRFField:
    """The field ``(points (..., 3), dirs (..., 3)) -> (rgb (..., 3), sigma
    (...,))`` of ``model`` through the grouped kernels (the counterpart of
    ``make_fused_kilonerf_apply``'s ``apply``). ``packed`` fixes the
    weights (a ``cast_packed`` block, no gradient), as a render of one image
    or a distillation teacher wants; otherwise each call packs the model's
    current parameters and, under autograd, gives them their gradient."""

    launches = 0
    bwd_launches = 0

    def __init__(self, model: KiloNeRFModel, packed: torch.Tensor | None = None):
        self.model = model
        self.cdt = model.cdt
        self.h = model.hidden_dim
        self.pos_freqs = model.pos_encoding_dim
        self.dir_freqs = model.dir_encoding_dim
        self.real_p = 3 * (1 + 2 * self.pos_freqs)
        self.real_d = 3 * (1 + 2 * self.dir_freqs)
        self.packed = packed

    def pack(self) -> "KiloNeRFField":
        """This field with the model's current weights packed once."""
        with torch.no_grad():
            return KiloNeRFField(self.model, cast_packed(pack_f32(self.model), self.cdt))

    def fwd_library(self) -> str:
        """The forward's kernel library: bfloat16 on the tensor cores,
        float32 on the CUDA cores."""
        return "fused_kilonerf_fwd_tc" if self.cdt == torch.bfloat16 else "fused_kilonerf_fwd"

    def bwd_library(self) -> str:
        """The backward's kernel library: bfloat16 on the tensor cores,
        float32 on the CUDA cores."""
        return "fused_kilonerf_bwd_tc" if self.cdt == torch.bfloat16 else "fused_kilonerf_bwd"

    def _bwd_entry(self):
        """(function, error string, partial floats) of the backward: the
        tensor-core entry reads the point-order payload and cotangent
        through the sort order, the CUDA-core one sorted copies."""
        name = self.bwd_library()
        lib = _library(name)
        floats = ("fused_kilonerf_bwd_tc_partial_floats" if name.endswith("_tc")
                  else "fused_kilonerf_partial_floats")
        return getattr(lib, name), getattr(lib, name + "_error"), getattr(lib, floats)

    def supported(self) -> bool:
        """The widths the kernels cover: hidden 32, encodings of at most
        64 / 32 columns (L <= 10 / 4)."""
        return self.h == HIDDEN and self.real_p <= PMAX and self.real_d <= DMAX

    def __call__(self, points: torch.Tensor, dirs: torch.Tensor):
        shape = points.shape[:-1]
        disp = dispatch(self.model, points.reshape(-1, 3), dirs.reshape(-1, 3).float())
        if self.packed is None and torch.is_grad_enabled() and any(
                p.requires_grad for p in self.model.parameters()):
            rgb, sigma = _FieldFn.apply(pack_f32(self.model), self, disp)
        else:
            wc = self.packed
            if wc is None:
                with torch.no_grad():
                    wc = cast_packed(pack_f32(self.model), self.cdt)
            out = self._forward(wc, disp)
            rgb, sigma = out[:, :3], out[:, 3]
        return rgb.reshape(*shape, 3), sigma.reshape(shape)

    # -- routes: the plain versions for CPU tensors, the kernels for CUDA

    def _route(self, x: torch.Tensor) -> str:
        if x.device.type in ("cpu", "cuda"):
            return x.device.type
        raise ValueError(f"KiloNeRF field runs on cuda or cpu, not {x.device}")

    def _forward(self, wc: torch.Tensor, disp: Dispatch) -> torch.Tensor:
        if self._route(disp.pay) == "cpu":
            return kilonerf_fwd_plain(wc, disp, self.h, self.pos_freqs, self.dir_freqs)
        return self._launch_fwd(wc, disp)

    def _backward(self, wc: torch.Tensor, disp: Dispatch, cot: torch.Tensor) -> torch.Tensor:
        if self._route(disp.pay) == "cpu":
            return kilonerf_bwd_plain(wc, disp, cot, self.h, self.pos_freqs, self.dir_freqs)
        return self._launch_bwd(wc, disp, cot)

    def _check(self, wc: torch.Tensor, disp: Dispatch) -> None:
        if not self.supported():
            raise NotImplementedError(
                f"the KiloNeRF field kernels cover hidden {HIDDEN} with encodings of "
                f"at most {PMAX}/{DMAX} columns; got hidden {self.h}, "
                f"{self.real_p}/{self.real_d} (run on the CPU, or with "
                "use_pallas = false)")
        dev = disp.pay.device
        g3 = self.model.num_networks
        r = packed_size(self.h, self.pos_freqs, self.dir_freqs)
        if (wc.device != dev or wc.dtype != self.cdt or tuple(wc.shape) != (g3, r)
                or not wc.is_contiguous()):
            raise ValueError(f"packed weights: want contiguous {self.cdt} {(g3, r)} on "
                             f"{dev}, got {wc.dtype} {tuple(wc.shape)} on {wc.device}")

    def _launch_fwd(self, wc: torch.Tensor, disp: Dispatch) -> torch.Tensor:
        self._check(wc, disp)
        n = disp.n
        out = torch.empty((n, 4), dtype=torch.float32, device=disp.pay.device)
        if n == 0:
            return out
        ends, grid = run_plan(disp.counts, n, FWD_RUN)
        name = self.fwd_library()
        lib = _library(name)
        with torch.cuda.device(disp.pay.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = getattr(lib, name)(
                disp.pay.data_ptr(), disp.order.data_ptr(), disp.offsets.data_ptr(),
                ends.data_ptr(), self.model.num_networks, wc.data_ptr(), wc.shape[1],
                self.real_p, self.real_d, self.h, n, FWD_RUN, grid, out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("KiloNeRF forward kernel: "
                               + getattr(lib, name + "_error")(code).decode())
        type(self).launches += 1
        return out

    def _launch_bwd(self, wc: torch.Tensor, disp: Dispatch, cot: torch.Tensor,
                    rec: torch.Tensor | None = None,
                    masks: torch.Tensor | None = None) -> torch.Tensor:
        """The backward kernel's (G^3, R) gradient. ``rec`` (float32) and
        ``masks`` (int32), (n, 4) tensors that only a check passes (the
        bfloat16 kernel only), get the (rgb, sigma) the kernel recomputes and
        its ReLU masks (``unit_masks``), in point order."""
        self._check(wc, disp)
        n, g3 = disp.n, self.model.num_networks
        if tuple(cot.shape) != (n, 4) or cot.dtype != torch.float32 or \
                cot.device != disp.pay.device:
            raise ValueError(f"cotangent: want float32 {(n, 4)} on {disp.pay.device}, "
                             f"got {cot.dtype} {tuple(cot.shape)} on {cot.device}")
        out = torch.zeros((g3, wc.shape[1]), dtype=torch.float32, device=cot.device)
        if n == 0:
            return out
        tc = self.bwd_library().endswith("_tc")
        for what, x, dtype in (("rec", rec, torch.float32), ("masks", masks, torch.int32)):
            if x is not None and (not tc or tuple(x.shape) != (n, 4) or x.dtype != dtype
                                  or x.device != cot.device or not x.is_contiguous()):
                raise ValueError(f"{what}: the bfloat16 kernel's contiguous {dtype} (n, 4) "
                                 f"on {cot.device} only")
        fn, err, floats = self._bwd_entry()
        ends, grid = run_plan(disp.counts, n, BWD_RUN)
        partial = torch.empty((grid, floats()), dtype=torch.float32, device=cot.device)
        with torch.cuda.device(cot.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tc:
                # the payload and the cotangent read through the sort order
                cot = cot.contiguous()
                code = fn(
                    disp.pay.data_ptr(), disp.order.data_ptr(), cot.data_ptr(),
                    disp.offsets.data_ptr(), ends.data_ptr(), g3, wc.data_ptr(),
                    wc.shape[1], self.real_p, self.real_d, self.h, 1, n, BWD_RUN, grid,
                    partial.data_ptr(), out.data_ptr(),
                    *(None if x is None else x.data_ptr() for x in (rec, masks)), stream)
            else:
                cot = cot[disp.order].contiguous()
                code = fn(
                    disp.sorted_pay.data_ptr(), cot.data_ptr(), disp.offsets.data_ptr(),
                    ends.data_ptr(), g3, wc.data_ptr(), wc.shape[1], self.real_p,
                    self.real_d, self.h, 0, n, BWD_RUN, grid, partial.data_ptr(),
                    out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("KiloNeRF backward kernel: " + err(code).decode())
        type(self).bwd_launches += 1
        return out
