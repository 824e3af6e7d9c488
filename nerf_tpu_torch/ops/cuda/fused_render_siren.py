"""Fused SIREN render, train pass and render backward: raw sample positions,
the 8-layer sine MLP and volume compositing of a (rays, samples) batch, with
their gradients, in CUDA kernels.

Three kernels, each replacing one of
``nerf_tpu/ops/pallas/fused_render_siren.py`` (their sources say what bounds
each on an H100 and how the design answers):

  * the forward render (``_fwd_kernel``): in bfloat16 on the tensor cores
    (``csrc/fused_render_siren_fwd_tc.cu``), in float32
    ``csrc/fused_render_siren_fwd.cu``;
  * the train pass (``_train_kernel``): forward, white-background MSE and
    the full backward in one pass; in bfloat16 on the tensor cores
    (``csrc/fused_render_siren_train_tc.cu``, the forward render's chain in
    ``csrc/fused_render_siren_tc_common.cuh``), in float32 the train entry
    of ``csrc/fused_render_siren_train.cu``;
  * the render backward (``_bwd_kernel``): the parameter gradients of the
    forward render from a per-ray cotangent; in bfloat16 the backward entry
    of ``csrc/fused_render_siren_train_tc.cu`` (the forward render's own
    chain on the tensor cores, so the gradient is taken at the forward the
    render returned), in float32 that of
    ``csrc/fused_render_siren_train.cu``.

This module is the counterpart of ``fused_render_siren.py`` and of the parts
of ``nerf_tpu/ops/pallas/fused_siren.py`` that it uses:

  * ``pack_f32`` / ``cast_packed`` / ``pack_params``: a ``SirenModel`` in the
    kernels' layout (``fused_siren.py::pack_params``: w1 padded to 8 rows,
    the rgb head's first matrix split into wr0f and wr0d, wr0d padded to
    d_pad rows, a multiple of 32 (``siren_plan.d_pad``), wr1/br1 to 8
    columns); ``cast_packed`` rounds the matrices and the density row to
    the compute dtype and keeps the biases float32, as ``_cast_weights``
    does;
  * the plain PyTorch versions ``fused_siren_render_plain``,
    ``fused_siren_train_plain`` and ``fused_siren_render_bwd_plain``,
    rounding at the kernels' points (the backward at
    ``fused_siren.py::_mlp_bwd_core``'s) and using the degree-11 sine in
    bfloat16, so that each matches its kernel in either compute dtype;
  * ``FusedSirenRender``: the wrapper, with the contract and the CPU/CUDA
    routing of ``FusedRender`` (``fused_render.py``), at every shape of
    ``siren_plan.py`` (hidden 256 to 1024, d_pad 32 or 64; each shape its
    own build of the libraries).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.cuda.fused_render import (
    DP,
    FusedRender,
    Packed,
    _composite,
    _composite_bwd,
    _encode,
    _views,
    grad_sizes,
    trig,
)
from nerf_tpu_torch.ops.cuda.siren_plan import NUM_LAYERS, SirenPlan, covered, d_pad, plan

W1_ROWS = 8              # w1's contraction dimension, padded from 3
# Stash bytes a point of the bfloat16 train pass on the tensor cores at
# hidden 256 (csrc/fused_render_siren_train_tc.cu: h1..h8, feat and two dz
# buffers of 256 bf16, y 128, denc 32; h8 and the cosines c1..c8 256 each,
# cr0 128 and 16 per-point columns in float32); its library's
# fused_siren_train_tc_sizes gives the same.
TC_BYTES_PER_POINT = plan(256, DP).tc_bytes_per_point

# The packed matrices and vectors, in buffer order (must match the OFF_*
# tables of csrc/fused_render_siren_common.cuh). Matrices are (in, out).
_MATS = tuple(f"w{i}" for i in range(1, NUM_LAYERS + 1)) + (
    "wre", "wr0f", "wr0d", "wr1")
_VECS = tuple(f"b{i}" for i in range(1, NUM_LAYERS + 1)) + (
    "bre", "ws", "br0", "br1", "bs")


def _shapes(h: int, dp: int = DP) -> tuple[dict, dict]:
    hr = h // 2
    mats = {"w1": (W1_ROWS, h), **{f"w{i}": (h, h) for i in range(2, NUM_LAYERS + 1)},
            "wre": (h, h), "wr0f": (h, hr), "wr0d": (dp, hr), "wr1": (hr, 8)}
    vecs = {**{f"b{i}": (h,) for i in range(1, NUM_LAYERS + 1)}, "bre": (h,),
            "ws": (h,), "br0": (hr,), "br1": (8,), "bs": (1,)}
    return mats, vecs


@dataclass(frozen=True)
class SirenConsts:
    """The scalars of a SIREN that the kernels take besides its weights."""

    dir_freqs: int
    w0: float
    hidden_w0: float
    sigma_mul: float
    rgb_mul: float

    @classmethod
    def of(cls, model) -> "SirenConsts":
        return cls(model.dir_encoding_dim, model.w0, model.hidden_w0,
                   model.sigma_mul, model.rgb_mul)

    @property
    def w0s(self) -> tuple[float, ...]:
        return (self.w0,) + (self.hidden_w0,) * (NUM_LAYERS - 1)


def pack_f32(model) -> tuple[torch.Tensor, torch.Tensor]:
    """``(wflat, vec)``: every matrix and every vector of ``model`` padded
    and split into the kernel layout (wr0d to ``siren_plan.d_pad`` rows),
    float32 and differentiable."""
    h = model.hidden_dim

    def w(lyr):
        return lyr.weight.T

    def pad_rows(x, rows):
        return F.pad(x, (0, 0, 0, rows - x.shape[0]))

    wr0 = w(model.rgb0)
    mats = {
        "w1": pad_rows(w(model.base[0]), W1_ROWS),
        **{f"w{i}": w(model.base[i - 1]) for i in range(2, NUM_LAYERS + 1)},
        "wre": w(model.remap),
        "wr0f": wr0[:h], "wr0d": pad_rows(wr0[h:], d_pad(model.dir_encoding_dim)),
        "wr1": F.pad(w(model.rgb1), (0, 8 - model.rgb1.weight.shape[0])),
    }
    vecs = {
        **{f"b{i}": model.base[i - 1].bias for i in range(1, NUM_LAYERS + 1)},
        "bre": model.remap.bias,
        "ws": model.sigma.weight[0],
        "br0": model.rgb0.bias,
        "br1": F.pad(model.rgb1.bias, (0, 8 - model.rgb1.bias.shape[0])),
        "bs": model.sigma.bias,
    }
    wflat = torch.cat([mats[k].reshape(-1) for k in _MATS]).float()
    vec = torch.cat([vecs[k].reshape(-1) for k in _VECS]).float()
    return wflat, vec


def cast_packed(wflat: torch.Tensor, vec: torch.Tensor, cdt: torch.dtype,
                hidden: int, dp: int = DP) -> Packed:
    """The float32 packing as the kernels read it: matrices in ``cdt``, the
    density row ws rounded to ``cdt`` (biases stay float32); ``dp`` the
    padded direction-encoding width (``siren_plan.d_pad``)."""
    mat_shapes, vec_shapes = _shapes(hidden, dp)
    o = (NUM_LAYERS + 1) * hidden                     # offset of ws
    vec = torch.cat([vec[:o], round_to(vec[o:o + hidden], cdt),
                     vec[o + hidden:]]).contiguous()
    wmat = wflat.to(cdt).contiguous()
    return Packed(wmat=wmat, vec=vec, mats=_views(wmat, mat_shapes, _MATS),
                  vecs=_views(vec, vec_shapes, _VECS), cdt=cdt)


def pack_params(model) -> Packed:
    """``model`` in the kernel layout, cast once to its compute dtype."""
    wflat, vec = pack_f32(model)
    return cast_packed(wflat, vec, model.cdt, model.hidden_dim,
                       d_pad(model.dir_encoding_dim))


def grad_views(gw: torch.Tensor, gv: torch.Tensor, hidden: int, dp: int = DP) -> dict:
    """The 25 gradient tensors of a flat ``(gw, gv)`` pair, by name."""
    mat_shapes, vec_shapes = _shapes(hidden, dp)
    return {**_views(gw, mat_shapes, _MATS), **_views(gv, vec_shapes, _VECS)}


def mlp_acts(packed: Packed, pos: torch.Tensor, denc: torch.Tensor,
             k: SirenConsts) -> dict:
    """Every activation of the kernels' SIREN chain (``fused_siren.py::
    _mlp_tile``) of raw positions ``pos`` (..., 3) and direction encodings
    ``denc`` (..., d_pad) (exact sine), float32: matmul inputs rounded to the
    compute dtype as the kernels round them (the raw positions too), each
    sine layer's argument w0 z, h8 and sigma_pre unrounded, rgb after the
    sigmoid (3 channels)."""
    cdt = packed.cdt
    m = {name: w.float() for name, w in packed.mats.items()}
    v = packed.vecs
    sin, _ = trig(cdt)

    def r(x):
        return round_to(x, cdt)

    a = {"pos": r(pos), "denc": r(denc)}
    x = a["pos"]
    for i, w0 in enumerate(k.w0s, start=1):
        w = m["w1"][:3] if i == 1 else m[f"w{i}"]
        arg = a[f"arg{i}"] = w0 * (x @ w + v[f"b{i}"])
        h = sin(arg)
        x = a[f"h{i}"] = h if i == NUM_LAYERS else r(h)
    h8 = a[f"h{NUM_LAYERS}"]
    a["sigma_pre"] = torch.sum(h8 * v["ws"], dim=-1) + v["bs"]
    a["feat"] = r(r(h8) @ m["wre"] + v["bre"])
    a["argr0"] = k.hidden_w0 * (a["feat"] @ m["wr0f"] + a["denc"] @ m["wr0d"]
                                + v["br0"])
    a["y"] = r(sin(a["argr0"]))
    a["rgb"] = torch.sigmoid((a["y"] @ m["wr1"] + v["br1"]) * k.rgb_mul)[..., :3]
    return a


def _forward_acts(packed: Packed, o_aff, d_aff, viewdirs, t,
                  k: SirenConsts) -> dict:
    """``mlp_acts`` of the samples o_aff + t d_aff (R, S) of the rays."""
    p = o_aff[:, None, :] + t[..., None] * d_aff[:, None, :]           # (R,S,3)
    dp = packed.mats["wr0d"].shape[0]
    denc = _encode(viewdirs, k.dir_freqs, dp, torch.sin)
    return mlp_acts(packed, p, denc[:, None, :].expand(*t.shape, dp), k)


def fused_siren_render_plain(packed: Packed, o_aff: torch.Tensor,
                             d_aff: torch.Tensor, viewdirs: torch.Tensor,
                             t: torch.Tensor, k: SirenConsts):
    """The forward kernel's function in plain PyTorch: (rgb (R,3), acc
    (R,), depth (R,), weights (R,S)), all float32, rgb without
    background."""
    acts = _forward_acts(packed, o_aff, d_aff, viewdirs, t, k)
    _, _, weights, rgb, acc, depth = _composite(acts, t, k.sigma_mul)
    return rgb, acc, depth, weights


def mlp_bwd(packed: Packed, acts: dict, dzr1, dsig, k: SirenConsts,
            inputs: bool = False):
    """Backward of the MLP from the cotangents of the sigmoid input and the
    density pre-activation (``fused_siren.py::_mlp_bwd_core``): the flat
    float32 gradients ``(gw, gv)`` in the packed layout; with ``inputs``
    also the input products ``dpos`` = dz1 w1^T (the 3 coordinates) and
    ``ddenc`` = dzr0 wr0d^T (d_pad columns), dz rounded to the compute dtype,
    ``(gw, gv, dpos, ddenc)``."""
    cdt = packed.cdt
    _, cos = trig(cdt)
    m = {name: w.float() for name, w in packed.mats.items()}
    a = {name: x.reshape(-1, x.shape[-1]) for name, x in acts.items()
         if name not in ("sigma_pre", "rgb")}
    dzr1 = dzr1.reshape(-1, 3)
    dsig = dsig.reshape(-1, 1)
    hidden = m["w2"].shape[0]
    gw = torch.zeros(packed.wmat.numel(), dtype=torch.float32, device=dzr1.device)
    gv = torch.zeros(packed.vec.numel(), dtype=torch.float32, device=dzr1.device)
    g = grad_views(gw, gv, hidden, m["wr0d"].shape[0])
    w0s = k.w0s

    def r(x):
        return round_to(x, cdt)

    def dw(name, x, dz):
        g[name].copy_(r(x).T @ r(dz))

    def dact(dz, name):
        return r(dz) @ m[name].T

    g["wr1"][:, :3] = r(a["y"]).T @ r(dzr1)
    g["br1"][:3] = dzr1.sum(0)
    dy = r(dzr1) @ m["wr1"][:, :3].T
    dz = (dy * k.hidden_w0) * cos(a["argr0"])                     # dzr0
    ddenc = dact(dz, "wr0d") if inputs else None
    dw("wr0f", a["feat"], dz)
    dw("wr0d", a["denc"], dz)
    g["br0"].copy_(dz.sum(0))
    dfeat = dact(dz, "wr0f")
    h8 = a[f"h{NUM_LAYERS}"]
    dw("wre", h8, dfeat)
    g["bre"].copy_(dfeat.sum(0))
    g["ws"].copy_((h8 * dsig).sum(0))
    g["bs"].copy_(dsig.sum(0))
    dz = ((dact(dfeat, "wre") + dsig * packed.vecs["ws"]) * w0s[-1]
          ) * cos(a[f"arg{NUM_LAYERS}"])                          # dz8
    for i in range(NUM_LAYERS, 1, -1):
        dw(f"w{i}", a[f"h{i - 1}"], dz)
        g[f"b{i}"].copy_(dz.sum(0))
        dz = (dact(dz, f"w{i}") * w0s[i - 2]) * cos(a[f"arg{i - 1}"])
    g["w1"][:3] = r(a["pos"]).T @ r(dz)
    g["b1"].copy_(dz.sum(0))
    if inputs:
        return gw, gv, r(dz) @ m["w1"][:3].T, ddenc
    return gw, gv


def fused_siren_train_plain(packed: Packed, o_aff, d_aff, viewdirs, t, target,
                            white_bg: bool, k: SirenConsts):
    """The train kernel's function in plain PyTorch: ``(loss, rgb, acc,
    weights, (gw, gv))`` with loss = mean((rgb + white_bg (1 - acc) -
    target)^2) over all rays and channels, rgb without background, and the
    flat float32 gradients of the loss."""
    acts = _forward_acts(packed, o_aff, d_aff, viewdirs, t, k)
    one_m, trans, weights, rgb, acc, _ = _composite(acts, t, k.sigma_mul)
    scale = 1.0 / (3.0 * max(t.shape[0], 1))
    wb = 1.0 if white_bg else 0.0
    err = rgb + wb * (1.0 - acc[:, None]) - target
    loss = scale * torch.sum(err * err)
    g_rgbw = (2.0 * scale) * err
    g_ray = torch.cat([g_rgbw, -wb * g_rgbw.sum(-1, keepdim=True),
                       torch.zeros_like(acc)[:, None]], dim=-1)
    dzr1, dsig = _composite_bwd(acts, one_m, trans, weights, t, g_ray,
                                k.sigma_mul, k.rgb_mul)
    return loss, rgb, acc, weights, mlp_bwd(packed, acts, dzr1, dsig, k)


def fused_siren_render_bwd_plain(packed: Packed, o_aff, d_aff, viewdirs, t,
                                 g_ray, k: SirenConsts):
    """The backward kernel's function in plain PyTorch: the flat float32
    gradients ``(gw, gv)`` of sum(g_ray * [rgb, acc, depth]) over the rays;
    ``g_ray`` is (R, 8) with columns 5.. ignored."""
    acts = _forward_acts(packed, o_aff, d_aff, viewdirs, t, k)
    one_m, trans, weights, _, _, _ = _composite(acts, t, k.sigma_mul)
    dzr1, dsig = _composite_bwd(acts, one_m, trans, weights, t, g_ray,
                                k.sigma_mul, k.rgb_mul)
    return mlp_bwd(packed, acts, dzr1, dsig, k)


# ---------------------------------------------------------------- libraries


# the entry point of each library
_ENTRY = {"fused_render_siren_fwd": "fused_siren_fwd",
          "fused_render_siren_fwd_tc": "fused_siren_fwd_tc",
          "fused_render_siren_train_tc": "fused_siren_train_tc",
          "fused_render_siren_train": "fused_siren_grad"}


@functools.cache
def _library(name: str, shape: SirenPlan | None = None) -> ctypes.CDLL:
    """The library ``name`` with its C signatures declared, at the default
    shape or at the SIREN plan ``shape``'s (built on first use)."""
    lib = library(name) if shape is None else library(name, shape.tag, shape.defines)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry = _ENTRY[name]
    fn, err = getattr(lib, entry), getattr(lib, entry + "_error")
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    fn.restype = ci
    if name in ("fused_render_siren_fwd", "fused_render_siren_fwd_tc"):
        fn.argtypes = [vp] * 6 + [ci] * 7 + [cf] * 4 + [vp] * 5
    elif name == "fused_render_siren_train_tc":
        fn.argtypes = [vp] * 6 + [ci] * 2 + [vp, cf, cf] + [ci] * 5 + [cf] * 4 + [vp] * 7
        lib.fused_siren_render_bwd_tc.argtypes = ([vp] * 6 + [ci] * 2 + [vp] + [ci] * 5
                                                  + [cf] * 4 + [vp] * 5)
        lib.fused_siren_render_bwd_tc.restype = ci
        lib.fused_siren_train_tc_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        lib.fused_siren_train_tc_sizes.restype = None
    else:
        fn.argtypes = ([vp] * 7 + [ci] * 4 + [vp, cf, cf] + [ci] * 5 + [cf] * 4
                       + [vp] * 7)
        lib.fused_siren_grad_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        lib.fused_siren_grad_sizes.restype = None
    return lib


# ---------------------------------------------------------------- wrapper


class FusedSirenRender(FusedRender):
    """Fused render, train pass and render backward of a SIREN (see
    ``FusedRender`` for the contract). ``shape_launches`` splits the three
    counts by shape: ``(counter, plan tag, compute dtype)`` -> launches."""

    launches = 0
    train_launches = 0
    bwd_launches = 0
    shape_launches: collections.Counter = collections.Counter()
    mat_names = _MATS

    def __init__(self, model, near: float, far: float, normalize: bool = True):
        if model.num_layers != NUM_LAYERS:
            # the packed layout itself has 8 sine layers (as the TPU kernels')
            raise NotImplementedError(
                f"the fused SIREN render takes {NUM_LAYERS} sine layers, not "
                f"{model.num_layers} (as nerf_tpu's; use_pallas = false renders "
                "through the module)")
        super().__init__(model, near, far, normalize)
        self.consts = SirenConsts.of(model)
        self.d_pad = d_pad(self.dir_freqs)
        # the kernels' plan at this shape, None outside the shapes they take
        self.plan = plan(self.h, self.d_pad) if covered(self.h, self.d_pad) else None

    def supported(self) -> bool:
        """The shapes the kernels cover (``siren_plan.covered``): hidden
        256, 512, 768 or 1024 with the direction encoding padded to at most
        64 columns."""
        return self.plan is not None

    def _unsupported(self) -> str:
        return (f"the fused SIREN kernels cover hidden 256 to 1024 with the direction "
                f"encoding padded to at most 64 columns; got hidden {self.h}, "
                f"{self.real_d} columns (ROADMAP.md queue 2; run on the CPU, or with "
                "use_pallas = false)")

    def pack_f32(self, model):
        return pack_f32(model)

    def cast(self, wflat, vec) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h, self.d_pad)

    def _plain_forward(self, packed, o_aff, d_aff, viewdirs, t):
        return fused_siren_render_plain(packed, o_aff, d_aff, viewdirs, t,
                                        self.consts)

    def _plain_backward(self, packed, o_aff, d_aff, viewdirs, t, g_ray):
        return fused_siren_render_bwd_plain(packed, o_aff, d_aff, viewdirs, t,
                                            g_ray, self.consts)

    def _plain_train(self, packed, o_aff, d_aff, viewdirs, t, target, white_bg):
        return fused_siren_train_plain(packed, o_aff, d_aff, viewdirs, t, target,
                                       white_bg, self.consts)

    def _family_args(self) -> tuple:
        k = self.consts
        return (self.real_d, k.w0, k.hidden_w0, k.sigma_mul, k.rgb_mul)

    def fwd_library(self) -> str:
        """The library of a forward render: the bfloat16 one runs on the
        tensor cores (two CTAs an SM at hidden 256 with d_pad 32, else one:
        the plan's ``fwd_ctas_per_sm``), the float32 one on the CUDA
        cores."""
        if self.cdt == torch.bfloat16:
            return "fused_render_siren_fwd_tc"
        return "fused_render_siren_fwd"

    def _fwd_entry(self):
        name = self.fwd_library()
        lib, entry = _library(name, self.plan), _ENTRY[name]
        return (getattr(lib, entry), getattr(lib, entry + "_error"),
                self.plan.fwd_ctas_per_sm if name.endswith("_tc") else 1)

    def _grad_entry(self):
        lib = _library("fused_render_siren_train", self.plan)
        return (lib.fused_siren_grad, lib.fused_siren_grad_error,
                grad_sizes(lib.fused_siren_grad_sizes))

    def grad_library(self, train: bool) -> str:
        """The library of a train pass (``train``) or render backward: in
        bfloat16 both run on the tensor cores (one library, two entries),
        in float32 on the CUDA cores."""
        if self.cdt == torch.bfloat16:
            return "fused_render_siren_train_tc"
        return "fused_render_siren_train"

    def _train_tc_entry(self):
        lib = _library("fused_render_siren_train_tc", self.plan)
        return (lib.fused_siren_train_tc, lib.fused_siren_train_tc_error,
                lib.fused_siren_train_tc_sizes)

    def _bwd_tc_entry(self):
        lib = _library("fused_render_siren_train_tc", self.plan)
        return (lib.fused_siren_render_bwd_tc, lib.fused_siren_train_tc_error,
                lib.fused_siren_train_tc_sizes)

