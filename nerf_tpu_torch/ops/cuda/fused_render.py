"""Fused NeRF render, train pass and render backward: positional encoding,
the NeRF MLP and volume compositing of a (rays, samples) batch, with their
gradients, in CUDA kernels.

Three kernels, each replacing one of ``nerf_tpu/ops/pallas/fused_render.py``
(their sources say what bounds each on an H100 and how the design answers):

  * ``csrc/fused_render_fwd.cu`` (``_fwd_kernel``): the forward render;
  * ``csrc/fused_render_train.cu``, train entry (``_train_kernel``):
    forward, white-background MSE and the full backward in one pass;
  * ``csrc/fused_render_train.cu``, backward entry (``_bwd_kernel``): the
    parameter gradients of the forward render from a per-ray cotangent.

This module holds

  * ``pack_f32`` / ``cast_packed`` / ``pack_params``: a ``NeRFModel`` in the
    kernels' layout. ``pack_f32`` is differentiable float32 (autograd maps
    the kernels' packed gradients back onto the ``nn.Linear`` parameters);
    ``cast_packed`` rounds the matrices to the compute dtype, as the JAX
    package's ``_cast_weights`` does inside its custom VJPs;
  * the plain PyTorch versions ``fused_render_plain``, ``fused_train_plain``
    and ``fused_render_bwd_plain``, rounding to bfloat16 at the kernels'
    points (the backward at ``fused_nerf.py::_mlp_bwd_core``'s), so that
    each matches its kernel in either compute dtype;
  * ``FusedNerfRender``: the wrapper. On CPU tensors it runs the plain
    versions; on CUDA tensors it launches the kernels or raises. It never
    falls back from one to the other. ``__call__`` is differentiable in the
    parameters (the backward kernel behind a ``torch.autograd.Function``);
    ``train`` returns the loss with its gradient already computed.

``FusedRender`` is what the wrappers of every family share (the routes,
the autograd Functions, the launches); ``fused_render_siren.py`` and
``fused_render_gabor.py`` hold the SIREN and GaborNet families on it. The
libraries are built by ``build.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.ops.cuda.build import library
from nerf_tpu_torch.ops.sampling import deltas_from_t
from nerf_tpu_torch.ops.volume import exclusive_cumprod

PP, DP = 64, 32          # padded position / direction encoding widths
_HALF_PI = math.pi / 2   # rounds to the same float32 phase as the kernel's

# The packed matrices and vectors, in buffer order (must match the OFF_*
# tables of csrc/fused_render_common.cuh). Matrices are (in, out).
_MATS = ("w1", "w2", "w3", "w4", "w5", "w6h", "w6p", "w7", "w8", "w9",
         "w10f", "wr0f", "wr0d", "wr1")
_VECS = ("b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8", "b9", "b10f",
         "w10s", "br0", "br1", "b10s")


def _shapes(h: int) -> tuple[dict, dict]:
    hr = h // 2
    mats = {"w1": (PP, h), **{f"w{i}": (h, h) for i in range(2, 6)},
            "w6h": (h, h), "w6p": (PP, h),
            **{f"w{i}": (h, h) for i in range(7, 10)},
            "w10f": (h, h), "wr0f": (h, hr), "wr0d": (DP, hr), "wr1": (hr, 8)}
    vecs = {**{f"b{i}": (h,) for i in range(1, 10)}, "b10f": (h,),
            "w10s": (h,), "br0": (hr,), "br1": (8,), "b10s": (1,)}
    return mats, vecs


def _views(flat: torch.Tensor, shapes: dict, names) -> dict:
    out, off = {}, 0
    for k in names:
        n = math.prod(shapes[k])
        out[k] = flat[off:off + n].view(shapes[k])
        off += n
    return out


@dataclass(frozen=True)
class Packed:
    """A model in its family's kernel layout. ``wmat`` holds every matrix in
    the compute dtype, ``vec`` the biases and the density-head row (float32,
    the row rounded to the compute dtype); ``mats``/``vecs`` are views."""

    wmat: torch.Tensor
    vec: torch.Tensor
    mats: dict
    vecs: dict
    cdt: torch.dtype


def pack_f32(model) -> tuple[torch.Tensor, torch.Tensor]:
    """``(wflat, vec)``: every matrix and every vector of ``model`` padded
    and split into the kernel layout, float32 and differentiable (the float32
    layout of ``nerf_tpu.ops.pallas.fused_nerf.pack_params``)."""
    h = model.hidden_dim
    b1 = model.linears(model.block1)
    b2 = model.linears(model.block2)
    r0, r1 = model.linears(model.rgb_head)

    def w(lyr):
        return lyr.weight.T

    def pad_rows(x, rows):
        return F.pad(x, (0, 0, 0, rows - x.shape[0]))

    w6, w10, wr0 = w(b2[0]), w(b2[4]), w(r0)
    mats = {
        "w1": pad_rows(w(b1[0]), PP),
        **{f"w{i}": w(b1[i - 1]) for i in range(2, 6)},
        "w6h": w6[:h], "w6p": pad_rows(w6[h:], PP),
        **{f"w{i}": w(b2[i - 6]) for i in range(7, 10)},
        "w10f": w10[:, :h],
        "wr0f": wr0[:h], "wr0d": pad_rows(wr0[h:], DP),
        "wr1": F.pad(w(r1), (0, 8 - r1.weight.shape[0])),
    }
    vecs = {
        **{f"b{i}": b1[i - 1].bias for i in range(1, 6)},
        **{f"b{i}": b2[i - 6].bias for i in range(6, 10)},
        "b10f": b2[4].bias[:h],
        "w10s": w10[:, h],
        "br0": r0.bias,
        "br1": F.pad(r1.bias, (0, 8 - r1.bias.shape[0])),
        "b10s": b2[4].bias[h:],
    }
    wflat = torch.cat([mats[k].reshape(-1) for k in _MATS]).float()
    vec = torch.cat([vecs[k].reshape(-1) for k in _VECS]).float()
    return wflat, vec


def cast_packed(wflat: torch.Tensor, vec: torch.Tensor, cdt: torch.dtype,
                hidden: int) -> Packed:
    """The float32 packing as the kernels read it: matrices in ``cdt``, the
    density row rounded to ``cdt`` (biases stay float32)."""
    mat_shapes, vec_shapes = _shapes(hidden)
    o = 10 * hidden                                   # offset of w10s
    vec = torch.cat([vec[:o], round_to(vec[o:o + hidden], cdt),
                     vec[o + hidden:]]).contiguous()
    wmat = wflat.to(cdt).contiguous()
    return Packed(wmat=wmat, vec=vec, mats=_views(wmat, mat_shapes, _MATS),
                      vecs=_views(vec, vec_shapes, _VECS), cdt=cdt)


def pack_params(model) -> Packed:
    """``model`` in the kernel layout, cast once to its compute dtype."""
    wflat, vec = pack_f32(model)
    return cast_packed(wflat, vec, model.cdt, model.hidden_dim)


def grad_views(gw: torch.Tensor, gv: torch.Tensor, hidden: int) -> dict:
    """The 28 gradient tensors of a flat ``(gw, gv)`` pair, by name."""
    mat_shapes, vec_shapes = _shapes(hidden)
    return {**_views(gw, mat_shapes, _MATS), **_views(gv, vec_shapes, _VECS)}


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """The degree-11 sine of ``nerf_tpu.ops.pallas.fused_nerf._fast_sin``
    (full-period range reduction, odd least-squares fit; |err| ~1e-5)."""
    r = x - 6.283185307179586 * torch.round(x * 0.15915494309189535)
    r2 = r * r
    return r * (9.9999970696e-01 + r2 * (-1.6666577198e-01 + r2 * (
        8.3325579984e-03 + r2 * (-1.9812572238e-04 + r2 * (
            2.7040473315e-06 + r2 * -2.0534080101e-08)))))


def trig(cdt: torch.dtype):
    """(sin, cos) of the sine layers and filters: exact in float32; in
    bfloat16 the degree-11 sine and cos x = fast_sin(x + pi/2), as the TPU
    kernels' ``fused_nerf.py::_trig``."""
    if cdt != torch.bfloat16:
        return torch.sin, torch.cos

    def cos(x):
        return fast_sin(x + torch.tensor(_HALF_PI, dtype=x.dtype, device=x.device))

    return fast_sin, cos


def _encode(x: torch.Tensor, num_freqs: int, width: int, sin) -> torch.Tensor:
    """[x, sin(2^j x), sin(2^j x + pi/2), ...] padded with zeros to ``width``
    (the cos columns as a phase-shifted sine, as both kernels build them)."""
    cols = [x]
    if num_freqs:
        freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
        xb = x[..., None, :] * freqs[:, None]                   # (..., L, D)
        phase = torch.tensor([0.0, _HALF_PI], dtype=x.dtype,
                             device=x.device)[:, None]         # (2, 1)
        enc = sin(xb[..., :, None, :] + phase)                  # (..., L, 2, D)
        cols.append(enc.reshape(*x.shape[:-1], -1))
    out = torch.cat(cols, dim=-1)
    return F.pad(out, (0, width - out.shape[-1]))


def _forward_acts(packed: Packed, o_aff, d_aff, viewdirs, t,
                  pos_freqs: int, dir_freqs: int) -> dict:
    """Every activation of the kernels' forward, (R, S, width) float32:
    matmul inputs rounded to the compute dtype as the kernels round them,
    h9 and sigma_pre unrounded, rgb after the sigmoid (3 channels)."""
    cdt = packed.cdt
    sin = fast_sin if cdt == torch.bfloat16 else torch.sin
    p = o_aff[:, None, :] + t[..., None] * d_aff[:, None, :]           # (R,S,3)
    penc = round_to(_encode(p, pos_freqs, PP, sin), cdt)
    denc = round_to(_encode(viewdirs, dir_freqs, DP, torch.sin), cdt)
    return mlp_acts(packed, penc, denc[:, None, :].expand(*t.shape, DP))


def mlp_acts(packed: Packed, penc: torch.Tensor, denc: torch.Tensor) -> dict:
    """Every activation of the NeRF MLP of the kernels (``fused_nerf.py::
    _mlp_tile``) on encodings already rounded to the compute dtype, float32
    with the encodings' leading shape: matmul inputs rounded as the kernels
    round them, h9 and sigma_pre unrounded, rgb after the sigmoid (3
    channels)."""
    cdt = packed.cdt
    m = {k: v.float() for k, v in packed.mats.items()}
    v = packed.vecs

    def r(x):
        return round_to(x, cdt)

    a = {"penc": penc, "denc": denc}
    x = a["penc"]
    for i in range(1, 6):
        x = a[f"h{i}"] = r(torch.relu(x @ m[f"w{i}"] + v[f"b{i}"]))
    x = a["h6"] = r(torch.relu(x @ m["w6h"] + a["penc"] @ m["w6p"] + v["b6"]))
    for i in (7, 8):
        x = a[f"h{i}"] = r(torch.relu(x @ m[f"w{i}"] + v[f"b{i}"]))
    h9 = a["h9"] = torch.relu(x @ m["w9"] + v["b9"])
    a["sigma_pre"] = torch.sum(h9 * v["w10s"], dim=-1) + v["b10s"]
    a["feat"] = r(r(h9) @ m["w10f"] + v["b10f"])
    a["y"] = r(torch.relu(a["feat"] @ m["wr0f"] + a["denc"] @ m["wr0d"] + v["br0"]))
    a["rgb"] = torch.sigmoid(a["y"] @ m["wr1"] + v["br1"])[..., :3]
    return a


def _composite(acts: dict, t: torch.Tensor, sigma_mul: float = 1.0):
    """(one_m, T, weights) of each sample, and the ray sums (rgb without
    background, acc, depth); sigma = relu(sigma_pre) * sigma_mul."""
    sigma = torch.relu(acts["sigma_pre"]) * sigma_mul
    one_m = torch.exp(-sigma * deltas_from_t(t))
    trans = exclusive_cumprod(one_m, dim=-1)
    weights = trans * (1.0 - one_m)
    return (one_m, trans, weights, torch.sum(weights[..., None] * acts["rgb"], dim=-2),
            torch.sum(weights, dim=-1), torch.sum(weights * t, dim=-1))


def fused_render_plain(packed: Packed, o_aff: torch.Tensor,
                       d_aff: torch.Tensor, viewdirs: torch.Tensor,
                       t: torch.Tensor, pos_freqs: int, dir_freqs: int):
    """The forward kernel's function in plain PyTorch: (rgb (R,3), acc
    (R,), depth (R,), weights (R,S)), all float32, rgb without
    background."""
    acts = _forward_acts(packed, o_aff, d_aff, viewdirs, t, pos_freqs, dir_freqs)
    _, _, weights, rgb, acc, depth = _composite(acts, t)
    return rgb, acc, depth, weights


def _composite_bwd(acts: dict, one_m, trans, weights, t, g_ray,
                   sigma_mul: float = 1.0, rgb_mul: float = 1.0):
    """Backward through compositing (``fused_render.py::_composite_bwd``):
    a per-ray cotangent (R, >=5) = [g_rgb, g_acc, g_depth] -> the sigmoid
    input's cotangent dzr1 (R,S,3) (times ``rgb_mul``, the sigmoid taking
    ``rgb_mul`` times that input) and the density pre-activation's (R,S)."""
    rgb = acts["rgb"]
    g_rgb = g_ray[:, None, :3]
    g_w = (torch.sum(g_rgb * rgb, dim=-1) + g_ray[:, None, 3]
           + g_ray[:, None, 4] * t)
    gww = g_w * weights
    # suffix[i] = sum over the later samples of the ray
    suffix = torch.flip(torch.cumsum(torch.flip(gww[:, 1:], [-1]), -1), [-1])
    suffix = F.pad(suffix, (0, 1))
    g_sigma = (g_w * trans * one_m - suffix) * deltas_from_t(t)
    dzr1 = g_rgb * weights[..., None] * rgb * (1.0 - rgb) * rgb_mul
    dsig = torch.where(acts["sigma_pre"] > 0, g_sigma * sigma_mul,
                       torch.zeros_like(g_sigma))
    return dzr1, dsig


def mlp_bwd(packed: Packed, acts: dict, dzr1, dsig, inputs: bool = False):
    """Backward of the MLP from the cotangents of the sigmoid input and the
    density (``fused_nerf.py::_mlp_bwd_core``): the flat float32 gradients
    ``(gw, gv)`` in the packed layout and, with ``inputs``, the cotangents
    of the two encodings ``(dpenc, ddenc)`` after them."""
    cdt = packed.cdt
    m = {k: v.float() for k, v in packed.mats.items()}
    a = {k: v.reshape(-1, v.shape[-1]) for k, v in acts.items()
         if k not in ("sigma_pre", "rgb")}
    dzr1 = dzr1.reshape(-1, 3)
    dsig = dsig.reshape(-1, 1)
    hidden = m["w2"].shape[0]
    gw = torch.zeros(packed.wmat.numel(), dtype=torch.float32, device=dzr1.device)
    gv = torch.zeros(packed.vec.numel(), dtype=torch.float32, device=dzr1.device)
    g = grad_views(gw, gv, hidden)

    def r(x):
        return round_to(x, cdt)

    def dw(name, x, dz):
        g[name].copy_(r(x).T @ r(dz))

    def dact(dz, name):
        return r(dz) @ m[name].T

    g["wr1"][:, :3] = r(a["y"]).T @ r(dzr1)
    g["br1"][:3] = dzr1.sum(0)
    dz = (r(dzr1) @ m["wr1"][:, :3].T) * (a["y"] > 0)         # dzr0
    if inputs:
        ddenc = dact(dz, "wr0d")
    dw("wr0f", a["feat"], dz)
    dw("wr0d", a["denc"], dz)
    g["br0"].copy_(dz.sum(0))
    dfeat = dact(dz, "wr0f")
    h9 = a["h9"]
    dw("w10f", h9, dfeat)
    g["b10f"].copy_(dfeat.sum(0))
    g["w10s"].copy_((h9 * dsig).sum(0))
    g["b10s"].copy_(dsig.sum(0))
    dz = (dact(dfeat, "w10f") + dsig * packed.vecs["w10s"]) * (h9 > 0)   # dz9
    for i in (9, 8, 7, 6, 5, 4, 3, 2):
        w = "w6h" if i == 6 else f"w{i}"
        prev = a[f"h{i - 1}"]
        dw(w, prev, dz)
        if i == 6:
            dw("w6p", a["penc"], dz)
            if inputs:
                dpenc = dact(dz, "w6p")
        g[f"b{i}"].copy_(dz.sum(0))
        dz = dact(dz, w) * (prev > 0)
    dw("w1", a["penc"], dz)
    g["b1"].copy_(dz.sum(0))
    if inputs:
        return gw, gv, dpenc + dact(dz, "w1"), ddenc
    return gw, gv


def fused_train_plain(packed: Packed, o_aff, d_aff, viewdirs, t, target,
                      white_bg: bool, pos_freqs: int, dir_freqs: int):
    """The train kernel's function in plain PyTorch: ``(loss, rgb, acc,
    weights, (gw, gv))`` with loss = mean((rgb + white_bg (1 - acc) -
    target)^2) over all rays and channels, rgb without background, and the
    flat float32 gradients of the loss."""
    acts = _forward_acts(packed, o_aff, d_aff, viewdirs, t, pos_freqs, dir_freqs)
    one_m, trans, weights, rgb, acc, _ = _composite(acts, t)
    scale = 1.0 / (3.0 * max(t.shape[0], 1))
    wb = 1.0 if white_bg else 0.0
    err = rgb + wb * (1.0 - acc[:, None]) - target
    loss = scale * torch.sum(err * err)
    g_rgbw = (2.0 * scale) * err
    g_ray = torch.cat([g_rgbw, -wb * g_rgbw.sum(-1, keepdim=True),
                       torch.zeros_like(acc)[:, None]], dim=-1)
    dzr1, dsig = _composite_bwd(acts, one_m, trans, weights, t, g_ray)
    return loss, rgb, acc, weights, mlp_bwd(packed, acts, dzr1, dsig)


def fused_render_bwd_plain(packed: Packed, o_aff, d_aff, viewdirs, t,
                           g_ray, pos_freqs: int, dir_freqs: int):
    """The backward kernel's function in plain PyTorch: the flat float32
    gradients ``(gw, gv)`` of sum(g_ray * [rgb, acc, depth]) over the rays;
    ``g_ray`` is (R, 8) with columns 5.. ignored."""
    acts = _forward_acts(packed, o_aff, d_aff, viewdirs, t, pos_freqs, dir_freqs)
    one_m, trans, weights, _, _, _ = _composite(acts, t)
    dzr1, dsig = _composite_bwd(acts, one_m, trans, weights, t, g_ray)
    return mlp_bwd(packed, acts, dzr1, dsig)


# ---------------------------------------------------------------- libraries


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = library(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "fused_render_fwd":
        lib.fused_render_fwd.argtypes = [vp] * 6 + [ci] * 8 + [vp] * 5
        lib.fused_render_fwd.restype = ci
        lib.fused_render_fwd_error.argtypes = [ci]
        lib.fused_render_fwd_error.restype = ctypes.c_char_p
    else:
        lib.fused_render_grad.argtypes = ([vp] * 7 + [ci] * 4 + [vp, cf, cf]
                                          + [ci] * 6 + [vp] * 7)
        lib.fused_render_grad.restype = ci
        lib.fused_render_grad_error.argtypes = [ci]
        lib.fused_render_grad_error.restype = ctypes.c_char_p
        lib.fused_render_grad_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        lib.fused_render_grad_sizes.restype = None
    return lib


def grad_sizes(sizes_fn) -> tuple[int, int, int]:
    """(floats per stashed point, floats per CTA partial, output floats) as
    a train library's ``*_grad_sizes`` gives them."""
    vals = [ctypes.c_int() for _ in range(3)]
    sizes_fn(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


# ---------------------------------------------------------------- autograd


class _RenderFn(torch.autograd.Function):
    """The forward render of a ``FusedRender`` as a function of its float32
    packing; its backward is the backward kernel (the plain version on the CPU). The
    weights output and the ray/t inputs carry no gradient."""

    @staticmethod
    def forward(ctx, wflat, vec, fr, o_aff, d_aff, viewdirs, t):
        packed = fr.cast(wflat.detach(), vec.detach())
        rgb, acc, depth, weights = fr._forward(packed, o_aff, d_aff, viewdirs, t)
        ctx.fr, ctx.packed = fr, packed
        ctx.save_for_backward(o_aff, d_aff, viewdirs, t)
        ctx.mark_non_differentiable(weights)
        return rgb, acc, depth, weights

    @staticmethod
    def backward(ctx, g_rgb, g_acc, g_depth, _g_weights):
        o_aff, d_aff, viewdirs, t = ctx.saved_tensors
        g_ray = torch.zeros((t.shape[0], 8), dtype=torch.float32, device=t.device)
        if g_rgb is not None:
            g_ray[:, :3] = g_rgb
        if g_acc is not None:
            g_ray[:, 3] = g_acc
        if g_depth is not None:
            g_ray[:, 4] = g_depth
        gw, gv = ctx.fr._backward(ctx.packed, o_aff, d_aff, viewdirs, t, g_ray)
        return gw, gv, None, None, None, None, None


class _TrainFn(torch.autograd.Function):
    """The train pass as a function of the float32 packing: the loss, with
    the kernel's gradients kept for the backward (scaled by the loss
    cotangent); rgb, acc and weights are stop-gradient byproducts."""

    @staticmethod
    def forward(ctx, wflat, vec, fr, o_aff, d_aff, viewdirs, t, target, white_bg):
        packed = fr.cast(wflat.detach(), vec.detach())
        loss, rgb, acc, weights, (gw, gv) = fr._train(
            packed, o_aff, d_aff, viewdirs, t, target, white_bg)
        ctx.save_for_backward(gw, gv)
        ctx.mark_non_differentiable(rgb, acc, weights)
        return loss, rgb, acc, weights

    @staticmethod
    def backward(ctx, g_loss, _g_rgb, _g_acc, _g_weights):
        gw, gv = ctx.saved_tensors
        return gw * g_loss, gv * g_loss, None, None, None, None, None, None, None


# ---------------------------------------------------------------- wrapper


class FusedRender:
    """Fused render, train pass and render backward of one model family.

    ``__call__(params, rays_o, rays_d, viewdirs, t)`` with ``params`` a
    model or its ``pack`` returns ``rgb (R,3)``, ``acc (R,)``, ``depth
    (R,)`` and ``weights (R,S)``, float32; with a model whose parameters
    require grad (and grad enabled) rgb/acc/depth are differentiable in
    them. ``train(...)`` returns the MSE loss (its gradient computed in the
    same pass) and stop-gradient byproducts. White background and disparity
    are left to the caller of ``__call__``. Each family's class counts its
    kernel launches over all its instances in ``launches``,
    ``train_launches`` and ``bwd_launches``.

    A family gives ``pack_f32`` (its float32 kernel layout, differentiable),
    ``cast`` (the layout as the kernels read it), ``supported``, its plain
    versions (``_plain_forward``, ``_plain_train``, ``_plain_backward``),
    its libraries' entry points (``_fwd_entry``, ``_grad_entry``), the
    family arguments of both (``_family_args``) and its matrix names in
    buffer order (``mat_names``).
    """

    launches = 0
    train_launches = 0
    bwd_launches = 0
    mat_names: tuple = ()

    def __init__(self, model, near: float, far: float, normalize: bool = True):
        self.near, self.far, self.normalize = float(near), float(far), normalize
        self.h = model.hidden_dim
        self.dir_freqs = model.dir_encoding_dim
        self.real_d = 3 * (1 + 2 * self.dir_freqs)
        self.cdt = model.cdt

    def pack(self, model) -> Packed:
        """``model`` in the kernel layout, cast once to its compute dtype."""
        return self.cast(*self.pack_f32(model))

    def affine(self, rays_o, rays_d):
        """The [near,far] -> [-1,1] map folded into the rays (O(rays))."""
        if not self.normalize:
            return rays_o, rays_d
        a = 2.0 / (self.far - self.near)
        b = -2.0 * self.near / (self.far - self.near) - 1.0
        return a * rays_o + b, a * rays_d

    def __call__(self, params, rays_o, rays_d, viewdirs, t) -> dict:
        o_aff, d_aff = self.affine(rays_o, rays_d)
        if isinstance(params, Packed):
            outs = self._forward(params, o_aff, d_aff, viewdirs, t)
        elif torch.is_grad_enabled() and any(p.requires_grad
                                             for p in params.parameters()):
            outs = _RenderFn.apply(*self.pack_f32(params), self, o_aff, d_aff,
                                   viewdirs, t)
        else:
            outs = self._forward(self.pack(params), o_aff, d_aff, viewdirs, t)
        return dict(zip(("rgb", "acc", "depth", "weights"), outs))

    def train(self, params, rays_o, rays_d, viewdirs, t, target,
              white_bg: bool):
        """One fused train pass of the model ``params``: returns
        ``(mse_loss, aux)`` with ``aux`` holding ``rgb``/``acc``/``weights``
        (stop-gradient). The loss is ``mean((rgb + white_bg (1 - acc) -
        target)^2)`` over all rays and channels; its gradient reaches the
        parameters through ``loss.backward()`` (float32, from the same
        kernel pass)."""
        o_aff, d_aff = self.affine(rays_o, rays_d)
        loss, rgb, acc, weights = _TrainFn.apply(
            *self.pack_f32(params), self, o_aff, d_aff, viewdirs, t, target,
            bool(white_bg))
        return loss, {"rgb": rgb, "acc": acc, "weights": weights}

    # -- routes: the plain versions for CPU tensors, the kernels for CUDA

    def _route(self, t) -> str:
        if t.device.type in ("cpu", "cuda"):
            return t.device.type
        raise ValueError(f"fused render runs on cuda or cpu, not {t.device}")

    def _forward(self, packed, o_aff, d_aff, viewdirs, t):
        if self._route(t) == "cpu":
            return self._plain_forward(packed, o_aff, d_aff, viewdirs, t)
        return self._launch_fwd(packed, o_aff, d_aff, viewdirs, t)

    def _backward(self, packed, o_aff, d_aff, viewdirs, t, g_ray):
        if self._route(t) == "cpu":
            return self._plain_backward(packed, o_aff, d_aff, viewdirs, t, g_ray)
        out = self._launch_grad(packed, o_aff, d_aff, viewdirs, t, g_ray,
                                train=False, white_bg=False)
        type(self).bwd_launches += 1
        return out[0]

    def _train(self, packed, o_aff, d_aff, viewdirs, t, target, white_bg):
        if self._route(t) == "cpu":
            return self._plain_train(packed, o_aff, d_aff, viewdirs, t, target,
                                     white_bg)
        (gw, gv), loss, rgb, acc, weights = self._launch_grad(
            packed, o_aff, d_aff, viewdirs, t, target, train=True,
            white_bg=white_bg)
        type(self).train_launches += 1
        return loss, rgb, acc, weights, (gw, gv)

    def _check(self, packed: Packed, named: tuple) -> None:
        if not self.supported():
            raise NotImplementedError(self._unsupported())
        dev = named[0][1].device
        for name, x, shape, dtype in named + (
                ("wmat", packed.wmat, packed.wmat.shape, self.cdt),
                ("vec", packed.vec, packed.vec.shape, torch.float32)):
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")

    def _ray_args(self, o_aff, d_aff, viewdirs, t):
        num_rays, s = t.shape
        return (("rays_o", o_aff, (num_rays, 3), torch.float32),
                ("rays_d", d_aff, (num_rays, 3), torch.float32),
                ("viewdirs", viewdirs, (num_rays, 3), torch.float32),
                ("t", t, (num_rays, s), torch.float32))

    def _launch_fwd(self, packed: Packed, o_aff, d_aff, viewdirs, t):
        self._check(packed, self._ray_args(o_aff, d_aff, viewdirs, t))
        num_rays, s = t.shape
        dev = t.device
        o_aff, d_aff, viewdirs, t = (x.detach().contiguous()
                                     for x in (o_aff, d_aff, viewdirs, t))
        rgb = torch.empty((num_rays, 3), dtype=torch.float32, device=dev)
        acc = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        depth = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        weights = torch.empty((num_rays, s), dtype=torch.float32, device=dev)
        fn, err = self._fwd_entry()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        rays_per_cta = -(-num_rays // n_sm)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                o_aff.data_ptr(), d_aff.data_ptr(), viewdirs.data_ptr(),
                t.data_ptr(), packed.wmat.data_ptr(), packed.vec.data_ptr(),
                packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), num_rays, s, rays_per_cta,
                *self._family_args(), rgb.data_ptr(), acc.data_ptr(),
                depth.data_ptr(), weights.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"{type(self).__name__} forward kernel: "
                               + err(code).decode())
        type(self).launches += 1
        return rgb, acc, depth, weights

    def _launch_grad(self, packed: Packed, o_aff, d_aff, viewdirs, t,
                     given, train: bool, white_bg: bool):
        """One launch of the train kernel (``given`` the (R,3) target) or of
        the backward kernel (``given`` the (R,8) cotangent). Returns
        ``((gw, gv), loss, rgb, acc, weights)``."""
        num_rays, s = t.shape
        named = self._ray_args(o_aff, d_aff, viewdirs, t) + (
            ("given", given, (num_rays, 3 if train else 8), torch.float32),)
        self._check(packed, named)
        dev = t.device
        o_aff, d_aff, viewdirs, t, given = (
            x.detach().contiguous() for x in (o_aff, d_aff, viewdirs, t, given))
        fn, err, (per_point, npart, n_out) = self._grad_entry()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        rays_per_cta = -(-num_rays // n_sm)
        grid = -(-num_rays // rays_per_cta)
        cap = -(-rays_per_cta * s // 64) * 64
        # transposed matrices (same offsets) for the dz W^T products
        wmat_t = torch.cat([packed.mats[k].t().reshape(-1) for k in self.mat_names])
        scratch = torch.empty(grid * cap * per_point, dtype=torch.float32, device=dev)
        partial = torch.empty(grid * npart, dtype=torch.float32, device=dev)
        out = torch.empty(n_out, dtype=torch.float32, device=dev)
        rgb = torch.empty((num_rays, 3), dtype=torch.float32, device=dev)
        acc = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        weights = torch.empty((num_rays, s), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                o_aff.data_ptr(), d_aff.data_ptr(), viewdirs.data_ptr(),
                t.data_ptr(), packed.wmat.data_ptr(), wmat_t.data_ptr(),
                packed.vec.data_ptr(), packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), int(train), given.data_ptr(),
                1.0 if white_bg else 0.0, 1.0 / (3.0 * num_rays), num_rays, s,
                rays_per_cta, cap, *self._family_args(), scratch.data_ptr(),
                partial.data_ptr(), out.data_ptr(), rgb.data_ptr(),
                acc.data_ptr(), weights.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"{type(self).__name__} "
                               + ("train kernel: " if train else "backward kernel: ")
                               + err(code).decode())
        n_w = packed.wmat.numel()
        return ((out[:n_w], out[n_w:n_out - 1]), out[n_out - 1], rgb, acc,
                weights)


class FusedNerfRender(FusedRender):
    """Fused render, train pass and render backward of a NeRF (see
    ``FusedRender`` for the contract)."""

    launches = 0
    train_launches = 0
    bwd_launches = 0
    mat_names = _MATS

    def __init__(self, model, near: float, far: float, normalize: bool = True):
        super().__init__(model, near, far, normalize)
        self.pos_freqs = model.pos_encoding_dim
        self.real_p = 3 * (1 + 2 * self.pos_freqs)

    def supported(self) -> bool:
        """The shapes the kernels cover: hidden 256 (as the TPU kernel's
        ``supported``) and encodings that fit their padded widths."""
        return self.h == 256 and self.real_p <= PP and self.real_d <= DP

    def _unsupported(self) -> str:
        return (f"the fused render kernels cover hidden 256 with encodings of "
                f"at most {PP}/{DP} columns; got hidden {self.h}, "
                f"{self.real_p}/{self.real_d} (run on the CPU, or with "
                "use_pallas = false)")

    def pack_f32(self, model):
        return pack_f32(model)

    def cast(self, wflat, vec) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h)

    def _plain_forward(self, packed, o_aff, d_aff, viewdirs, t):
        return fused_render_plain(packed, o_aff, d_aff, viewdirs, t,
                                  self.pos_freqs, self.dir_freqs)

    def _plain_backward(self, packed, o_aff, d_aff, viewdirs, t, g_ray):
        return fused_render_bwd_plain(packed, o_aff, d_aff, viewdirs, t, g_ray,
                                      self.pos_freqs, self.dir_freqs)

    def _plain_train(self, packed, o_aff, d_aff, viewdirs, t, target, white_bg):
        return fused_train_plain(packed, o_aff, d_aff, viewdirs, t, target,
                                 white_bg, self.pos_freqs, self.dir_freqs)

    def _family_args(self) -> tuple:
        return (self.real_p, self.real_d)

    def _fwd_entry(self):
        lib = _library("fused_render_fwd")
        return lib.fused_render_fwd, lib.fused_render_fwd_error

    def _grad_entry(self):
        lib = _library("fused_render_train")
        return (lib.fused_render_grad, lib.fused_render_grad_error,
                grad_sizes(lib.fused_render_grad_sizes))
