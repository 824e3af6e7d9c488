"""Fused GaborNet render and train pass: the per-ray filter coefficients,
the multiplicative filter network and volume compositing of a (rays,
samples) batch, with the train pass's gradients, in CUDA kernels.

Two kernels, each replacing one of
``nerf_tpu/ops/pallas/fused_render_gabor.py`` (their sources say what bounds
each on an H100 and how the design answers):

  * the forward render (``_fwd_kernel``): in bfloat16 on the tensor cores
    (``csrc/fused_render_gabor_fwd_tc.cu``), in float32
    ``csrc/fused_render_gabor_fwd.cu``;
  * the train pass (``_train_kernel``): forward, white-background MSE and
    the full backward in one pass, with the per-ray cotangents of the
    filter coefficients; in bfloat16 on the tensor cores
    (``csrc/fused_render_gabor_train_tc.cu``: a forward and a backward
    kernel over a stash of ``TC_BYTES_PER_POINT`` bytes a point), in
    float32 ``csrc/fused_render_gabor_train.cu``.

With x = o' + t d' (the affine-mapped ray), every input of a Gabor filter
g_i(x) = sin(x . omega_i + phi_i) exp(-gamma_i/2 ||x - mu_i||^2) is a
polynomial in t with per-ray coefficients (``gabor_coeffs``, the prep):

    sin argument   A + t B            A = o' omega + phi,  B = d' omega
    exponent       P + t Q + t^2 R    (-gamma/2 folded in)

so the kernels take five (rays, n h) float32 matrices instead of the filter
parameters. The prep is plain differentiable PyTorch outside the kernels,
as in the JAX package: the train kernel returns the cotangents dA..dR and
autograd carries them on to omega, phi, mu and gamma.

This module holds

  * ``pack_f32`` / ``cast_packed``: the linear and head weights of a
    ``GaborModel`` in the kernels' layout (``fused_render_gabor.py::
    pack_params``: w1..w{n-1}, the density row ws, the remap, the rgb
    head's first matrix split into wr0f and wr0d with wr0d padded to d_pad
    rows, a multiple of 32 (``gabor_plan.d_pad``), wr1/br1 padded to 8
    columns); ``cast_packed`` rounds the matrices and ws to the compute
    dtype and keeps the biases float32, as ``_cast_weights`` does;
  * ``stack_filters`` / ``gabor_coeffs``: the prep (``FusedGaborRender.
    _prep``), batched over the stages: one (R,3) x (3, n h) product per
    coefficient;
  * the plain PyTorch versions ``fused_gabor_render_plain`` and
    ``fused_gabor_train_plain``, rounding at the kernels' points and using
    the degree-11 sine in bfloat16, so that each matches its kernel in
    either compute dtype; they take any width and depth;
  * ``FusedGaborRender``: the wrapper (CPU tensors: the plain versions;
    CUDA tensors: the kernels at every shape of ``gabor_plan.py``, hidden
    256 to 1024, d_pad 32 or 64 and any depth, each shape its own build of
    the libraries; elsewhere a raise). As in the JAX package the forward
    render has no gradient: ``__call__`` refuses parameters that require
    grad, and training goes through ``train``. ``shape_launches`` counts
    the launches by shape.
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
from nerf_tpu_torch.ops.cuda.gabor_plan import DEFAULT_LAYERS, GaborPlan, covered, d_pad, plan
from nerf_tpu_torch.ops.cuda.fused_render import (
    DP,
    FusedRender,
    Packed,
    _composite,
    _composite_bwd,
    _encode,
    _views,
    fwd_rays_per_cta,
    grad_sizes,
    launch_plan,
    trig,
)

NUM_COEFFS = 5           # A, B, P, Q, R
# stash bytes a point of the bfloat16 train pass on the tensor cores at the
# default shape (csrc/fused_render_gabor_tc_common.cuh::TcStash: z1..z8,
# feat and two dz buffers of 256, y (128) and denc (32) in bf16; u2..u8 and
# z8 of 256 and the 16 per-point columns in float32); other shapes'
# are their plan's tc_bytes_per_point
TC_BYTES_PER_POINT = plan(256, DP, DEFAULT_LAYERS).tc_bytes_per_point


def _names(n: int) -> tuple[tuple, tuple]:
    """The packed matrices and vectors of an n-stage GaborNet, in buffer
    order (for n = 8 the OFF_* tables of csrc/fused_render_gabor_common.cuh).
    Matrices are (in, out)."""
    mats = tuple(f"w{i}" for i in range(1, n)) + ("wre", "wr0f", "wr0d", "wr1")
    vecs = tuple(f"b{i}" for i in range(1, n)) + ("bre", "ws", "br0", "br1", "bs")
    return mats, vecs


def _shapes(h: int, n: int, dp: int = DP) -> tuple[dict, dict]:
    hr = h // 2
    mats = {**{f"w{i}": (h, h) for i in range(1, n)}, "wre": (h, h),
            "wr0f": (h, hr), "wr0d": (dp, hr), "wr1": (hr, 8)}
    vecs = {**{f"b{i}": (h,) for i in range(1, n)}, "bre": (h,), "ws": (h,),
            "br0": (hr,), "br1": (8,), "bs": (1,)}
    return mats, vecs


@dataclass(frozen=True)
class GaborConsts:
    """The scalars of a GaborNet that the kernels take besides its weights."""

    num_layers: int
    dir_freqs: int
    sigma_mul: float
    rgb_mul: float

    @classmethod
    def of(cls, model) -> "GaborConsts":
        return cls(model.num_layers, model.dir_encoding_dim, model.sigma_mul,
                   model.rgb_mul)


@dataclass(frozen=True)
class GaborPack:
    """A GaborNet ready to render: its linear and head weights in the kernel
    layout, and its filters stacked over the stages (float32, detached)."""

    packed: Packed
    filters: tuple


def pack_f32(model) -> tuple[torch.Tensor, torch.Tensor]:
    """``(wflat, vec)``: the linear and head matrices and vectors of
    ``model`` padded and split into the kernel layout (wr0d to
    ``gabor_plan.d_pad`` rows), float32 and differentiable (the filters
    travel through the prep)."""
    h = model.hidden_dim
    dp = d_pad(model.dir_encoding_dim)
    mat_names, vec_names = _names(model.num_layers)

    def w(lyr):
        return lyr.weight.T

    wr0 = w(model.rgb0)
    mats = {
        **{f"w{i}": w(model.linears[i - 1]) for i in range(1, model.num_layers)},
        "wre": w(model.remap),
        "wr0f": wr0[:h], "wr0d": F.pad(wr0[h:], (0, 0, 0, dp - (wr0.shape[0] - h))),
        "wr1": F.pad(w(model.rgb1), (0, 8 - model.rgb1.weight.shape[0])),
    }
    vecs = {
        **{f"b{i}": model.linears[i - 1].bias for i in range(1, model.num_layers)},
        "bre": model.remap.bias,
        "ws": model.sigma.weight[0],
        "br0": model.rgb0.bias,
        "br1": F.pad(model.rgb1.bias, (0, 8 - model.rgb1.bias.shape[0])),
        "bs": model.sigma.bias,
    }
    wflat = torch.cat([mats[k].reshape(-1) for k in mat_names]).float()
    vec = torch.cat([vecs[k].reshape(-1) for k in vec_names]).float()
    return wflat, vec


def cast_packed(wflat: torch.Tensor, vec: torch.Tensor, cdt: torch.dtype,
                hidden: int, num_layers: int, dp: int = DP) -> Packed:
    """The float32 packing as the kernels read it: matrices in ``cdt``, the
    density row ws rounded to ``cdt`` (biases stay float32); ``dp`` the
    padded direction-encoding width (``gabor_plan.d_pad``)."""
    mat_shapes, vec_shapes = _shapes(hidden, num_layers, dp)
    mat_names, vec_names = _names(num_layers)
    o = num_layers * hidden                           # offset of ws
    vec = torch.cat([vec[:o], round_to(vec[o:o + hidden], cdt),
                     vec[o + hidden:]]).contiguous()
    wmat = wflat.to(cdt).contiguous()
    return Packed(wmat=wmat, vec=vec, mats=_views(wmat, mat_shapes, mat_names),
                  vecs=_views(vec, vec_shapes, vec_names), cdt=cdt)


def grad_views(gw: torch.Tensor, gv: torch.Tensor, hidden: int,
               num_layers: int = DEFAULT_LAYERS, dp: int = DP) -> dict:
    """The gradient tensors of a flat ``(gw, gv)`` pair, by name (23 for 8
    stages)."""
    mat_shapes, vec_shapes = _shapes(hidden, num_layers, dp)
    mat_names, vec_names = _names(num_layers)
    return {**_views(gw, mat_shapes, mat_names), **_views(gv, vec_shapes, vec_names)}


# ---------------------------------------------------------------- prep


def stack_filters(model) -> tuple[torch.Tensor, ...]:
    """``(omega (3, n h), phi (n h,), mu (n h, 3), gamma (n h,))``: the
    filters of every stage side by side, differentiable."""
    fs = model.filters
    return (torch.cat([f.omega for f in fs], dim=1), torch.cat([f.phi for f in fs]),
            torch.cat([f.mu for f in fs]), torch.cat([f.gamma for f in fs]))


def gabor_coeffs(omega, phi, mu, gamma, o_aff, d_aff) -> torch.Tensor:
    """The per-ray filter coefficients (5, R, n h) = [A, B, P, Q, R] of the
    affine-mapped rays, float32, in the order of
    ``fused_render_gabor.py::_prep``: A = o omega + phi, B = d omega, and
    -gamma/2 folded into P = -gamma/2 (|o|^2 - 2 o mu^T + |mu|^2),
    Q = -gamma/2 (2 o.d - 2 d mu^T), R = -gamma/2 |d|^2."""
    oo = torch.sum(o_aff * o_aff, -1, keepdim=True)
    od = torch.sum(o_aff * d_aff, -1, keepdim=True)
    dd = torch.sum(d_aff * d_aff, -1, keepdim=True)
    half_g = -0.5 * gamma[None, :]
    m2 = torch.sum(mu ** 2, dim=-1)[None, :]
    a = o_aff @ omega + phi
    b = d_aff @ omega
    p = half_g * (oo - 2.0 * (o_aff @ mu.T) + m2)
    q = half_g * (2.0 * od - 2.0 * (d_aff @ mu.T))
    r = half_g * dd
    return torch.stack([a, b, p, q, r])


# ---------------------------------------------------------------- plain


def _filters(coeffs: torch.Tensor, t: torch.Tensor, n: int, sin):
    """Per stage, (sinarg, E, g) of every sample, (R, S, h) float32:
    sinarg = A + t B, E = exp(P + t Q + t^2 R), g = sin(sinarg) E."""
    c = coeffs.reshape(NUM_COEFFS, t.shape[0], n, -1)
    tt = t[..., None]
    t2 = tt * tt
    out = []
    for i in range(n):
        a, b, p, q, r = (x[:, None, i, :] for x in c)
        sinarg = a + tt * b
        e = (p + tt * q) + t2 * r
        big_e = torch.exp(e)
        out.append((sinarg, big_e, sin(sinarg) * big_e))
    return out


def net_acts(packed: Packed, filt: list, denc: torch.Tensor, k: GaborConsts) -> dict:
    """Every activation of the kernels' network (``fused_render_gabor.py::
    _mlp_tile``) given each stage's filter values (``filt[i][2]``, float32)
    and the direction encodings ``denc`` (..., DP) (exact sine), float32:
    matmul inputs rounded to the compute dtype as the kernels round them,
    the last z and sigma_pre unrounded (the density comes from the UNROUNDED
    z, as the TPU kernel's, where the JAX module rounds it), rgb after the
    sigmoid (3 channels)."""
    cdt = packed.cdt
    m = {name: w.float() for name, w in packed.mats.items()}
    v = packed.vecs

    def r(x):
        return round_to(x, cdt)

    a = {"filt": filt}
    zs, us = [filt[0][2]], []
    for i in range(1, k.num_layers):
        u = r(zs[-1]) @ m[f"w{i}"] + v[f"b{i}"]
        us.append(u)
        zs.append(u * filt[i][2])
    a["z"], a["u"] = zs, us
    z = zs[-1]
    a["sigma_pre"] = torch.sum(z * v["ws"], dim=-1) + v["bs"]
    a["feat"] = r(r(z) @ m["wre"] + v["bre"])
    a["denc"] = r(denc)
    a["y"] = r(torch.relu(a["feat"] @ m["wr0f"] + a["denc"] @ m["wr0d"] + v["br0"]))
    a["rgb"] = torch.sigmoid((a["y"] @ m["wr1"] + v["br1"]) * k.rgb_mul)[..., :3]
    return a


def _forward_acts(packed: Packed, coeffs, viewdirs, t, k: GaborConsts) -> dict:
    """``net_acts`` of the samples (R, S) of the rays, with their filters
    from the per-ray coefficients."""
    filt = _filters(coeffs, t, k.num_layers, trig(packed.cdt)[0])
    dp = packed.mats["wr0d"].shape[0]
    denc = _encode(viewdirs, k.dir_freqs, dp, torch.sin)
    return net_acts(packed, filt, denc[:, None, :].expand(*t.shape, dp), k)


def fused_gabor_render_plain(packed: Packed, coeffs: torch.Tensor,
                             viewdirs: torch.Tensor, t: torch.Tensor,
                             k: GaborConsts):
    """The forward kernel's function in plain PyTorch: (rgb (R,3), acc
    (R,), depth (R,), weights (R,S)), all float32, rgb without
    background."""
    acts = _forward_acts(packed, coeffs, viewdirs, t, k)
    _, _, weights, rgb, acc, depth = _composite(acts, t, k.sigma_mul)
    return rgb, acc, depth, weights


def net_bwd(packed: Packed, acts: dict, dzr1, dsig, k: GaborConsts):
    """Backward of the network from the cotangents of the sigmoid input and
    the density pre-activation (``_train_kernel``'s; ``fused_gabor.py::
    _bwd_kernel``'s chain): ``((gw, gv), dgs, dzr0)``, the flat float32
    weight gradients in the packed layout, each stage's filter cotangent
    (points, h) and the rgb head's dzr0 (points, h/2)."""
    cdt = packed.cdt
    n = k.num_layers
    m = {name: w.float() for name, w in packed.mats.items()}
    width = m["wre"].shape[0]

    def flat(x):
        return x.reshape(-1, x.shape[-1])

    gw = torch.zeros(packed.wmat.numel(), dtype=torch.float32, device=dzr1.device)
    gv = torch.zeros(packed.vec.numel(), dtype=torch.float32, device=dzr1.device)
    g = grad_views(gw, gv, width, n, m["wr0d"].shape[0])

    def r(x):
        return round_to(x, cdt)

    def dw(name, x, dz):
        g[name].copy_(r(flat(x)).T @ r(dz))

    def dact(dz, name):
        return r(dz) @ m[name].T

    dzr1 = dzr1.reshape(-1, 3)
    dsig = dsig.reshape(-1, 1)
    y = flat(acts["y"])
    g["wr1"][:, :3] = r(y).T @ r(dzr1)
    g["br1"][:3] = dzr1.sum(0)
    dzr0 = (r(dzr1) @ m["wr1"][:, :3].T) * (y > 0)
    dw("wr0f", acts["feat"], dzr0)
    dw("wr0d", acts["denc"], dzr0)
    g["br0"].copy_(dzr0.sum(0))
    dfeat = dact(dzr0, "wr0f")
    z = flat(acts["z"][-1])
    dw("wre", z, dfeat)
    g["bre"].copy_(dfeat.sum(0))
    g["ws"].copy_((z * dsig).sum(0))
    g["bs"].copy_(dsig.sum(0))
    dz = dact(dfeat, "wre") + dsig * packed.vecs["ws"]             # dz of stage n
    dgs = [None] * n
    for i in range(n - 1, 0, -1):
        du = dz * flat(acts["filt"][i][2])
        dgs[i] = dz * flat(acts["u"][i - 1])
        dw(f"w{i}", acts["z"][i - 1], du)
        g[f"b{i}"].copy_(du.sum(0))
        dz = dact(du, f"w{i}")
    dgs[0] = dz
    return (gw, gv), dgs, dzr0


def _mlp_bwd(packed: Packed, acts: dict, dzr1, dsig, t, k: GaborConsts):
    """``net_bwd`` and the per-ray coefficient cotangents (5, R, n h) of its
    filter cotangents, each the float32 sum over the ray's samples:
    ``((gw, gv), dcoef)``."""
    sin, cos = trig(packed.cdt)
    grads, dgs, _ = net_bwd(packed, acts, dzr1, dsig, k)
    num_rays, s = t.shape
    tt = t[..., None]
    t2 = tt * tt
    dcoef = [[] for _ in range(NUM_COEFFS)]
    for i in range(k.num_layers):
        sinarg, big_e, _ = acts["filt"][i]
        dg = dgs[i].reshape(num_rays, s, -1)
        dsinarg = dg * cos(sinarg) * big_e
        de = dg * sin(sinarg) * big_e
        for j, val in enumerate((dsinarg, dsinarg * tt, de, de * tt, de * t2)):
            dcoef[j].append(val.sum(1))
    dcoef = torch.stack([torch.cat(parts, dim=-1) for parts in dcoef])
    return grads, dcoef


def fused_gabor_train_plain(packed: Packed, coeffs, viewdirs, t, target,
                            white_bg: bool, k: GaborConsts):
    """The train kernel's function in plain PyTorch: ``(loss, rgb, acc,
    weights, (gw, gv), dcoef)`` with loss = mean((rgb + white_bg (1 - acc)
    - target)^2) over all rays and channels, rgb without background, the
    flat float32 weight gradients of the loss and its cotangents of the
    coefficients (5, R, n h)."""
    acts = _forward_acts(packed, coeffs, viewdirs, t, k)
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
    grads, dcoef = _mlp_bwd(packed, acts, dzr1, dsig, t, k)
    return loss, rgb, acc, weights, grads, dcoef


# ---------------------------------------------------------------- libraries


# the forward render's library -> its C entry point
_FWD_ENTRY = {"fused_render_gabor_fwd": "fused_gabor_fwd",
              "fused_render_gabor_fwd_tc": "fused_gabor_fwd_tc"}
# the train pass's
_TRAIN_ENTRY = {"fused_render_gabor_train": "fused_gabor_train",
                "fused_render_gabor_train_tc": "fused_gabor_train_tc"}


@functools.cache
def _library(name: str, shape: GaborPlan | None = None) -> ctypes.CDLL:
    """The library ``name`` with its C signatures declared, at the default
    shape or at the GaborNet plan ``shape``'s (built on first use)."""
    lib = library(name) if shape is None else library(name, shape.tag, shape.defines)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name in _FWD_ENTRY:
        fn, err = getattr(lib, _FWD_ENTRY[name]), getattr(lib, _FWD_ENTRY[name] + "_error")
        fn.argtypes = [vp] * 5 + [ci] * 7 + [cf] * 2 + [vp] * 5
        fn.restype = ci
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
    else:
        entry = _TRAIN_ENTRY[name]
        fn, err = getattr(lib, entry), getattr(lib, entry + "_error")
        sizes = getattr(lib, entry + "_sizes")
        # the tensor-core pass takes no transposed matrices
        head = [vp] * (5 if name.endswith("_tc") else 6) + [ci] * 2
        fn.argtypes = head + [vp, cf, cf] + [ci] * 5 + [cf] * 2 + [vp] * 8
        fn.restype = ci
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
        sizes.argtypes = [ctypes.POINTER(ci)] * 3
        sizes.restype = None
    return lib


# ---------------------------------------------------------------- autograd


class _TrainFn(torch.autograd.Function):
    """The train pass as a function of the float32 packing and the
    coefficients: the loss, with the kernel's weight gradients and
    coefficient cotangents kept for the backward (scaled by the loss
    cotangent, as ``train_bwd`` does); rgb, acc and weights are
    stop-gradient byproducts."""

    @staticmethod
    def forward(ctx, wflat, vec, coeffs, fr, viewdirs, t, target, white_bg):
        packed = fr.cast(wflat.detach(), vec.detach())
        loss, rgb, acc, weights, (gw, gv), dcoef = fr._train(
            packed, coeffs.detach(), viewdirs, t, target, white_bg)
        ctx.save_for_backward(gw, gv, dcoef)
        ctx.mark_non_differentiable(rgb, acc, weights)
        return loss, rgb, acc, weights

    @staticmethod
    def backward(ctx, g_loss, _g_rgb, _g_acc, _g_weights):
        gw, gv, dcoef = ctx.saved_tensors
        return (gw * g_loss, gv * g_loss, dcoef * g_loss,
                None, None, None, None, None)


# ---------------------------------------------------------------- wrapper


class FusedGaborRender(FusedRender):
    """Fused render and train pass of a GaborNet. ``__call__`` and ``train``
    keep ``FusedRender``'s contract, except that ``__call__`` has no
    gradient (``NotImplementedError`` for parameters that require grad, as
    the JAX render route's VJP raises) and that ``params`` may be a
    ``GaborPack``. ``launches`` and ``train_launches`` count the kernels
    over all instances, ``shape_launches`` by ``(counter, plan tag, compute
    dtype)``."""

    launches = 0
    train_launches = 0
    shape_launches: collections.Counter = collections.Counter()

    def __init__(self, model, near: float, far: float, normalize: bool = True):
        super().__init__(model, near, far, normalize)
        self.n = model.num_layers
        self.consts = GaborConsts.of(model)
        self.mat_names = _names(self.n)[0]
        self.d_pad = d_pad(self.dir_freqs)
        # the kernels' plan at this shape, None outside the shapes they take
        self.plan = plan(self.h, self.d_pad, self.n) if covered(
            self.h, self.d_pad, self.n) else None

    def supported(self) -> bool:
        """The shapes the kernels cover (``gabor_plan.covered``): hidden 256,
        512, 768 or 1024 with the direction encoding padded to at most 64
        columns, any number of stages."""
        return self.plan is not None

    def _unsupported(self) -> str:
        return (f"the fused GaborNet kernels cover hidden 256 to 1024 with the direction "
                f"encoding padded to at most 64 columns; got hidden {self.h}, {self.n} "
                f"stages, {self.real_d} columns (ROADMAP.md queue 2; run on the CPU, or "
                "with use_pallas = false)")

    def pack_f32(self, model):
        return pack_f32(model)

    def cast(self, wflat, vec) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h, self.n, self.d_pad)

    def pack(self, model) -> GaborPack:
        """``model`` ready to render: packed weights, stacked filters."""
        with torch.no_grad():
            return GaborPack(packed=self.cast(*self.pack_f32(model)),
                             filters=tuple(x.detach().float()
                                           for x in stack_filters(model)))

    def __call__(self, params, rays_o, rays_d, viewdirs, t) -> dict:
        if not isinstance(params, GaborPack):
            if torch.is_grad_enabled() and any(p.requires_grad
                                               for p in params.parameters()):
                raise NotImplementedError(
                    "the GaborNet fused render is forward-only (as nerf_tpu's); "
                    "train through .train, or render under torch.no_grad()")
            params = self.pack(params)
        o_aff, d_aff = self.affine(rays_o, rays_d)
        with torch.no_grad():
            coeffs = gabor_coeffs(*params.filters, o_aff, d_aff)
            outs = self._forward(params.packed, coeffs, viewdirs, t)
        return dict(zip(("rgb", "acc", "depth", "weights"), outs))

    def train(self, params, rays_o, rays_d, viewdirs, t, target,
              white_bg: bool):
        """One fused train pass of the model ``params``: ``(mse_loss, aux)``
        as ``FusedRender.train``; ``loss.backward()`` reaches the linear
        weights from the kernel's gradients and the filters through the
        prep."""
        o_aff, d_aff = self.affine(rays_o, rays_d)
        coeffs = gabor_coeffs(*stack_filters(params), o_aff, d_aff)
        loss, rgb, acc, weights = _TrainFn.apply(
            *self.pack_f32(params), coeffs, self, viewdirs, t, target,
            bool(white_bg))
        return loss, {"rgb": rgb, "acc": acc, "weights": weights}

    # -- routes: the plain versions for CPU tensors, the kernels for CUDA

    def _forward(self, packed, coeffs, viewdirs, t):
        if self._route(t) == "cpu":
            return fused_gabor_render_plain(packed, coeffs, viewdirs, t, self.consts)
        return self._launch_fwd(packed, coeffs, viewdirs, t)

    def _train(self, packed, coeffs, viewdirs, t, target, white_bg):
        if self._route(t) == "cpu":
            return fused_gabor_train_plain(packed, coeffs, viewdirs, t, target,
                                           white_bg, self.consts)
        out = self._launch_train(packed, coeffs, viewdirs, t, target, white_bg)
        self._count("train_launches")
        return out

    def fwd_library(self) -> str:
        """The library of a forward render: the bfloat16 one runs on the
        tensor cores (two CTAs an SM at hidden 256, else one: the plan's
        ``fwd_ctas_per_sm``), the float32 one on the CUDA cores."""
        if self.cdt == torch.bfloat16:
            return "fused_render_gabor_fwd_tc"
        return "fused_render_gabor_fwd"

    def _fwd_entry(self):
        """(function, error string, CTAs an SM) of the forward render."""
        name = self.fwd_library()
        lib = _library(name, self.plan)
        entry = _FWD_ENTRY[name]
        return (getattr(lib, entry), getattr(lib, entry + "_error"),
                self.plan.fwd_ctas_per_sm if name.endswith("_tc") else 1)

    def _gabor_args(self, coeffs, viewdirs, t):
        num_rays, s = t.shape
        return (("coeffs", coeffs, (NUM_COEFFS, num_rays, self.n * self.h),
                 torch.float32),
                ("viewdirs", viewdirs, (num_rays, 3), torch.float32),
                ("t", t, (num_rays, s), torch.float32))

    def _launch_fwd(self, packed: Packed, coeffs, viewdirs, t):
        self._check(packed, self._gabor_args(coeffs, viewdirs, t))
        num_rays, s = t.shape
        dev = t.device
        coeffs, viewdirs, t = (x.detach().contiguous() for x in (coeffs, viewdirs, t))
        rgb = torch.empty((num_rays, 3), dtype=torch.float32, device=dev)
        acc = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        depth = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        weights = torch.empty((num_rays, s), dtype=torch.float32, device=dev)
        fn, err, ctas_per_sm = self._fwd_entry()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        rays_per_cta = fwd_rays_per_cta(num_rays, n_sm, ctas_per_sm)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(
                coeffs.data_ptr(), viewdirs.data_ptr(), t.data_ptr(),
                packed.wmat.data_ptr(), packed.vec.data_ptr(),
                packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), num_rays, s,
                rays_per_cta, self.real_d, self.consts.sigma_mul,
                self.consts.rgb_mul, rgb.data_ptr(), acc.data_ptr(),
                depth.data_ptr(), weights.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("FusedGaborRender forward kernel: "
                               + err(code).decode())
        self._count("launches")
        return rgb, acc, depth, weights

    def grad_library(self, train: bool) -> str:
        """The library of a train pass: the bfloat16 one runs on the tensor
        cores, the float32 one on the CUDA cores. ``train`` is kept for the
        other families' interface: a GaborNet has no render backward (nor
        has nerf_tpu's: its render route's VJP raises), so only True is
        legal."""
        if not train:
            raise NotImplementedError("the GaborNet fused render has no backward "
                                      "kernel; train through .train")
        if self.cdt == torch.bfloat16:
            return "fused_render_gabor_train_tc"
        return "fused_render_gabor_train"

    def _train_entry(self):
        """(function, error string, sizes, tensor cores?) of the train pass
        on the library ``grad_library`` names."""
        name = self.grad_library(True)
        lib, entry = _library(name, self.plan), _TRAIN_ENTRY[name]
        return (getattr(lib, entry), getattr(lib, entry + "_error"),
                getattr(lib, entry + "_sizes"), name.endswith("_tc"))

    def _check_fits(self, t, sizes: tuple, entry_bytes: int) -> None:
        """Raise ``RuntimeError`` where the train pass's stash and per-CTA
        gradient partials over ``t``'s rays (``sizes``: the library's stash
        entries a point, of ``entry_bytes`` each, and floats a partial) would
        not fit the card: they grow with the width and the depth (56,448
        stash bytes a point and 36 MB a partial at hidden 1024 with 8
        stages, 14.8 + 4.6 GB at 1024 x 256)."""
        num_rays, s = t.shape
        per_point, npart, _ = sizes
        props = torch.cuda.get_device_properties(t.device)
        _, grid, cap = launch_plan(num_rays, s, props.multi_processor_count)
        need = grid * cap * per_point * entry_bytes + grid * npart * 4
        if need > props.total_memory:
            raise RuntimeError(
                f"the GaborNet train pass at {self.plan.tag} over {num_rays} x {s} samples "
                f"needs {need / 2**30:.1f} GiB of stash and partials, more than the card's "
                f"{props.total_memory / 2**30:.1f} GiB; train on fewer rays a step")

    def _launch_train(self, packed: Packed, coeffs, viewdirs, t, target, white_bg):
        """One launch of the train pass on the library ``grad_library``
        names: ``(loss, rgb, acc, weights, (gw, gv), dcoef)``."""
        num_rays, s = t.shape
        self._check(packed, self._gabor_args(coeffs, viewdirs, t)
                    + (("target", target, (num_rays, 3), torch.float32),))
        coeffs, viewdirs, t, target = (x.detach().contiguous()
                                       for x in (coeffs, viewdirs, t, target))
        fn, err, sizes, tc = self._train_entry()
        sizes = grad_sizes(sizes)
        self._check_fits(t, sizes, 1 if tc else 4)
        (rays_per_cta, cap), scratch, partial, out, rgb, acc, weights = self._grad_buffers(
            t, sizes, torch.uint8 if tc else torch.float32)
        dcoef = torch.empty_like(coeffs)
        if tc:
            # bfloat16 on the tensor cores: a forward and a backward kernel
            # over a byte stash
            mats = (packed.wmat.data_ptr(),)
        else:
            # float32 on the CUDA cores, with transposed matrices (same
            # offsets) for the dz W^T products
            wmat_t = torch.cat([packed.mats[k].t().reshape(-1) for k in self.mat_names])
            mats = (packed.wmat.data_ptr(), wmat_t.data_ptr())
        with torch.cuda.device(t.device):
            stream = torch.cuda.current_stream(t.device).cuda_stream
            code = fn(
                coeffs.data_ptr(), viewdirs.data_ptr(), t.data_ptr(), *mats,
                packed.vec.data_ptr(), packed.wmat.numel(), packed.vec.numel(),
                target.data_ptr(), 1.0 if white_bg else 0.0, 1.0 / (3.0 * num_rays),
                num_rays, s, rays_per_cta, cap, self.real_d, self.consts.sigma_mul,
                self.consts.rgb_mul, scratch.data_ptr(), partial.data_ptr(),
                out.data_ptr(), dcoef.data_ptr(), rgb.data_ptr(), acc.data_ptr(),
                weights.data_ptr(), stream)
        grads, loss = self._grad_split("train", err, code, packed, out)
        return loss, rgb, acc, weights, grads, dcoef
