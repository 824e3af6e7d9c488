"""Fused GaborNet render and train pass: the per-ray filter coefficients,
the multiplicative filter network and volume compositing of a (rays,
samples) batch, with the train pass's gradients, in CUDA kernels.

Two kernels, each replacing one of
``nerf_tpu/ops/pallas/fused_render_gabor.py`` (their sources say what bounds
each on an H100 and how the design answers):

  * ``csrc/fused_render_gabor_fwd.cu`` (``_fwd_kernel``): the forward render;
  * ``csrc/fused_render_gabor_train.cu`` (``_train_kernel``): forward,
    white-background MSE and the full backward in one pass, with the
    per-ray cotangents of the filter coefficients.

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
    head's first matrix split into wr0f and wr0d with wr0d padded to 32
    rows, wr1/br1 padded to 8 columns); ``cast_packed`` rounds the matrices
    and ws to the compute dtype and keeps the biases float32, as
    ``_cast_weights`` does;
  * ``stack_filters`` / ``gabor_coeffs``: the prep (``FusedGaborRender.
    _prep``), batched over the stages: one (R,3) x (3, n h) product per
    coefficient;
  * the plain PyTorch versions ``fused_gabor_render_plain`` and
    ``fused_gabor_train_plain``, rounding at the kernels' points and using
    the degree-11 sine in bfloat16, so that each matches its kernel in
    either compute dtype; they take any width and depth;
  * ``FusedGaborRender``: the wrapper (CPU tensors: the plain versions;
    CUDA tensors: the kernels, which take hidden 256 and 8 stages, or a
    raise). As in the JAX package the forward render has no gradient:
    ``__call__`` refuses parameters that require grad, and training goes
    through ``train``.
"""

from __future__ import annotations

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

NUM_LAYERS = 8           # filter stages the kernels take
NUM_COEFFS = 5           # A, B, P, Q, R


def _names(n: int) -> tuple[tuple, tuple]:
    """The packed matrices and vectors of an n-stage GaborNet, in buffer
    order (for n = 8 the OFF_* tables of csrc/fused_render_gabor_common.cuh).
    Matrices are (in, out)."""
    mats = tuple(f"w{i}" for i in range(1, n)) + ("wre", "wr0f", "wr0d", "wr1")
    vecs = tuple(f"b{i}" for i in range(1, n)) + ("bre", "ws", "br0", "br1", "bs")
    return mats, vecs


def _shapes(h: int, n: int) -> tuple[dict, dict]:
    hr = h // 2
    mats = {**{f"w{i}": (h, h) for i in range(1, n)}, "wre": (h, h),
            "wr0f": (h, hr), "wr0d": (DP, hr), "wr1": (hr, 8)}
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
    ``model`` padded and split into the kernel layout, float32 and
    differentiable (the filters travel through the prep)."""
    h = model.hidden_dim
    mat_names, vec_names = _names(model.num_layers)

    def w(lyr):
        return lyr.weight.T

    wr0 = w(model.rgb0)
    mats = {
        **{f"w{i}": w(model.linears[i - 1]) for i in range(1, model.num_layers)},
        "wre": w(model.remap),
        "wr0f": wr0[:h], "wr0d": F.pad(wr0[h:], (0, 0, 0, DP - (wr0.shape[0] - h))),
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
                hidden: int, num_layers: int) -> Packed:
    """The float32 packing as the kernels read it: matrices in ``cdt``, the
    density row ws rounded to ``cdt`` (biases stay float32)."""
    mat_shapes, vec_shapes = _shapes(hidden, num_layers)
    mat_names, vec_names = _names(num_layers)
    o = num_layers * hidden                           # offset of ws
    vec = torch.cat([vec[:o], round_to(vec[o:o + hidden], cdt),
                     vec[o + hidden:]]).contiguous()
    wmat = wflat.to(cdt).contiguous()
    return Packed(wmat=wmat, vec=vec, mats=_views(wmat, mat_shapes, mat_names),
                  vecs=_views(vec, vec_shapes, vec_names), cdt=cdt)


def grad_views(gw: torch.Tensor, gv: torch.Tensor, hidden: int,
               num_layers: int = NUM_LAYERS) -> dict:
    """The gradient tensors of a flat ``(gw, gv)`` pair, by name (23 for 8
    stages)."""
    mat_shapes, vec_shapes = _shapes(hidden, num_layers)
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
    denc = _encode(viewdirs, k.dir_freqs, DP, torch.sin)
    return net_acts(packed, filt, denc[:, None, :].expand(*t.shape, DP), k)


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
    g = grad_views(gw, gv, width, n)

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


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = library(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "fused_render_gabor_fwd":
        lib.fused_gabor_fwd.argtypes = [vp] * 5 + [ci] * 7 + [cf] * 2 + [vp] * 5
        lib.fused_gabor_fwd.restype = ci
        lib.fused_gabor_fwd_error.argtypes = [ci]
        lib.fused_gabor_fwd_error.restype = ctypes.c_char_p
    else:
        lib.fused_gabor_train.argtypes = ([vp] * 6 + [ci] * 3 + [vp, cf, cf]
                                          + [ci] * 5 + [cf] * 2 + [vp] * 8)
        lib.fused_gabor_train.restype = ci
        lib.fused_gabor_train_error.argtypes = [ci]
        lib.fused_gabor_train_error.restype = ctypes.c_char_p
        lib.fused_gabor_train_sizes.argtypes = [ctypes.POINTER(ci)] * 3
        lib.fused_gabor_train_sizes.restype = None
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
    over all instances."""

    launches = 0
    train_launches = 0

    def __init__(self, model, near: float, far: float, normalize: bool = True):
        super().__init__(model, near, far, normalize)
        self.n = model.num_layers
        self.consts = GaborConsts.of(model)
        self.mat_names = _names(self.n)[0]

    def supported(self) -> bool:
        """The shapes the kernels cover: hidden 256, 8 stages and a
        direction encoding that fits its padded width."""
        return self.h == 256 and self.n == NUM_LAYERS and self.real_d <= DP

    def _unsupported(self) -> str:
        return (f"the fused GaborNet kernels cover hidden 256 with "
                f"{NUM_LAYERS} stages and a direction encoding of at most {DP} "
                f"columns; got hidden {self.h}, {self.n} stages, {self.real_d} "
                "columns (run on the CPU, or with use_pallas = false)")

    def pack_f32(self, model):
        return pack_f32(model)

    def cast(self, wflat, vec) -> Packed:
        return cast_packed(wflat, vec, self.cdt, self.h, self.n)

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
        type(self).train_launches += 1
        return out

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
        lib = _library("fused_render_gabor_fwd")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.fused_gabor_fwd(
                coeffs.data_ptr(), viewdirs.data_ptr(), t.data_ptr(),
                packed.wmat.data_ptr(), packed.vec.data_ptr(),
                packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), num_rays, s,
                -(-num_rays // n_sm), self.real_d, self.consts.sigma_mul,
                self.consts.rgb_mul, rgb.data_ptr(), acc.data_ptr(),
                depth.data_ptr(), weights.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("FusedGaborRender forward kernel: "
                               + lib.fused_gabor_fwd_error(code).decode())
        type(self).launches += 1
        return rgb, acc, depth, weights

    def _launch_train(self, packed: Packed, coeffs, viewdirs, t, target, white_bg):
        num_rays, s = t.shape
        self._check(packed, self._gabor_args(coeffs, viewdirs, t)
                    + (("target", target, (num_rays, 3), torch.float32),))
        dev = t.device
        coeffs, viewdirs, t, target = (x.detach().contiguous()
                                       for x in (coeffs, viewdirs, t, target))
        lib = _library("fused_render_gabor_train")
        per_point, npart, n_out = grad_sizes(lib.fused_gabor_train_sizes)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        rays_per_cta = -(-num_rays // n_sm)
        grid = -(-num_rays // rays_per_cta)
        cap = -(-rays_per_cta * s // 64) * 64
        # transposed matrices (same offsets) for the dz W^T products
        wmat_t = torch.cat([packed.mats[k].t().reshape(-1) for k in self.mat_names])
        scratch = torch.empty(grid * cap * per_point, dtype=torch.float32, device=dev)
        partial = torch.empty(grid * npart, dtype=torch.float32, device=dev)
        out = torch.empty(n_out, dtype=torch.float32, device=dev)
        dcoef = torch.empty_like(coeffs)
        rgb = torch.empty((num_rays, 3), dtype=torch.float32, device=dev)
        acc = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        weights = torch.empty((num_rays, s), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.fused_gabor_train(
                coeffs.data_ptr(), viewdirs.data_ptr(), t.data_ptr(),
                packed.wmat.data_ptr(), wmat_t.data_ptr(), packed.vec.data_ptr(),
                packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), target.data_ptr(),
                1.0 if white_bg else 0.0, 1.0 / (3.0 * num_rays), num_rays, s,
                rays_per_cta, cap, self.real_d, self.consts.sigma_mul,
                self.consts.rgb_mul, scratch.data_ptr(), partial.data_ptr(),
                out.data_ptr(), dcoef.data_ptr(), rgb.data_ptr(), acc.data_ptr(),
                weights.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("FusedGaborRender train kernel: "
                               + lib.fused_gabor_train_error(code).decode())
        n_w = packed.wmat.numel()
        return (out[n_out - 1], rgb, acc, weights,
                (out[:n_w], out[n_w:n_out - 1]), dcoef)
