"""Fused NeRF forward render: positional encoding, the NeRF MLP and volume
compositing of a (rays, samples) batch in one CUDA kernel.

The kernel (``nerf_tpu_torch/csrc/fused_render_fwd.cu``) replaces
``nerf_tpu/ops/pallas/fused_render.py::_fwd_kernel``; its source says what
bounds it on an H100 and how its design answers that. This module holds

  * ``pack_params``: a ``NeRFModel`` in the kernel's layout, one matrix
    buffer in the compute dtype and one float32 vector buffer;
  * ``fused_render_plain``: the same function in plain PyTorch, rounding to
    bfloat16 at the same points and using the same degree-11 sine, so that
    it matches the kernel in either compute dtype;
  * ``FusedNerfRender``: the wrapper. On CPU tensors it runs the plain
    version; on CUDA tensors it launches the kernel or raises. It never
    falls back from one to the other.

The library is compiled with ``nvcc`` from the package's ``csrc/`` into
``build/`` beside the package on the first CUDA call, and loaded by ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.common import round_to
from nerf_tpu_torch.ops.sampling import deltas_from_t
from nerf_tpu_torch.ops.volume import exclusive_cumprod

PP, DP = 64, 32          # padded position / direction encoding widths
_HALF_PI = math.pi / 2   # rounds to the same float32 phase as the kernel's

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "fused_render_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (name, rows) of the packed matrices, in buffer order; each is (rows, cols)
# in (in, out) layout. Must match the OFF_* table of the CUDA source.
_MATS = ("w1", "w2", "w3", "w4", "w5", "w6h", "w6p", "w7", "w8", "w9",
         "w10f", "wr0f", "wr0d", "wr1")
_VECS = ("b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8", "b9", "b10f",
         "w10s", "br0", "br1", "b10s")


@dataclass(frozen=True)
class PackedNeRF:
    """A NeRF in the kernel's layout. ``wmat`` holds every matrix in the
    compute dtype, ``vec`` the biases and the density-head row (float32,
    the row rounded to the compute dtype); ``mats``/``vecs`` are views."""

    wmat: torch.Tensor
    vec: torch.Tensor
    mats: dict
    vecs: dict
    cdt: torch.dtype


def pack_params(model) -> PackedNeRF:
    """Pad and split ``model``'s layers into the kernel layout (the float32
    layout of ``nerf_tpu.ops.pallas.fused_nerf.pack_params``, cast once to
    the model's compute dtype)."""
    cdt = model.cdt
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
        "w10s": round_to(w10[:, h], cdt),
        "br0": r0.bias,
        "br1": F.pad(r1.bias, (0, 8 - r1.bias.shape[0])),
        "b10s": b2[4].bias[h:],
    }
    wmat = torch.cat([mats[k].reshape(-1) for k in _MATS]).to(cdt).contiguous()
    vec = torch.cat([vecs[k].reshape(-1) for k in _VECS]).float().contiguous()

    def views(flat, parts, names):
        out, off = {}, 0
        for k in names:
            n = parts[k].numel()
            out[k] = flat[off:off + n].view(parts[k].shape)
            off += n
        return out

    return PackedNeRF(wmat=wmat, vec=vec, mats=views(wmat, mats, _MATS),
                      vecs=views(vec, vecs, _VECS), cdt=cdt)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """The degree-11 sine of ``nerf_tpu.ops.pallas.fused_nerf._fast_sin``
    (full-period range reduction, odd least-squares fit; |err| ~1e-5)."""
    r = x - 6.283185307179586 * torch.round(x * 0.15915494309189535)
    r2 = r * r
    return r * (9.9999970696e-01 + r2 * (-1.6666577198e-01 + r2 * (
        8.3325579984e-03 + r2 * (-1.9812572238e-04 + r2 * (
            2.7040473315e-06 + r2 * -2.0534080101e-08)))))


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


def fused_render_plain(packed: PackedNeRF, o_aff: torch.Tensor,
                       d_aff: torch.Tensor, viewdirs: torch.Tensor,
                       t: torch.Tensor, pos_freqs: int, dir_freqs: int):
    """The kernel's function in plain PyTorch: (rgb (R,3), acc (R,),
    depth (R,), weights (R,S)), all float32, rgb without background."""
    cdt = packed.cdt
    m = {k: v.float() for k, v in packed.mats.items()}
    v = packed.vecs

    def r(x):
        return round_to(x, cdt)

    sin = fast_sin if cdt == torch.bfloat16 else torch.sin
    p = o_aff[:, None, :] + t[..., None] * d_aff[:, None, :]           # (R,S,3)
    penc = r(_encode(p, pos_freqs, m["w1"].shape[0], sin))
    denc = r(_encode(viewdirs, dir_freqs, m["wr0d"].shape[0], torch.sin))
    denc = denc[:, None, :].expand(*t.shape, denc.shape[-1])

    x = penc
    for i in range(1, 6):
        x = r(torch.relu(x @ m[f"w{i}"] + v[f"b{i}"]))
    x = r(torch.relu(x @ m["w6h"] + penc @ m["w6p"] + v["b6"]))
    for i in (7, 8):
        x = r(torch.relu(x @ m[f"w{i}"] + v[f"b{i}"]))
    h9 = torch.relu(x @ m["w9"] + v["b9"])
    sigma = torch.relu(torch.sum(h9 * v["w10s"], dim=-1) + v["b10s"])
    feat = r(r(h9) @ m["w10f"] + v["b10f"])
    y = r(torch.relu(feat @ m["wr0f"] + denc @ m["wr0d"] + v["br0"]))
    rgb = torch.sigmoid(y @ m["wr1"] + v["br1"])[..., :3]

    one_m = torch.exp(-sigma * deltas_from_t(t))
    weights = exclusive_cumprod(one_m, dim=-1) * (1.0 - one_m)
    return (torch.sum(weights[..., None] * rgb, dim=-2),
            torch.sum(weights, dim=-1), torch.sum(weights * t, dim=-1), weights)


@dataclass(frozen=True)
class BuildInfo:
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
                       "the fused render kernel is built from source at first use")


@functools.cache
def build() -> BuildInfo:
    """Compile the kernel library into ``build/`` (once per source and flag
    set: the file name carries their hash)."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"fused_render_fwd-{digest}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "cached")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_render_fwd.argtypes = [vp] * 6 + [ci] * 8 + [vp] * 5
    lib.fused_render_fwd.restype = ci
    lib.fused_render_fwd_error.argtypes = [ci]
    lib.fused_render_fwd_error.restype = ctypes.c_char_p
    return lib


class FusedNerfRender:
    """Fused render of a (rays, samples) batch of a NeRF.

    ``__call__(params, rays_o, rays_d, viewdirs, t)`` with ``params`` a
    ``NeRFModel`` or its ``pack`` returns ``rgb (R,3)``, ``acc (R,)``,
    ``depth (R,)`` and ``weights (R,S)``, float32. White background and
    disparity are left to the caller. ``launches`` counts kernel launches
    over all instances.
    """

    launches = 0

    def __init__(self, model, near: float, far: float, normalize: bool = True):
        self.near, self.far, self.normalize = float(near), float(far), normalize
        self.h = model.hidden_dim
        self.pos_freqs = model.pos_encoding_dim
        self.dir_freqs = model.dir_encoding_dim
        self.real_p = 3 * (1 + 2 * self.pos_freqs)
        self.real_d = 3 * (1 + 2 * self.dir_freqs)
        self.cdt = model.cdt

    def supported(self) -> bool:
        """The shapes the kernel covers: hidden 256 (as the TPU kernel's
        ``supported``) and encodings that fit their padded widths."""
        return self.h == 256 and self.real_p <= PP and self.real_d <= DP

    def pack(self, model) -> PackedNeRF:
        return pack_params(model)

    def affine(self, rays_o, rays_d):
        """The [near,far] -> [-1,1] map folded into the rays (O(rays))."""
        if not self.normalize:
            return rays_o, rays_d
        a = 2.0 / (self.far - self.near)
        b = -2.0 * self.near / (self.far - self.near) - 1.0
        return a * rays_o + b, a * rays_d

    def __call__(self, params, rays_o, rays_d, viewdirs, t) -> dict:
        packed = params if isinstance(params, PackedNeRF) else self.pack(params)
        o_aff, d_aff = self.affine(rays_o, rays_d)
        if t.device.type == "cpu":
            rgb, acc, depth, weights = fused_render_plain(
                packed, o_aff, d_aff, viewdirs, t, self.pos_freqs, self.dir_freqs)
        elif t.device.type == "cuda":
            rgb, acc, depth, weights = self._launch(packed, o_aff, d_aff,
                                                    viewdirs, t)
        else:
            raise ValueError(f"fused render runs on cuda or cpu, not {t.device}")
        return {"rgb": rgb, "acc": acc, "depth": depth, "weights": weights}

    def _launch(self, packed: PackedNeRF, o_aff, d_aff, viewdirs, t):
        if not self.supported():
            raise NotImplementedError(
                f"the fused render kernel covers hidden 256 with encodings of at "
                f"most {PP}/{DP} columns; got hidden {self.h}, "
                f"{self.real_p}/{self.real_d} (render on the CPU, or with "
                "use_pallas = false)")
        ins = (o_aff, d_aff, viewdirs, t, packed.wmat, packed.vec)
        if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
            raise NotImplementedError(
                "the fused render kernel is forward-only; its backward "
                "(fused_render.py::_bwd_kernel) is not ported yet")
        num_rays, s = t.shape
        dev = t.device
        for name, x, shape, dtype in (
                ("rays_o", o_aff, (num_rays, 3), torch.float32),
                ("rays_d", d_aff, (num_rays, 3), torch.float32),
                ("viewdirs", viewdirs, (num_rays, 3), torch.float32),
                ("t", t, (num_rays, s), torch.float32),
                ("wmat", packed.wmat, packed.wmat.shape, self.cdt),
                ("vec", packed.vec, packed.vec.shape, torch.float32)):
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        o_aff, d_aff, viewdirs, t = (x.contiguous() for x in (o_aff, d_aff,
                                                               viewdirs, t))
        rgb = torch.empty((num_rays, 3), dtype=torch.float32, device=dev)
        acc = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        depth = torch.empty((num_rays,), dtype=torch.float32, device=dev)
        weights = torch.empty((num_rays, s), dtype=torch.float32, device=dev)
        lib = _library()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        rays_per_cta = -(-num_rays // n_sm)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.fused_render_fwd(
                o_aff.data_ptr(), d_aff.data_ptr(), viewdirs.data_ptr(),
                t.data_ptr(), packed.wmat.data_ptr(), packed.vec.data_ptr(),
                packed.wmat.numel(), packed.vec.numel(),
                int(self.cdt == torch.bfloat16), num_rays, s, rays_per_cta,
                self.real_p, self.real_d, rgb.data_ptr(), acc.data_ptr(),
                depth.data_ptr(), weights.data_ptr(), stream)
        if code != 0:
            raise RuntimeError("fused render kernel: "
                               + lib.fused_render_fwd_error(code).decode())
        FusedNerfRender.launches += 1
        return rgb, acc, depth, weights

