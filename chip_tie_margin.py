#!/usr/bin/env python3
"""The near-tie margin of the bfloat16 SIREN kernels on the tensor cores,
swept on one GPU.

``nerf_tpu_torch/csrc/fused_render_siren_tc_common.cuh`` recomputes, in the
plain version's sequential k order, every hidden-layer element whose sine
lies within ``TIE_ULPS`` * 2^-24 * w0 (|acc + b| + 1) of the midpoint between
two bf16 values, so that it rounds as the plain version's does. This script
builds the SIREN forward render, train pass and field forward
(``fused_render_siren_fwd_tc``, ``fused_render_siren_train_tc``,
``fused_siren_fwd_tc``) from copies of the sources with ``TIE_ULPS``
replaced by each value given, and prints for each value:

  * the forward render's max abs error against ``fused_siren_render_plain``
    at 1024 x 256, 1000 x 256 and 1024 x 37, for two seeded SIRENs;
  * the train pass's against ``fused_siren_train_plain`` at 1024 x 256 and
    133 x 64: loss (relative), rgb, acc, weights, and the worst gradient
    over its max (floored at 1e-2 of the largest);
  * the field forward's against ``siren_field_plain`` (rgb, and sigma over
    max(1, max sigma)) on the first 65,536 points of the 64^3 occupancy
    lattice (a bake's chunk) and at 16,384, 1,000 and 37 uniform points,
    for the same two SIRENs; the uniform sets also as the first points of
    a 65,536-point batch: the kernel's errors against the plain version
    there, the plain version's own change between the two calls (cuBLAS
    picks its GEMM, and so its order of the k sum, by the number of rows),
    and whether the kernel gives those points the same bits in either;
  * the three kernels' times (the renders at 1024 x 256, medians of 7 and
    5 launches; the field forward at 65,536 lattice points, median of 7),
    in two passes over the values, the second in reverse order.

    python3 chip_tie_margin.py [--hidden H[,H...]] [TIE_ULPS ...]
        (integers; default: hidden 256, TIE_ULPS 0 4 8 16 32 64)

``--hidden`` sweeps SIRENs of those widths (256, 512, 768 or 1024, with
lego_siren.txt's 32-column direction encoding), each built with its plan's
-D flags (``nerf_tpu_torch/ops/cuda/siren_plan.py``). A value of 0
recomputes only exact midpoints. The builds go to ``build/tie_margin/``
(which .gitignore lists). Needs a CUDA device and ``nvcc``; imports nothing
of JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LIBS = ("fused_render_siren_fwd_tc", "fused_render_siren_train_tc", "fused_siren_fwd_tc")
LINE = "constexpr int TIE_ULPS = H / 8;"


def build_variants(build, values, widths) -> dict:
    """One directory of sources and the three libraries per (value, width),
    each width with its plan's -D flags, built by one nvcc per library, all
    started together."""
    from nerf_tpu_torch.ops.cuda.siren_plan import plan

    out, jobs = {}, []
    for v in values:
        for h in widths:
            d = ROOT / "build" / "tie_margin" / f"ulps_{v}_h{h}"
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(ROOT / "nerf_tpu_torch" / "csrc", d)
            common = d / "fused_render_siren_tc_common.cuh"
            src = common.read_text()
            if LINE not in src:
                raise SystemExit(f"{LINE!r} not in {common.name}")
            common.write_text(src.replace(LINE, f"constexpr int TIE_ULPS = {v};"))
            out[v, h] = d
            for lib in LIBS:
                jobs.append(subprocess.Popen(
                    [build._nvcc(), *build.NVCC_FLAGS, *plan(h, 32).defines, "-o",
                     str(d / f"{lib}.so"), str(d / f"{lib}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in jobs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(log)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerf_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    args = sys.argv[1:]
    widths = [256]
    if args[:1] == ["--hidden"]:
        widths = [int(x) for x in args[1].split(",")]
        args = args[2:]
    values = [int(x) for x in args] or [0, 4, 8, 16, 32, 64]
    dirs = build_variants(build, values, widths)
    build.build()
    for h in widths:
        sweep(h, values, {v: dirs[v, h] for v in values}, build.library, dev)
    return 0


def sweep(h: int, values: list, dirs: dict, library, dev) -> None:
    """The errors and times of every value at hidden ``h`` (the builds in
    ``dirs`` by value)."""
    import numpy as np
    import torch

    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda import fused_render_siren as frs
    from nerf_tpu_torch.ops.cuda import fused_siren as fs
    from nerf_tpu_torch.ops.occupancy import lattice

    def use(v):
        for mod in (frs, fs):
            mod.library = lambda name, tag="", defines=(): (
                ctypes.CDLL(str(dirs[v] / f"{name}.so")) if name in LIBS
                else library(name, tag, defines))
            mod._library.cache_clear()

    def inputs(r, s, seed):
        rng = np.random.default_rng(seed)
        ro = rng.uniform(2.5, 3.5, (r, 3))
        rd = rng.normal(size=(r, 3))
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(2.0, 6.0, (r, s)), axis=-1)
        return tuple(torch.from_numpy(x.astype(np.float32)).to(dev) for x in (ro, rd, t))

    def siren(seed):
        model = SirenModel(hidden_dim=h, compute_dtype="bfloat16",
                           generator=torch.Generator().manual_seed(seed)).to(dev)
        return model, frs.FusedSirenRender(model, 2.0, 6.0)

    def field_points(n, seed):
        if n == 65536:
            pts = lattice(64, (-2.75, -1.25), dev)[:n]
            return pts, torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3).contiguous()
        rng = np.random.default_rng(seed)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                     for x in (rng.uniform(-2.75, -1.25, (n, 3)), d))

    def in_batch(field, pts, d, n, mseed, refs, rgb, sigma, scale):
        """The same points as the first n of a 65,536-point batch (padded
        with lattice points): cuBLAS picks its float32 GEMM by the batch's
        size, and at a thousand rows or fewer may sum k in another order
        than the sequential one the near-tie recompute follows. Returns the
        kernel's errors against the plain version on the batch, the plain
        version's own change between the two, and whether the kernel gives
        the n points the same bits alone (a ragged last chunk) as in the
        batch."""
        fill_p, fill_d = field_points(65536, 0)
        bp, bd = torch.cat([pts, fill_p[n:]]), torch.cat([d, fill_d[n:]])
        key = ("field in batch", mseed, n)
        if key not in refs:
            refs[key] = tuple(x[:n] for x in fs.siren_field_plain(field.packed, bp, bd,
                                                                  field.consts))
        b_rgb, b_sigma = refs[key]
        k_rgb, k_sigma = (x[:n] for x in field._forward(field.packed, bp, bd))
        ref_rgb, ref_sigma = refs[("field", mseed, n)]
        same = torch.equal(k_rgb, rgb) and torch.equal(k_sigma, sigma)
        return (f"; in a 65536 batch: rgb={float((rgb - b_rgb).abs().max()):.3e} "
                f"sigma={float((sigma - b_sigma).abs().max()) / scale:.3e}, the plain "
                f"version's own change sigma={float((ref_sigma - b_sigma).abs().max()) / scale:.3e}"
                f", the kernel's bits alone and in the batch {'equal' if same else 'DIFFER'}")

    def median_ms(fn, reps):
        out = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    refs = {}
    for v in values:
        use(v)
        with torch.no_grad():
            for mseed, iseed in ((2, 6), (5, 11)):
                model, fr = siren(mseed)
                packed = fr.pack(model)
                for r, s in ((1024, 256), (1000, 256), (1024, 37)):
                    ro, rd, t = inputs(r, s, iseed)
                    o_aff, d_aff = fr.affine(ro, rd)
                    key = ("fwd", mseed, r, s)
                    if key not in refs:
                        refs[key] = frs.fused_siren_render_plain(packed, o_aff, d_aff, rd, t,
                                                                 fr.consts)
                    got = fr._forward(packed, o_aff, d_aff, rd, t)
                    print(f"hidden {h} TIE_ULPS={v} forward SIREN seed {mseed} {r}x{s}: "
                          + " ".join(f"{n}={float((a - b).abs().max()):.3e}" for n, a, b in
                                     zip(("rgb", "acc", "depth", "weights"), got,
                                         refs[key])), flush=True)
                field = fs.SirenField(model).pack()
                for n in (65536, 16384, 1000, 37):
                    pts, d = field_points(n, iseed + n)
                    key = ("field", mseed, n)
                    if key not in refs:
                        refs[key] = fs.siren_field_plain(field.packed, pts, d, field.consts)
                    rgb, sigma = field._forward(field.packed, pts, d)
                    ref_rgb, ref_sigma = refs[key]
                    scale = max(1.0, float(ref_sigma.abs().max()))
                    line = (f"hidden {h} TIE_ULPS={v} field forward SIREN seed {mseed} {n}: "
                            f"rgb={float((rgb - ref_rgb).abs().max()):.3e} "
                            f"sigma={float((sigma - ref_sigma).abs().max()) / scale:.3e} "
                            f"(over {scale:.3g})")
                    if n < 65536:
                        line += in_batch(field, pts, d, n, mseed, refs, rgb, sigma, scale)
                    print(line, flush=True)
            model, fr = siren(4)
            packed = fr.pack(model)
            for r, s in ((1024, 256), (133, 64)):
                ro, rd, t = inputs(r, s, 1)
                tgt = torch.rand(r, 3, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(2))
                o_aff, d_aff = fr.affine(ro, rd)
                key = ("train", r, s)
                if key not in refs:
                    refs[key] = frs.fused_siren_train_plain(packed, o_aff, d_aff, rd, t, tgt,
                                                            True, fr.consts)
                ref = refs[key]
                got = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
                g, gr = frs.grad_views(*got[4], h), frs.grad_views(*ref[4], h)
                floor = 1e-2 * max(float(x.abs().max()) for x in gr.values())
                ge = {k: float((g[k] - gr[k]).abs().max()) / max(float(gr[k].abs().max()), floor)
                      for k in gr}
                worst = max(ge, key=ge.get)
                print(f"hidden {h} TIE_ULPS={v} train pass {r}x{s}: "
                      f"loss={float(abs(got[0] - ref[0]) / abs(ref[0])):.2e} " + " ".join(
                          f"{n}={float((got[i] - ref[i]).abs().max()):.3e}"
                          for i, n in ((1, "rgb"), (2, "acc"), (3, "weights")))
                      + f" worst gradient {worst}={ge[worst]:.2e}", flush=True)
    times = {}
    for v in values + values[::-1]:
        use(v)
        with torch.no_grad():
            model, fr = siren(2)
            packed = fr.pack(model)
            ro, rd, t = inputs(1024, 256, 6)
            o_aff, d_aff = fr.affine(ro, rd)
            tgt = torch.rand(1024, 3, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(2))
            field = fs.SirenField(model).pack()
            pts, d = field_points(65536, 0)
            fwd = lambda: fr._forward(packed, o_aff, d_aff, rd, t)  # noqa: E731
            train = lambda: fr._train(packed, o_aff, d_aff, rd, t, tgt, True)  # noqa: E731
            fld = lambda: field._forward(field.packed, pts, d)  # noqa: E731
            fwd(), train(), fld()
            times.setdefault(v, []).append((median_ms(fwd, 7), median_ms(train, 5),
                                            median_ms(fld, 7)))
    for v in values:
        print(f"hidden {h} TIE_ULPS={v} 1024x256: forward "
              + " / ".join(f"{a:.3f}" for a, _, _ in times[v]) + " ms, train pass "
              + " / ".join(f"{b:.3f}" for _, b, _ in times[v]) + " ms; field forward at "
              "65536: " + " / ".join(f"{c:.3f}" for _, _, c in times[v]) + " ms", flush=True)
    refs.clear()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
