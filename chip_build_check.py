#!/usr/bin/env python3
"""Bit-for-bit check of the port's kernels across two checkouts, on one
GPU.

A change to the kernel pieces that several kernels share
(``nerf_tpu_torch/csrc/render_common.cuh``, ``fused_kilonerf_common.cuh``,
``grid_common.cuh``) must leave the kernels it did not mean to touch
computing what they computed. This script runs, on seeded inputs with the
checkout it is given, the NeRF and SIREN forward renders, train passes and
render backwards and the GaborNet forward render (300 x 37 and 1024 x 64,
float32 and bfloat16); the GaborNet train pass (row 12, both dtypes) at
those shapes, and its field forward and backward (rows 13 and 14, both
dtypes) at 5,003 and 37 points; the NeRF and SIREN field
forward and backward (rows 1, 2, 9 and 10, both dtypes) at those points;
the KiloNeRF field's parameter gradients under a
loss linear in its outputs (row 16's kernel, which the forward's outputs do
not reach) and its outputs (row 15, both dtypes); the grid
interpolation of row 17 at training-ray and image-ray points (28 channels)
and at 1, 5, 25 and 32 channels; row 18's
fused grid render in its SH form (a Plenoxels grid) and, where the
checkout has it, its factor form (a baked FastNeRF cache), both dtypes; and
row 19's sums at uniform, clustered and one-row ids. It saves every output
and compares two such files with ``torch.equal``, listing the outputs that
only one file holds (a form the other checkout lacks) apart:

    # in each checkout (this one, and e.g. the parent unpacked by
    # `git archive` into a directory .gitignore lists)
    python3 chip_build_check.py save OUT.pt [CHECKOUT]
    python3 chip_build_check.py compare A.pt B.pt

``CHECKOUT`` (default: this script's directory) is put first on the path,
so that one copy of this script can drive an older checkout. Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys


def _inputs(torch, dev, num_rays: int, s: int, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.nn.functional.normalize(
        torch.randn(num_rays, 3, generator=g, device=dev), dim=-1) * 4.0
    look = torch.randn(num_rays, 3, generator=g, device=dev) * 0.3 - cam
    rays_d = torch.nn.functional.normalize(look, dim=-1)
    t = torch.sort(2.0 + 4.0 * torch.rand(num_rays, s, generator=g, device=dev),
                   dim=-1).values
    return cam, rays_d, t, torch.rand(num_rays, 3, generator=g, device=dev)


def render(torch, dev, fr, model, label: str, res: dict) -> None:
    """The forward render, train pass and render backward of ``fr`` (a
    family's FusedRender of ``model``) at both shapes, into ``res``."""
    with torch.no_grad():
        packed = fr.pack(model)
        for r, s in ((300, 37), (1024, 64)):
            key = f"{label} {r}x{s}"
            ro, rd, t, tgt = _inputs(torch, dev, r, s, r + s)
            for k, v in fr(packed, ro, rd, rd, t).items():
                res[f"fwd {key} {k}"] = v.cpu()
            o_aff, d_aff = fr.affine(ro, rd)
            loss, rgb, acc, weights, (gw, gv) = fr._train(
                packed, o_aff, d_aff, rd, t, tgt, True)
            for k, v in (("loss", loss), ("rgb", rgb), ("acc", acc),
                         ("weights", weights), ("gw", gw), ("gv", gv)):
                res[f"train {key} {k}"] = v.cpu()
            g_ray = torch.randn(r, 8, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(3))
            g_ray[:, 5:] = 0
            gw, gv = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
            res[f"bwd {key} gw"], res[f"bwd {key} gv"] = gw.cpu(), gv.cpu()


def kilonerf(torch, dev, res: dict) -> None:
    """Row 16's parameter gradients and row 15's outputs (both dtypes, the
    outputs in point order) at 5,003 camera-ray points and 37 points."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField

    for cdt in ("float32", "bfloat16"):
        model = KiloNeRFModel(grid_res=8, hidden_dim=32, compute_dtype=cdt,
                              domain=(-2.75, -1.25),
                              generator=torch.Generator().manual_seed(7)).to(dev)
        for n in (5003, 37):
            ro, rd, t, _ = _inputs(torch, dev, n, 1, n)
            pts = 2.0 * (ro + t * rd - 2.0) / 4.0 - 1.0
            g = torch.Generator(device=dev).manual_seed(n + 1)
            a = torch.randn(n, 3, generator=g, device=dev)
            b = torch.randn(n, generator=g, device=dev)
            model.zero_grad(set_to_none=True)
            rgb, sigma = KiloNeRFField(model)(pts, rd)
            (torch.sum(rgb * a) + torch.sum(sigma * b)).backward()
            for name, p in model.named_parameters():
                res[f"kilonerf bwd {cdt} {n} {name}"] = p.grad.cpu()
            res[f"kilonerf fwd {cdt} {n} rgb"] = rgb.detach().cpu()
            res[f"kilonerf fwd {cdt} {n} sigma"] = sigma.detach().cpu()


def gabor_train_and_field(torch, dev, res: dict) -> None:
    """Row 12 (loss, rgb, acc, weights, the gradients and dA..dR) at 300 x
    37 and 1024 x 64, rows 13 and 14 (rgb and sigma; the weight and bank
    gradients and the point and direction cotangents of a seeded
    cotangent) at 5,003 and 37 points, each in both dtypes."""
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender, gabor_coeffs

    for cdt in ("float32", "bfloat16"):
        model = GaborModel(compute_dtype=cdt,
                           generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedGaborRender(model, 2.0, 6.0)
        gp = fr.pack(model)
        for r, s in ((300, 37), (1024, 64)):
            ro, rd, t, tgt = _inputs(torch, dev, r, s, r + s)
            coeffs = gabor_coeffs(*gp.filters, *fr.affine(ro, rd))
            loss, rgb, acc, weights, (gw, gv), dcoef = fr._train(
                gp.packed, coeffs, rd, t, tgt, True)
            for k, v in (("loss", loss), ("rgb", rgb), ("acc", acc), ("weights", weights),
                         ("gw", gw), ("gv", gv), ("dcoef", dcoef)):
                res[f"gabor train {cdt} {r}x{s} {k}"] = v.cpu()
        field = GaborField(model).pack()
        for n in (5003, 37):
            ro, rd, t, _ = _inputs(torch, dev, n, 1, n)
            pts = 0.5 * (ro + t * rd)
            rgb, sigma = field._forward(field.packed, pts, rd)
            res[f"gabor field fwd {cdt} {n} rgb"] = rgb.cpu()
            res[f"gabor field fwd {cdt} {n} sigma"] = sigma.cpu()
            cot = torch.randn(n, 4, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(n + 1))
            for k, v in zip(("gw", "gv", "gf", "dpts", "ddirs"),
                            field._backward(field.packed, pts, rd, cot)):
                res[f"gabor field bwd {cdt} {n} {k}"] = v.cpu()


def nerf_siren_field(torch, dev, res: dict) -> None:
    """Rows 1, 2, 9 and 10 in both dtypes (rgb and sigma; the weight
    gradients and the point and direction cotangents of a seeded cotangent)
    at 5,003 and 37 points."""
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
    from nerf_tpu_torch.ops.cuda.fused_siren import SirenField

    for family, model_cls, field_cls in (("nerf", NeRFModel, NerfField),
                                         ("siren", SirenModel, SirenField)):
        for cdt in ("float32", "bfloat16"):
            model = model_cls(compute_dtype=cdt,
                              generator=torch.Generator().manual_seed(7)).to(dev)
            field = field_cls(model).pack()
            for n in (5003, 37):
                ro, rd, t, _ = _inputs(torch, dev, n, 1, n)
                pts = 0.5 * (ro + t * rd)
                rgb, sigma = field._forward(field.packed, pts, rd)
                res[f"{family} field fwd {cdt} {n} rgb"] = rgb.cpu()
                res[f"{family} field fwd {cdt} {n} sigma"] = sigma.cpu()
                cot = torch.randn(n, 4, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(n + 1))
                for k, v in zip(("gw", "gv", "dpts", "ddirs"),
                                field._backward(field.packed, pts, rd, cot)):
                    res[f"{family} field bwd {cdt} {n} {k}"] = v.cpu()


def grids(torch, dev, res: dict) -> None:
    """Row 17 on a seeded 64^3 x 28 grid (float32 and its bfloat16 copy) at
    2,048 x 16 points of random rays and of one view's rays, and on 24^3
    grids of 1, 5, 25 and 32 channels at 5,003 points; row 18 at those
    rays (``grid_render``); row 19 at 131,072 x 28 rows of uniform ids, of
    ids in a few hundred rows and of one id."""
    from nerf_tpu_torch.ops.cuda.fused_grid import grid_interp, pack_grid
    from nerf_tpu_torch.ops.cuda.scatter_add import scatter_add_rows

    g = torch.Generator(device=dev).manual_seed(17)
    grid = torch.randn(64, 64, 64, 28, generator=g, device=dev)
    ro, rd, t, _ = _inputs(torch, dev, 2048, 16, 17)
    look = torch.nn.functional.normalize(
        torch.stack(torch.meshgrid(torch.linspace(-0.2, 0.2, 64, device=dev),
                                   torch.linspace(-0.2, 0.2, 32, device=dev),
                                   indexing="xy"), -1).reshape(-1, 2), dim=-1)
    view = torch.nn.functional.normalize(
        torch.cat([look, -torch.ones(2048, 1, device=dev)], -1), dim=-1)
    cam = torch.tensor([0.0, 0.0, 4.0], device=dev).expand(2048, 3)
    for label, o, d in (("random", ro, rd), ("view", cam, view)):
        pts = 2.0 * (o[:, None, :] + t[..., None] * d[:, None, :] - 2.0) / 4.0 - 1.0
        for dtype in ("float32", "bfloat16"):
            src = pack_grid(grid, dtype)
            src = grid if src is None else src
            res[f"grid_interp {dtype} {label}"] = grid_interp(src, pts.reshape(-1, 3)).cpu()
    # other channel counts (the baked FastNeRF cache's 25, the ends of 1..32)
    gc = torch.Generator(device=dev).manual_seed(170)
    pts = 2.4 * torch.rand(5003, 3, generator=gc, device=dev) - 1.2
    for c in (1, 5, 25, 32):
        grid_c = torch.randn(24, 24, 24, c, generator=gc, device=dev)
        for dtype in ("float32", "bfloat16"):
            src = pack_grid(grid_c, dtype)
            src = grid_c if src is None else src
            res[f"grid_interp {dtype} C={c}"] = grid_interp(src, pts).cpu()
    grid_render(torch, dev, res, ro, rd, t, cam, view)
    rows, n = 64 ** 3, 131072
    vals = torch.randn(n, 28, generator=g, device=dev)
    for label, ids in (("uniform", torch.randint(0, rows, (n,), generator=g, device=dev)),
                       ("clustered", torch.randint(0, 300, (n,), generator=g, device=dev) * 7),
                       ("one id", torch.full((n,), 4242, device=dev, dtype=torch.long))):
        res[f"scatter_add {label}"] = scatter_add_rows(ids, vals, rows).cpu()


def grid_render(torch, dev, res: dict, ro, rd, t, cam, view) -> None:
    """Row 18 at 2,048 x 16 random and one view's rays: the SH form on a
    seeded 64^3 x 28 Plenoxels grid, and the factor form on the 64^3 bake
    of a seeded FastNeRF (hidden 64), each in float32 and bfloat16."""
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender

    renders = {}
    for dtype in ("float32", "bfloat16"):
        model = PlenoxelsModel(grid_res=64, interp_dtype=dtype).to(dev)
        g = torch.Generator(device=dev).manual_seed(18)
        model.grid.normal_(0.0, 0.7, generator=g)
        renders[f"sh {dtype}"] = (FusedGridRender(model, 2.0, 6.0), model.precompute())
    try:
        from nerf_tpu_torch.models.fastnerf import BakedFastNeRF, FastNeRFModel
        from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedFactorRender
    except ImportError:
        pass                              # a checkout without the factor form
    else:
        cache = FastNeRFModel(hidden_dim=64, generator=torch.Generator().manual_seed(18)
                              ).to(dev).bake(grid_res=64, dir_res=16)
        f32 = BakedFastNeRF(cache.pos_grid, cache.beta_grid, cache.num_factors)
        renders["factors float32"] = (FusedFactorRender(f32, 2.0, 6.0), f32)
        renders["factors bfloat16"] = (FusedFactorRender(cache, 2.0, 6.0), cache)
    for name, (fr, params) in renders.items():
        for label, o, d in (("random", ro, rd), ("view", cam, view)):
            for k, v in fr(params, o.contiguous(), d, d, t).items():
                res[f"grid_render {name} {label} {k}"] = v.cpu()


def save(out: str, checkout: str) -> int:
    sys.path.insert(0, checkout)
    import torch

    if not torch.cuda.is_available():
        print("chip_build_check: no CUDA device", file=sys.stderr)
        return 2
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    for cdt in ("float32", "bfloat16"):
        for family, model_cls, render_cls in (("", NeRFModel, FusedNerfRender),
                                              ("siren ", SirenModel, FusedSirenRender)):
            model = model_cls(compute_dtype=cdt,
                              generator=torch.Generator().manual_seed(7)).to(dev)
            render(torch, dev, render_cls(model, 2.0, 6.0), model, family + cdt, res)
        gabor = GaborModel(compute_dtype=cdt,
                           generator=torch.Generator().manual_seed(7)).to(dev)
        gr = FusedGaborRender(gabor, 2.0, 6.0)
        with torch.no_grad():
            for r, s in ((300, 37), (1024, 64)):
                ro, rd, t, _ = _inputs(torch, dev, r, s, r + s)
                for k, v in gr(gabor, ro, rd, rd, t).items():
                    res[f"gabor fwd {cdt} {r}x{s} {k}"] = v.cpu()
    with torch.no_grad():
        gabor_train_and_field(torch, dev, res)
        nerf_siren_field(torch, dev, res)
    kilonerf(torch, dev, res)
    with torch.no_grad():
        grids(torch, dev, res)
    torch.cuda.synchronize()
    torch.save(res, out)
    print(f"chip_build_check: saved {len(res)} outputs of {checkout} to {out}")
    return 0


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    for path, only in ((a_path, sorted(set(a) - set(b))), (b_path, sorted(set(b) - set(a)))):
        if only:
            print(f"chip_build_check: {len(only)} outputs only in {path}: {only}")
    shared = [k for k in a if k in b]
    differ = [k for k in shared if not torch.equal(a[k], b[k])]
    for k in differ:
        print(f"  differs: {k}, max abs {float((a[k] - b[k]).abs().max()):.3e}")
    print(f"chip_build_check: {len(shared) - len(differ)} of {len(shared)} shared outputs "
          f"bit-identical")
    return 1 if differ or not shared else 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "save":
        return save(argv[1], argv[2] if len(argv) > 2
                    else os.path.dirname(os.path.abspath(__file__)))
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
