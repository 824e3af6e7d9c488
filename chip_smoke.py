#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero with no result:

  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. the build of every kernel library from the sources in the checkout
     (one nvcc per source, started together), timed;
  3. every kernel against its plain PyTorch version on the card (TF32 off):
     the forward render at the serving shapes (8192 rays x 64 and 192
     samples), the train pass and the render backward at the training
     shapes (1024 rays x 64, 192 and 256 samples), hidden 256, float32 and
     bfloat16: max errors against stated tolerances, the two backward
     routes against each other, median times in turns (plain, kernel,
     kernel, plain), the least time the card could take, and the share
     reached;
  4. serving: a synthetic 400x400 Blender scene, the configs/lego.txt model
     (full width, hierarchical 64+128, bfloat16) initialised from a seed and
     saved as a checkpoint, RenderService on cuda behind the HTTP server on
     loopback, four requests (/health, /pose/0, /pose/1, /render?m=...).
     Each image request must give a 400x400 PNG and launch the fused render
     kernel exactly 2 x ceil(160000/8192) = 40 times; one served image is
     held against the unfused PyTorch render of the same request;
  5. training: fit() on configs/lego.txt with the synthetic scene, 200
     iterations, logs every 10, validation and saves every 100: finite
     losses, the mse at iteration 190 under half of the one at 0, exactly
     2 x 200 train-kernel launches and 40 forward launches (the
     validation image), the interval and final checkpoints; then a resume
     from the step-100 checkpoint to 120 that restores step, parameters and
     Adam moments exactly and repeats the first run's mse bit for bit; then
     three steps through the render route (render_rays through the
     forward kernel, then its backward kernel under autograd); the train
     rate of the lego.txt step;
  6. bench.py's headline protocol (flat NeRF, bf16, 1024 rays x 256
     samples, white background, a 1<<20 synthetic pool on the card, warm-up,
     timed chained steps) in rays/s, and a torch.profiler trace of one
     lego.txt step: the train kernel's share of wall time, the other
     kernels, the device idle share;
  7. the SIREN kernels against their plain versions on the card (TF32
     off): the forward render at configs/lego_siren.txt's chunk and samples
     (1024 rays x 256), a ragged ray count (1000 x 256) and an odd S (1024 x
     37), the train pass and the render backward at 1024 x 256, float32 and
     bfloat16, timed in turns against their plain versions and their bound;
  8. serving configs/lego_siren.txt (SIREN, coarse-only 256 samples, chunk
     1024, bf16) as in 4: each image request must give a 400x400 PNG and
     launch the SIREN forward kernel exactly ceil(160000/1024) = 157 times,
     one image held against the unfused render;
  9. training configs/lego_siren.txt as in 5: 200 iterations, finite losses,
     the mse at 190 under that at 0 (the ratio is printed), exactly 200
     train-kernel launches and 157 forward launches (the validation image),
     a bit-identical resume from step 100 to 120, three render-route steps
     with 3 backward launches, the train rate of the lego_siren step and a
     profile of one step; then bench.py's train_siren protocol (flat SIREN,
     bf16, 1024 x 256, the 1<<20 pool, warm-up, 50 chained steps timed to a
     host fetch) in rays/s;
 10. the GaborNet kernels against their plain versions on the card (TF32
     off): the forward render at 1024 x 256, 1000 x 256 and 1024 x 37, the
     train pass at 1024 x 256 (loss, rgb, acc, weights, every weight
     gradient, the coefficient cotangents dA..dR, and the filter gradients
     after autograd through the prep), float32 and bfloat16, timed in turns
     against their plain versions and their bound;
 11. serving configs/lego_siren.txt with model_type = gabor (GaborNet, 8
     stages, hidden 256, coarse-only 256 samples, chunk 1024, bf16) as in 8:
     157 Gabor forward launches per request, one image held against the
     unfused render;
 12. training it as in 9 (200 train launches, 157 validation forward
     launches, the mse at 190 under that at 0, a bit-identical resume, a
     profile of one step); the forward render under autograd must raise
     NotImplementedError (the JAX render route has no VJP either); then
     bench.py's train_gabor protocol (flat GaborNet, bf16, 1024 x 256, as
     train_siren) in rays/s;
 13. the KiloNeRF field kernels (forward and backward) against their plain
     versions on the card (TF32 off), 512 networks of hidden 32 at L =
     10/4, float32 and bfloat16, on 1024 x 256 camera-ray samples
     normalised like the renderer's, 16,384 points uniform over the domain
     (the distillation batch), 5,000 points in one voxel and 37 points
     (empty networks: exactly zero gradients); both timed in turns at the
     camera set (runs of 20 launches per pair of events) against their
     bound;
 14. serving the kilonerf config (lego_siren.txt with model_type =
     kilonerf, hidden_dim = 32, grid_res = 8: coarse-only 256 samples,
     chunk 1024, bf16) as in 8: 157 forward launches per request, one
     image held against the unfused module render;
 15. training it with distillation: a teacher (the same config with
     model_type = nerf, use_pallas = false) for 100 steps, then fit() of
     kilonerf distilling it (100 steps of 16,384 points; the last loss under
     the first) and training 200 steps (the mse at 190 under that at 0),
     with the launches of both kernels counted, a bit-identical resume from
     step 100 (no distillation) and a profile of one step;
 16. bench.py's train_kilonerf protocol (bf16, 1024 x 256, the 1<<20 pool,
     16 warm-up steps, 40 timed chained steps) in rays/s;
 17. the NeRF field kernels (forward and backward) against their plain
     versions on the card (TF32 off), configs/lego.txt's model (hidden 256,
     L = 10/4), float32 and bfloat16: rgb, sigma and every gradient
     (weights, points, directions) on the first 65,536 points of the 64^3
     occupancy lattice over grid_domain, 16,384 uniform points with
     normal-then-normalised directions (the distillation draw), 1,000 and
     37 points (ragged chunks); both timed in turns at 65,536 and 16,384
     points (runs of 20 launches per pair of events) against their bound;
 18. serving lego.txt with --occupancy 64 from phase 5's trained
     checkpoint: the bake's four field-kernel launches and occupied share,
     the kernel-baked grid against the grids baked through the field's
     plain version (equal) and through the module (cells counted), three
     400x400 requests (40 render launches each, no field launch), each
     within mean abs 1e-2 of the unfused render with the same grid, their
     times and a profile of one; then a prior baked at the lattice's
     median density, which must move the coarse samples into occupied
     cells and render within 1e-2 of the unfused render with it;
 19. training lego.txt with NeRF distillation and occupancy: phase 5's
     checkpoint as the teacher of a seeded student, 100 distillation steps
     of 16,384 points (the loss falls; 200 field forward and 100 field
     backward launches), then 200 photometric steps with occupancy_res = 64
     and occupancy_interval = 100 (the mse at 190 under half of that at 0),
     a bit-identical resume from step 100, the step's rate and a profile of
     one occupancy-guided step;
 20. the SIREN and GaborNet field kernels (forward and backward) against
     their plain versions on the card (TF32 off), lego_siren.txt's model
     (hidden 256, 8 layers / stages), float32 and bfloat16, on phase 17's
     point sets: rgb, sigma and every gradient (weights, the GaborNet's
     filter banks after autograd through the packing, points, directions);
     each timed in turns at 65,536 and 16,384 points (runs of 20 launches
     per pair of events) against its bound;
 21. serving lego_siren.txt and its GaborNet variant with --occupancy 64
     from phase 9's and phase 12's checkpoints: four field-kernel launches
     per bake, the grid equal to the one baked through the plain version,
     three 400x400 requests (157 render launches each, no field launch),
     each within mean abs 1e-2 of the unfused render with the same grid,
     their times and a profile of one;
 22. cross-family distillation through fit(): a GaborNet student of
     lego_siren.txt from phase 9's SIREN checkpoint, and a SIREN student
     from phase 12's GaborNet checkpoint, each 100 distillation steps of
     16,384 points (the loss falls; 100 teacher forward, 100 student
     forward and 100 student backward launches), then 100 photometric
     steps (the mse at 90 under that at 0; one validation image, 157
     forward launches) and the step's rate.

 23. the voxel-grid kernels against their plain versions on the card (TF32
     off), a 128^3 x 28 grid (the plenoxels config's) with seeded values:
     the trilinear interpolation (row 17) at 1024 x 64 and 1024 x 256
     points of random training rays and of tile-ordered camera rays,
     float32 and bfloat16, beside F.grid_sample; the sorted scatter-add
     (row 19) at the training step's 8 x 262,144 rows x 28 (the step's
     corner ids, uniform ids, one id 65,536 times) against float64 sums,
     twice for identical bits, beside index_add_ on unsorted and sorted
     ids; the fused grid render (row 18) at 1024 x 256, 1000 x 256 and
     1024 x 37, float32 and bfloat16; each timed in turns against its bytes
     bound;
 24. serving the plenoxels config (lego_siren.txt with model_type =
     plenoxels, learning_rate = 0.01; grid 128^3, bf16 interpolation,
     chunk 1024, 256 samples) from a seeded checkpoint as in 8: 157 fused
     grid render launches per request (rays in 8x8 pixel blocks), one image
     within mean abs 1e-2 of the unfused render through the module with
     float32 interpolation;
 25. training it: 200 iterations with tv_lambda 1e-5 and tv_sh_lambda 1e-3
     (finite losses, the mse at 190 under that at 0, one interpolation and
     one scatter launch a step, 157 render launches for the validation
     image), a bit-identical resume from step 100, a profile of one step;
     then 100 iterations from grid_res 64 with upsample_steps = 50:128,
     whose checkpoint reads grid_res 128 and whose resume restores 128^3;
 26. bench.py's train_plenoxels (S = 64), train_plenoxels_occ (S = 16, an
     all-ones 32^3 prior) and render_plenoxels_dense (400x400, S = 256)
     protocols in rays/s.

The last lines are a JSON object of per-kernel numbers (all nineteen
kernels), the card, and ``{"ok": true, "device": {...}}``. Needs a CUDA device and this checkout;
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
R_CHECK = 8192          # rays per launch at serve (chunk_size of lego.txt)
HW = 400                # synthetic scene resolution
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# Kernel vs plain version, same inputs on the card. float32: the two sum
# the same products in another order (a 256-long f32 dot product drifts
# ~1e-7 relative per layer), so 1e-5 on values in [0, 1] and 1e-4 on depth
# (t up to 6). bfloat16: a sum that lands on the other side of a bf16
# rounding boundary changes one activation by 2^-8 relative and carries
# that through the later layers, so 1e-3 and 1e-2 on depth.
TOL = {"float32": {"rgb": 1e-5, "acc": 1e-5, "weights": 1e-5, "depth": 1e-4},
       "bfloat16": {"rgb": 1e-3, "acc": 1e-3, "weights": 1e-3, "depth": 1e-2}}
# A served 8-bit PNG against the unfused render of the same request: the
# PNG truncates to 1/255, and bfloat16 rounding points and the fast sine
# differ between the two paths, which also moves the fine samples a little.
SERVE_TOL_MEAN = 1e-2
R_TRAIN = 1024          # rays per train step (num_random_rays of lego.txt)
# Train pass / backward kernel vs plain version. Loss, rgb, acc, weights as
# the forward above (loss relative). Gradients, atol = tol * max|g| per
# tensor: float32 sums over ~2e5 points in another order, and the b10s and
# w10s gradients are sums of terms that cancel (measured 1.3e-3 of the
# max); bfloat16 rounds every dz to bf16 before each product, so one flipped
# rounding is carried through nine layers (measured 8e-3 of the max).
GRAD_TOL = {"float32": 5e-3, "bfloat16": 5e-2}
# per-sample MACs of the backward's skipped input-gradient products
# (dz1 w1^T, dz6 w6p^T, dzr0 wr0d^T at the real widths 63/63/27)
SKIPPED_MACS = 256 * 63 + 256 * 63 + 128 * 27
# SIREN at the real widths, per sample: forward MACs (3x256, 7 x 256x256,
# the 256 density row, 256x256, 283x128, 128x3), sines of the forward
# (8 x 256 + 128; the backward takes as many cosines), and the backward's
# skipped input products (dz1 w1^T, dzr0 wr0d^T)
SIREN_MACS = 3 * 256 + 7 * 256 * 256 + 256 + 256 * 256 + 283 * 128 + 128 * 3
SIREN_TRIG = 8 * 256 + 128
SIREN_SKIPPED = 256 * 3 + 128 * 27
R_SIREN, S_SIREN = 1024, 256   # lego_siren.txt: chunk_size, num_samples
# GaborNet at the real widths, per sample: forward MACs (7 x 256x256, the
# 256 density row, 256x256, 283x128, 128x3), transcendentals of the forward
# (a sine and an exponential per filter element, 8 x 256; the backward
# takes a sine and a cosine), and the backward's skipped input product
# (dzr0 wr0d^T). The kernels also read the per-ray coefficients (5 x 8 x
# 256 floats a ray; the train pass writes as many cotangents).
GABOR_MACS = 7 * 256 * 256 + 256 + 256 * 256 + 283 * 128 + 128 * 3
GABOR_TRIG = 2 * 8 * 256
GABOR_SKIPPED = 128 * 27
GABOR_COEF_BYTES = 5 * 8 * 256 * 4
# KiloNeRF at bench.py's shape (512 networks of hidden 32, L = 10/4), per
# point: forward MACs (63x32 + 32x32 + 32x33 + 59x32 + 32x3) and sines (the
# 84 encoding columns past the coordinates, one operation each on the CUDA
# cores); the backward recomputes the forward, takes the cotangent products
# (dz W^T, without dz1 W1^T and dzy Wr1d^T) and the gradient products
# (A^T dz). Bytes a point: its position and direction in (24) and its rgb
# and sigma out (16), or position, direction and the (rgb, sigma) cotangent
# in; the packed weights in (4 bytes a value in f32, 2 in bf16) and,
# backward, the float32 gradients out.
KILO_OVERRIDES = {"hidden_dim": 32, "grid_res": 8}   # lego_siren.txt -> kilonerf
KILO_MACS = 63 * 32 + 32 * 32 + 32 * 33 + 59 * 32 + 32 * 3
KILO_BWD_MACS = 3 * KILO_MACS - 63 * 32 - 27 * 32
KILO_TRIG = 60 + 24
KILO_R = 6212                    # packed floats per network
KILO_DOMAIN = (-2.75, -1.25)     # grid_domain of lego_siren.txt's settings
# Kernel vs plain version, same inputs on the card. Outputs (rgb, sigma):
# float32 sums of 32-63 products in another order, 1e-5 (as the NeRF
# kernels); bfloat16 roundings flip after such sums and move one activation
# by 2^-8 relative, 1e-3. Gradients, max abs over max |g| per tensor (the
# max floored at 1e-2 of the model's largest gradient): float32 sums over
# up to 262,144 points in another order, 1e-4; bfloat16 rounds every
# activation and cotangent before each gradient product, so one flipped
# rounding of a cotangent moves a network's sum by one term's 2^-8: 5e-4.
KILO_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
KILO_BATCH = 20        # launches per timed run of a KiloNeRF kernel
KILO_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-4}
# The NeRF field (lego.txt's MLP at L = 10/4), per point: the forward's MACs
# (mlp_macs(256, 63, 27) = 658,944) and its 84 sines; the backward
# recomputes the forward and takes the dz W^T products with the three input
# products and the A^T dz products (3 x the forward's MACs) and 84 cosines
# more. Bytes a point: position and direction in (24), rgb and sigma out
# (16); backward, the (rgb, sigma) cotangent in (16) and the point and
# direction cotangents out (24); the weights in and, backward, their
# float32 gradients out. Outputs against the plain version as the render
# kernels (TOL), gradients as the train kernels (GRAD_TOL: every dz W^T
# chain of ten layers is shared with them).
FIELD_TRIG = 84
FIELD_BATCH = 20       # launches per timed run of a field kernel
# The point and direction cotangents are per point, not sums: a point whose
# ReLU pre-activation lies within rounding of zero takes another mask in
# either version and moves its own cotangent by up to a few percent of the
# max (float32 against float64 on the CPU: 39 of the 65,536 lattice points
# beyond 1e-4 of the max, the worst at 3.7e-2; the median 1.9e-7). So each
# point's error (max abs over its coordinates, over the max |g| of the set)
# is held at its 99.9th percentile, and at most 0.1% of the points may lie
# beyond the bound; the worst is printed.
FIELD_PT_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
FIELD_DOMAIN = (-2.75, -1.25)   # grid_domain of lego.txt's settings
# The SIREN and GaborNet fields (lego_siren.txt's model, hidden 256, 8 layers
# / stages, L = 4 for the direction), per point: forward MACs (SIREN_MACS;
# GABOR_MACS plus the filters' two 3-long products per element, 8 x 2 x 3 x
# 256) and transcendentals (SIREN: a sine per layer output and head element,
# SIREN_TRIG; GaborNet: a sine and an exponential per filter element; both
# the 24 sines of the direction encoding); the backward recomputes the
# forward and takes the dz W^T products with the input products and the A^T
# dz products (3 x the forward's MACs), and the derivatives' cosines (SIREN:
# a sine and a cosine per element; GaborNet: sine, exponential and cosine
# per filter element; the encoding's 24 cosines). Bytes as the NeRF field's,
# the GaborNet's filter banks (8 x 9 x 256 floats) with the weights.
# Kernel vs plain version: (outputs, gradients, point cotangents at the
# 99.9th percentile), each as the NeRF field's (TOL, GRAD_TOL,
# FIELD_PT_TOL) but the SIREN in bfloat16. There w0 = 30 and sigma_mul = 10
# magnify one bf16 rounding that a float32 sum in another order flips: at
# 37 points (where the plain version's products run in another summation
# order than at 1,000 or more rows) the kernel and the plain version
# differed by 5.8e-4 in rgb, 1.5e-3 of max sigma in sigma and 4.2e-3 of the
# max in a point cotangent (NVIDIA H100 80GB HBM3, 700.00 W; 6e-5 and 2e-4
# at 1,000 points and more), as the port's plain version and nerf_tpu's
# Pallas kernel differ on the CPU (8.8e-4, 3.0e-3, 8.5e-3;
# tests/test_torch_port_siren_gabor_field.py): 1e-2, 5e-2 and 5e-2.
SG_TOL = {("siren", "bfloat16"): (1e-2, 5e-2, 5e-2)}
SG_FIELD = {"siren": {"macs": SIREN_MACS, "trig": (SIREN_TRIG + 24, 2 * SIREN_TRIG + 48)},
            "gabor": {"macs": GABOR_MACS + 8 * 2 * 3 * 256,
                      "trig": (2 * 8 * 256 + 24, 3 * 8 * 256 + 48)}}


# The voxel grids (PERF.md rows 17-19) at the plenoxels config's size: the
# 128^3 x 28 grid (1 density + 3 x 9 SH channels) over lego_siren.txt's
# grid_domain. Row 17 and its plain version take the same float32 operations
# in the same order (grid_common.cuh rounds each product and sum alone, as
# PyTorch's elementwise ops do): 1e-6 on values of a few units. Row 18 adds
# exp, log1p and the sigmoid (libm against PyTorch's, an ulp or two) and
# the plain version's cumprod and sums in another order: 1e-5 on rgb, acc
# and weights (in [0, 1]), 1e-4 on depth (t up to 6). Row 19 is held to
# float64 sums: a run of n rows, summed in pieces of at most K = 256 rows
# and then the pieces in order, errs by at most (K + n / K + 2) ulps of its
# sum of magnitudes; its plain version (each run in order) by (n + 2).
GRID_R, GRID_C = 128, 28
GRID_DOMAIN = (-2.75, -1.25)     # grid_domain of lego_siren.txt's settings
GRID_TOL = 1e-6
GRID_RENDER_TOL = {"rgb": 1e-5, "acc": 1e-5, "weights": 1e-5, "depth": 1e-4}
GRID_BATCH = 20        # launches per timed run of a grid kernel
SCATTER_ULPS = 256     # the scatter kernel's chunk, K
# the plenoxels config: lego_siren.txt with model_type = plenoxels and
# these overrides (models/plenoxels.py:23; the grid keeps its defaults:
# grid_res 128, sh_degree 2, interp_dtype bfloat16)
PLENOXELS_OVERRIDES = {"learning_rate": 0.01}
UPSAMPLE = (64, 128)   # phase 25's coarse-to-fine fit: from 64^3, to 128^3 at 50


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3


def mlp_macs(h: int, real_p: int, real_d: int) -> int:
    """MACs per sample of the NeRF MLP at its real widths."""
    return (real_p * h + 4 * h * h + (h + real_p) * h + 3 * h * h
            + h * (h + 1) + (h + real_d) * (h // 2) + (h // 2) * 3)


def bound_ms(num_rays: int, s: int, cdt: str, weight_bytes: int, macs: int,
             trig: int = 0, grad_bytes: int | None = None,
             train: bool = False) -> tuple:
    """Least time of a forward render (``grad_bytes`` None) or of a train
    pass / render backward over num_rays x s samples: the products (``macs``
    per sample, 2 operations each) over the compute dtype's peak, and the
    sines and cosines (``trig`` per sample, one operation each) over the
    float32 CUDA-core rate; in float32 both share the CUDA cores (their
    sum), in bfloat16 the products have the tensor cores beside them (the
    larger). Against the bytes that must move: rays, t, weights, the
    target or cotangent and the gradients, and the outputs (rgb, acc,
    depth, compositing weights)."""
    n = num_rays * s
    nbytes = 3 * num_rays * 3 * 4 + n * 4 + weight_bytes
    if grad_bytes is None:
        nbytes += num_rays * 5 * 4 + n * 4
    else:
        nbytes += grad_bytes + num_rays * (3 if train else 8) * 4
        if train:
            nbytes += num_rays * 4 * 4 + n * 4
    t_mm = 2 * macs * n / PEAK_FLOPS[cdt] * 1e3
    t_trig = trig * n / PEAK_FLOPS["float32"] * 1e3
    t_ops = t_mm + t_trig if cdt == "float32" else max(t_mm, t_trig)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_calls(torch, fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def camera_batch(torch, dev, num_rays: int, s: int, seed: int) -> tuple:
    """(rays_o, rays_d, t, target): cameras on a radius-4 sphere looking
    at the scene, as an orbit, sorted t in [2, 6], random targets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.nn.functional.normalize(
        torch.randn(num_rays, 3, generator=g, device=dev), dim=-1) * 4.0
    look = torch.randn(num_rays, 3, generator=g, device=dev) * 0.3 - cam
    rays_d = torch.nn.functional.normalize(look, dim=-1)
    t = torch.sort(2.0 + 4.0 * torch.rand(num_rays, s, generator=g, device=dev),
                   dim=-1).values
    return cam, rays_d, t, torch.rand(num_rays, 3, generator=g, device=dev)


def check_kernel(torch, dev):
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_render import (
        FusedNerfRender, fused_render_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = NeRFModel(compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedNerfRender(model, 2.0, 6.0, normalize=True)
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        for s in (64, 192):
            rays_o, rays_d, t, _ = camera_batch(torch, dev, R_CHECK, s, 1000 + s)
            o_aff, d_aff = fr.affine(rays_o, rays_d)

            def plain():
                return fused_render_plain(packed, o_aff, d_aff, rays_d, t,
                                          model.pos_encoding_dim,
                                          model.dir_encoding_dim)

            def kern():
                return fr(packed, rays_o, rays_d, rays_d, t)

            with torch.no_grad():
                ref = plain()
                out = kern()
                torch.cuda.synchronize()
                errs = {}
                for i, k in enumerate(("rgb", "acc", "depth", "weights")):
                    x = out[k]
                    if not torch.isfinite(x).all():
                        fail(f"kernel {cdt} S={s}: non-finite {k}")
                    errs[k] = float((x - ref[i]).abs().max())
                del ref, out
                torch.cuda.empty_cache()
                times = {"plain": [], "kernel": []}
                plain(); kern()                       # warm-up
                for name in ("plain", "kernel", "kernel", "plain"):
                    fn = plain if name == "plain" else kern
                    times[name] += time_calls(torch, fn, 3)
                torch.cuda.empty_cache()
            ms = statistics.median(times["kernel"])
            plain_ms = statistics.median(times["plain"])
            bms, by = bound_ms(R_CHECK, s, cdt, weight_bytes,
                               mlp_macs(256, 63, 27))
            bad = {k: v for k, v in errs.items() if v > TOL[cdt][k]}
            say(f"kernel fused_render_fwd {cdt} R={R_CHECK} S={s}: max_abs_err "
                + " ".join(f"{k}={v:.3e}(tol {TOL[cdt][k]:.0e})"
                           for k, v in errs.items())
                + f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"bound {bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
            if bad:
                fail(f"kernel {cdt} S={s} disagrees with its plain version: {bad}")
            results[(cdt, s)] = dict(err=max(errs.values()), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return results


# ---------------------------------------------------------------- phase 4

CAMERA_ANGLE_X = 0.6911112070083618  # Blender synthetic FOV


def write_sphere_scene(root: str, hw: int) -> None:
    """A Blender-format scene (one frame per split) of a shaded sphere, a
    small copy of the repository's tests/synthetic.py writer."""
    from nerf_tpu_torch.data.poses import pose_spherical
    from nerf_tpu_torch.data.rays import compute_rays_single
    from nerf_tpu_torch.utils.png import write_png

    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    for split, theta in (("train", 10.0), ("val", 100.0), ("test", 200.0)):
        c2w = pose_spherical(theta, -30.0, 4.0)
        o, d = compute_rays_single(hw, hw, focal, c2w)
        b = 2.0 * np.sum(o * d, axis=-1)
        c = np.sum(o * o, axis=-1) - 1.0
        disc = b * b - 4 * c
        tt = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
        hit = (disc > 0) & (tt > 0)
        p = o + tt[:, None] * d
        n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
        shade = 0.5 + 0.5 * np.clip(n @ np.array([0.3, 0.5, 0.8]), -1, 1)
        img = np.zeros((hw * hw, 4), np.float32)
        img[hit, :3] = np.array([0.9, 0.3, 0.2])[None] * shade[hit, None]
        img[hit, 3] = 1.0
        os.makedirs(os.path.join(root, split), exist_ok=True)
        write_png(os.path.join(root, split, "r_0.png"),
                  (img.reshape(hw, hw, 4) * 255).astype(np.uint8))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X,
                       "frames": [{"file_path": f"./{split}/r_0",
                                   "transform_matrix": c2w.tolist()}]}, f)


def get(url: str) -> tuple:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def serve(torch, dev, tmp: str, config: str, fused_cls, kernel: str,
          model_type: str | None = None, overrides: dict | None = None,
          svc=None, compare: tuple = ("/pose/1",), init=None, reference=None):
    """Phase 4 (``config`` lego.txt, the NeRF kernels), 8 (lego_siren.txt,
    the SIREN kernels), 11 (lego_siren.txt with ``model_type`` gabor, the
    GaborNet kernels) or 14 (the kilonerf config: lego_siren.txt with
    ``model_type`` kilonerf and ``overrides`` hidden_dim 32, grid_res 8;
    the KiloNeRF field kernels): a checkpoint of ``config`` from its seed,
    served on cuda over loopback; or phase 18 (``svc`` a service of
    lego.txt already built with an occupancy prior, every request in
    ``compare``); or phase 24 (the plenoxels config, ``init`` applied to
    the seeded model before the save, the unfused render through
    ``reference(model)``); returns the kernel launches of the three image
    requests."""
    label = config if model_type is None else f"{config} (model_type = {model_type})"
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.registry import model_from_config
    from nerf_tpu_torch.serve import RenderService, make_http_server, request_seed
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import make_eval_render
    from nerf_tpu_torch.utils.checkpoint import save_checkpoint
    from nerf_tpu_torch.utils.png import decode_png

    scene = os.path.join(tmp, "scene")
    if not os.path.isdir(scene):
        write_sphere_scene(scene, HW)
    if svc is None:
        cfg = parse_config_file(os.path.join(ROOT, "configs", config))
        cfg = dataclasses.replace(cfg, dataset_path=scene,
                                  save_path=os.path.join(tmp, "models"),
                                  model_type=model_type or cfg.model_type,
                                  **(overrides or {}))
        gen = torch.Generator().manual_seed(cfg.seed)
        model = model_from_config(cfg, generator=gen)
        fine = None
        if cfg.num_fine_samples > 0 and cfg.separate_fine_model:
            fine = model_from_config(cfg, generator=gen)
        if init is not None:
            init(model)
        ckpt = save_checkpoint(model, fine, cfg.save_path, cfg.model_type, 0)
        svc = RenderService.from_checkpoint(cfg, ckpt, device=dev, log=say)
    cfg = svc.cfg
    occ = svc._renderer.occupancy
    if occ is not None:
        label += f" --occupancy {occ.grid.shape[0]}"
    if svc.hw != (HW, HW):
        fail(f"service hw {svc.hw}")
    passes = 2 if cfg.num_fine_samples > 0 else 1
    per_image = passes * math.ceil(HW * HW / cfg.chunk_size)

    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    m = ",".join(str(x) for x in svc.orbit_pose(5)[:3].reshape(-1))
    images, times = {}, []
    fused_cls.launches = 0              # the main path's count starts here
    try:
        code, ctype, body = get(base + "/health")
        health = json.loads(body)
        if code != 200 or health["status"] != "ok" or health["hw"] != [HW, HW]:
            fail(f"/health: {code} {health}")
        for route in ("/pose/0", "/pose/1", f"/render?m={m}"):
            before = fused_cls.launches
            t0 = time.perf_counter()
            code, ctype, body = get(base + route)
            dt = time.perf_counter() - t0
            n = fused_cls.launches - before
            if code != 200 or ctype != "image/png" or body[:8] != b"\x89PNG\r\n\x1a\n":
                fail(f"{label} {route}: status {code}, type {ctype}")
            img = decode_png(body)
            if img.shape != (HW, HW, 3):
                fail(f"{label} {route}: image shape {img.shape}")
            if n != per_image:
                fail(f"{label} {route}: {n} fused render launches, want {per_image}")
            images[route.split("?")[0]] = img
            times.append(dt)
            say(f"serve {label} {route.split('?')[0]}: 200 image/png {HW}x{HW}, "
                f"{n} kernel launches, {dt * 1e3:.1f} ms, "
                f"{HW * HW / dt:.0f} rays/s")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = fused_cls.launches
    if launches != 3 * per_image:
        fail(f"{label}: main path launched the kernel {launches} times")

    # served images against the unfused render of the same request (with
    # the same occupancy prior)
    ref_model = svc.params[0] if reference is None else reference(svc.params[0])
    ref_render = make_eval_render(ref_model, render_settings_from_config(cfg),
                                  fused=False, occupancy=occ)
    h, w = svc.hw
    from nerf_tpu_torch.data.rays import compute_rays_single

    requests = {"/pose/0": (svc.orbit_pose(0), 0), "/pose/1": (svc.orbit_pose(1), 1),
                "/render": (svc.orbit_pose(5), 0)}
    for route in compare:
        c2w, key_idx = requests[route]
        o, d = compute_rays_single(h, w, svc.focal, c2w)
        g = torch.Generator(device=dev).manual_seed(request_seed(cfg.seed, key_idx))
        ref = ref_render(ref_model, svc.params[1], torch.from_numpy(o).to(dev),
                         torch.from_numpy(d).to(dev), g, hw=svc.hw).rgb
        ref = ref.reshape(h, w, 3).clamp(0, 1).cpu().numpy()
        if not np.isfinite(ref).all():
            fail(f"{label}: unfused reference render is not finite")
        diff = np.abs(images[route].astype(np.float32) / 255.0 - ref)
        say(f"serve {label} {route} vs unfused render: mean abs {diff.mean():.3e} "
            f"(tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}")
        if diff.mean() > SERVE_TOL_MEAN:
            fail(f"{label}: served image {route} disagrees with the unfused render")
    med = statistics.median(times)
    say(f"serve: {med * 1e3:.1f} ms per {HW}x{HW} request (median of "
        f"{len(times)}), {HW * HW / med:.0f} rays/s, {per_image} launches "
        f"per request, model {label} ({cfg.compute_dtype}, "
        f"{cfg.num_samples}+{cfg.num_fine_samples})")
    profile_device(torch, lambda: svc.render_pose(svc.orbit_pose(2), key_idx=2),
                   kernel, f"one {label} request")
    return launches


def profile_device(torch, fn, kernel: str, what: str) -> None:
    """A torch.profiler trace of ``fn()``: wall time, device busy and idle
    share, the named kernel's share (``kernel`` a name or a tuple of names,
    each one's share listed) and the other kernels' time and count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        say("profile: the trace holds no device events; device busy share "
            "not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    mine = [e for e in dev_events if any(k in e.name for k in names)]
    others = [e for e in dev_events if not any(k in e.name for k in names)]
    kernel = " + ".join(names)
    t_mine = sum(e.time_range.elapsed_us() for e in mine)
    t_other = sum(e.time_range.elapsed_us() for e in others)
    say(f"profile: {what} {wall_us / 1e3:.1f} ms wall; device busy "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.4f} of wall, idle "
        f"{1 - busy / wall_us:.4f}); {kernel} {t_mine / 1e3:.1f} ms "
        f"({t_mine / wall_us:.4f}) in {len(mine)} launches, other kernels "
        f"{t_other / 1e3:.1f} ms in {len(others)} launches")
    for label, events, top in (("kernel", mine, 3), ("other", others, 6)):
        by_name: dict = {}
        for e in events:
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
        if label == "kernel" and len(by_name) < 2:
            continue
        for name, (c, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:top]:
            say(f"  {label}: {t / 1e3:.2f} ms ({t / wall_us:.4f}) in {c} launches: "
                f"{name[:90]}")
    adam = [e for e in others if "multi_tensor_apply" in e.name]
    if adam:
        t_adam = sum(e.time_range.elapsed_us() for e in adam)
        say(f"  other: multi_tensor_apply kernels (Adam's _foreach ops) {t_adam / 1e3:.2f} ms "
            f"({t_adam / wall_us:.4f}) in {len(adam)} launches; the rest "
            f"{(t_other - t_adam) / 1e3:.2f} ms in {len(others) - len(adam)} launches")


# ---------------------------------------------------------------- phase 3b


def grad_errors(torch, got, ref, views=None) -> dict:
    """Per gradient tensor, max |kernel - plain| over max |plain|, the max
    floored at 1e-2 of the model's largest gradient element (b10s is one
    sum of terms of both signs, whose residue alone is no scale). ``views``
    names the tensors of a flat pair (default: the NeRF layout)."""
    from nerf_tpu_torch.ops.cuda.fused_render import grad_views

    views = views or grad_views
    g, r = views(*got, 256), views(*ref, 256)
    floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
    out = {}
    for k in r:
        if not torch.isfinite(g[k]).all():
            fail(f"non-finite gradient {k}")
        out[k] = float((g[k] - r[k]).abs().max()) / max(float(r[k].abs().max()), floor)
    return out


def check_grad_kernels(torch, dev):
    """The train pass and the render backward against their plain
    versions at 1024 rays x S in {64, 192, 256}, and the two backward
    routes (train kernel; backward kernel from the MSE head's cotangent)
    against each other."""
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_render import (
        FusedNerfRender, fused_render_bwd_plain, fused_train_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = NeRFModel(compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedNerfRender(model, 2.0, 6.0, normalize=True)
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        for s in (64, 192, 256):
            cam, rd, t, tgt = camera_batch(torch, dev, R_TRAIN, s, 2000 + s)
            o_aff, d_aff = fr.affine(cam, rd)
            with torch.no_grad():
                ref = fused_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, 10, 4)
                got = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
                torch.cuda.synchronize()
                errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
                for i, k in ((1, "rgb"), (2, "acc"), (3, "weights")):
                    if not torch.isfinite(got[i]).all():
                        fail(f"train kernel {cdt} S={s}: non-finite {k}")
                    errs[k] = float((got[i] - ref[i]).abs().max())
                gerr = grad_errors(torch, got[4], ref[4])
                # the MSE head's cotangent, for the backward kernel
                scale = 1.0 / (3.0 * R_TRAIN)
                err = ref[1] + (1.0 - ref[2])[:, None] - tgt
                g_ray = torch.zeros(R_TRAIN, 8, device=dev)
                g_ray[:, :3] = 2.0 * scale * err
                g_ray[:, 3] = -g_ray[:, :3].sum(-1)
                ref_b = fused_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray,
                                               10, 4)
                got_b = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
                torch.cuda.synchronize()
                berr = grad_errors(torch, got_b, ref_b)
                cross = grad_errors(torch, got_b, got[4])
                del ref, got, ref_b, got_b
                torch.cuda.empty_cache()
                fns = {
                    ("fused_render_train", "plain"): lambda: fused_train_plain(
                        packed, o_aff, d_aff, rd, t, tgt, True, 10, 4),
                    ("fused_render_train", "kernel"): lambda: fr._train(
                        packed, o_aff, d_aff, rd, t, tgt, True),
                    ("fused_render_bwd", "plain"): lambda: fused_render_bwd_plain(
                        packed, o_aff, d_aff, rd, t, g_ray, 10, 4),
                    ("fused_render_bwd", "kernel"): lambda: fr._backward(
                        packed, o_aff, d_aff, rd, t, g_ray),
                }
                times = {k: [] for k in fns}
                for f in fns.values():
                    f()                                # warm-up
                for name in ("fused_render_train", "fused_render_bwd"):
                    for which in ("plain", "kernel", "kernel", "plain"):
                        times[(name, which)] += time_calls(torch, fns[(name, which)], 2)
                torch.cuda.empty_cache()
            tol = TOL[cdt]
            bad = {k: v for k, v in errs.items() if v > tol["rgb"]}
            for label, e in (("train", gerr), ("bwd", berr), ("bwd vs train", cross)):
                worst = max(e, key=e.get)
                say(f"kernel {label} {cdt} R={R_TRAIN} S={s}: gradient error "
                    f"(max abs over max |g|) worst {worst}={e[worst]:.3e} "
                    f"(tol {GRAD_TOL[cdt]:.0e}), median "
                    f"{statistics.median(e.values()):.3e}; "
                    + " ".join(f"{k}={v:.1e}" for k, v in e.items()))
                bad.update({f"{label}:{k}": v for k, v in e.items()
                            if v > GRAD_TOL[cdt]})
            say(f"kernel train {cdt} R={R_TRAIN} S={s}: "
                + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                + f" (tol {tol['rgb']:.0e})")
            for name in ("fused_render_train", "fused_render_bwd"):
                ms = statistics.median(times[(name, "kernel")])
                plain_ms = statistics.median(times[(name, "plain")])
                bms, by = bound_ms(R_TRAIN, s, cdt, weight_bytes,
                                   3 * mlp_macs(256, 63, 27) - SKIPPED_MACS,
                                   grad_bytes=grad_bytes,
                                   train=name == "fused_render_train")
                say(f"kernel {name} {cdt} R={R_TRAIN} S={s}: kernel {ms:.3f} ms, "
                    f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), "
                    f"share of bound {bms / ms:.4f}")
                e = gerr if name == "fused_render_train" else berr
                worst = max(list(e.values()) + (list(errs.values())
                                                if name == "fused_render_train" else []))
                results[(name, cdt, s)] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                               bound_ms=bms, bound_by=by)
            if bad:
                fail(f"train/backward kernels {cdt} S={s} disagree: {bad}")
    return results


# ---------------------------------------------------------------- phase 7


def check_siren_kernels(torch, dev):
    """The SIREN forward at 1024 x 256 (lego_siren.txt's chunk and
    samples), 1000 x 256 (ragged) and 1024 x 37 (odd S); the train pass and
    the render backward at 1024 x 256, and the two backward routes against
    each other; float32 and bfloat16, TF32 off; the tolerances of the NeRF
    kernels."""
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_render_bwd_plain, fused_siren_render_plain,
        fused_siren_train_plain, grad_views)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = SirenModel(compute_dtype=cdt,
                           generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedSirenRender(model, 2.0, 6.0, normalize=True)
        k = fr.consts
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        worst = 0.0
        for r, s in ((R_SIREN, S_SIREN), (1000, S_SIREN), (R_SIREN, 37)):
            ro, rd, t, _ = camera_batch(torch, dev, r, s, 3000 + r + s)
            o_aff, d_aff = fr.affine(ro, rd)

            def plain():
                return fused_siren_render_plain(packed, o_aff, d_aff, rd, t, k)

            def kern():
                return fr._forward(packed, o_aff, d_aff, rd, t)

            with torch.no_grad():
                ref = plain()
                out = kern()
                torch.cuda.synchronize()
                errs = {}
                for i, name in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[i]).all():
                        fail(f"siren kernel {cdt} R={r} S={s}: non-finite {name}")
                    errs[name] = float((out[i] - ref[i]).abs().max())
                del ref, out
                torch.cuda.empty_cache()
                timed = (r, s) == (R_SIREN, S_SIREN)
                if timed:
                    times = {"plain": [], "kernel": []}
                    plain(); kern()                       # warm-up
                    for name in ("plain", "kernel", "kernel", "plain"):
                        fn = plain if name == "plain" else kern
                        times[name] += time_calls(torch, fn, 3)
                    torch.cuda.empty_cache()
            bad = {n: v for n, v in errs.items() if v > TOL[cdt][n]}
            line = (f"kernel fused_render_siren_fwd {cdt} R={r} S={s}: max_abs_err "
                    + " ".join(f"{n}={v:.3e}(tol {TOL[cdt][n]:.0e})"
                               for n, v in errs.items()))
            if timed:
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                bms, by = bound_ms(r, s, cdt, weight_bytes, SIREN_MACS, SIREN_TRIG)
                line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                         f"{bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
                results[("fused_render_siren_fwd", cdt)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            say(line)
            if bad:
                fail(f"siren kernel {cdt} R={r} S={s} disagrees with its plain "
                     f"version: {bad}")
            worst = max(worst, max(errs.values()))
        results[("fused_render_siren_fwd", cdt)]["err"] = worst

        # the train pass and the render backward at lego_siren.txt's shape
        r, s = R_TRAIN, S_SIREN
        cam, rd, t, tgt = camera_batch(torch, dev, r, s, 4000 + s)
        o_aff, d_aff = fr.affine(cam, rd)
        with torch.no_grad():
            ref = fused_siren_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, k)
            got = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
            torch.cuda.synchronize()
            errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
            for i, name in ((1, "rgb"), (2, "acc"), (3, "weights")):
                if not torch.isfinite(got[i]).all():
                    fail(f"siren train kernel {cdt}: non-finite {name}")
                errs[name] = float((got[i] - ref[i]).abs().max())
            gerr = grad_errors(torch, got[4], ref[4], grad_views)
            scale = 1.0 / (3.0 * r)
            err = ref[1] + (1.0 - ref[2])[:, None] - tgt
            g_ray = torch.zeros(r, 8, device=dev)
            g_ray[:, :3] = 2.0 * scale * err
            g_ray[:, 3] = -g_ray[:, :3].sum(-1)
            ref_b = fused_siren_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, k)
            got_b = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
            torch.cuda.synchronize()
            berr = grad_errors(torch, got_b, ref_b, grad_views)
            cross = grad_errors(torch, got_b, got[4], grad_views)
            del ref, got, ref_b, got_b
            torch.cuda.empty_cache()
            fns = {
                ("fused_render_siren_train", "plain"): lambda: fused_siren_train_plain(
                    packed, o_aff, d_aff, rd, t, tgt, True, k),
                ("fused_render_siren_train", "kernel"): lambda: fr._train(
                    packed, o_aff, d_aff, rd, t, tgt, True),
                ("fused_render_siren_bwd", "plain"): lambda: fused_siren_render_bwd_plain(
                    packed, o_aff, d_aff, rd, t, g_ray, k),
                ("fused_render_siren_bwd", "kernel"): lambda: fr._backward(
                    packed, o_aff, d_aff, rd, t, g_ray),
            }
            times = {key: [] for key in fns}
            for f in fns.values():
                f()                                    # warm-up
            for name in ("fused_render_siren_train", "fused_render_siren_bwd"):
                for which in ("plain", "kernel", "kernel", "plain"):
                    times[(name, which)] += time_calls(torch, fns[(name, which)], 2)
            torch.cuda.empty_cache()
        bad = {n: v for n, v in errs.items() if v > TOL[cdt]["rgb"]}
        for label, e in (("train", gerr), ("bwd", berr), ("bwd vs train", cross)):
            w = max(e, key=e.get)
            say(f"kernel siren {label} {cdt} R={r} S={s}: gradient error (max abs "
                f"over max |g|) worst {w}={e[w]:.3e} (tol {GRAD_TOL[cdt]:.0e}), "
                f"median {statistics.median(e.values()):.3e}; "
                + " ".join(f"{n}={v:.1e}" for n, v in e.items()))
            bad.update({f"{label}:{n}": v for n, v in e.items() if v > GRAD_TOL[cdt]})
        say(f"kernel siren train {cdt} R={r} S={s}: "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items())
            + f" (tol {TOL[cdt]['rgb']:.0e})")
        for name in ("fused_render_siren_train", "fused_render_siren_bwd"):
            ms = statistics.median(times[(name, "kernel")])
            plain_ms = statistics.median(times[(name, "plain")])
            bms, by = bound_ms(r, s, cdt, weight_bytes,
                               3 * SIREN_MACS - SIREN_SKIPPED, 2 * SIREN_TRIG,
                               grad_bytes, name == "fused_render_siren_train")
            say(f"kernel {name} {cdt} R={r} S={s}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share of bound "
                f"{bms / ms:.4f}")
            e = gerr if name == "fused_render_siren_train" else berr
            worst = max(list(e.values()) + (list(errs.values()) if name ==
                                            "fused_render_siren_train" else []))
            results[(name, cdt)] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bms, bound_by=by)
        if bad:
            fail(f"siren train/backward kernels {cdt} disagree: {bad}")
    return results


# ---------------------------------------------------------------- phase 10


def check_gabor_kernels(torch, dev):
    """The GaborNet forward at 1024 x 256 (lego_siren.txt's chunk and
    samples), 1000 x 256 (ragged) and 1024 x 37 (odd S: chunks span rays);
    the train pass at 1024 x 256, its coefficient cotangents dA..dR (max abs
    over max |d| per coefficient) and the filter gradients after autograd
    through the prep (as grad_errors); float32 and bfloat16, TF32 off; the
    tolerances of the NeRF kernels."""
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_render_plain, fused_gabor_train_plain,
        gabor_coeffs, grad_views, stack_filters)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = GaborModel(compute_dtype=cdt,
                           generator=torch.Generator().manual_seed(7)).to(dev)
        fr = FusedGaborRender(model, 2.0, 6.0, normalize=True)
        k = fr.consts
        gpack = fr.pack(model)
        packed = gpack.packed
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        worst = 0.0
        for r, s in ((R_SIREN, S_SIREN), (1000, S_SIREN), (R_SIREN, 37)):
            ro, rd, t, _ = camera_batch(torch, dev, r, s, 5000 + r + s)
            o_aff, d_aff = fr.affine(ro, rd)
            with torch.no_grad():
                coeffs = gabor_coeffs(*gpack.filters, o_aff, d_aff)

            def plain():
                return fused_gabor_render_plain(packed, coeffs, rd, t, k)

            def kern():
                return fr._forward(packed, coeffs, rd, t)

            with torch.no_grad():
                ref = plain()
                out = kern()
                torch.cuda.synchronize()
                errs = {}
                for i, name in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[i]).all():
                        fail(f"gabor kernel {cdt} R={r} S={s}: non-finite {name}")
                    errs[name] = float((out[i] - ref[i]).abs().max())
                del ref, out
                torch.cuda.empty_cache()
                timed = (r, s) == (R_SIREN, S_SIREN)
                if timed:
                    times = {"plain": [], "kernel": []}
                    plain(); kern()                       # warm-up
                    for name in ("plain", "kernel", "kernel", "plain"):
                        fn = plain if name == "plain" else kern
                        times[name] += time_calls(torch, fn, 3)
                    torch.cuda.empty_cache()
            bad = {n: v for n, v in errs.items() if v > TOL[cdt][n]}
            line = (f"kernel fused_render_gabor_fwd {cdt} R={r} S={s}: max_abs_err "
                    + " ".join(f"{n}={v:.3e}(tol {TOL[cdt][n]:.0e})"
                               for n, v in errs.items()))
            if timed:
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                bms, by = bound_ms(r, s, cdt, weight_bytes + r * GABOR_COEF_BYTES,
                                   GABOR_MACS, GABOR_TRIG)
                line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                         f"{bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
                results[("fused_render_gabor_fwd", cdt)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            say(line)
            if bad:
                fail(f"gabor kernel {cdt} R={r} S={s} disagrees with its plain "
                     f"version: {bad}")
            worst = max(worst, max(errs.values()))
        results[("fused_render_gabor_fwd", cdt)]["err"] = worst

        # the train pass at lego_siren.txt's shape, then the filter gradients
        # through the prep from each side's dA..dR
        r, s = R_TRAIN, S_SIREN
        cam, rd, t, tgt = camera_batch(torch, dev, r, s, 6000 + s)
        o_aff, d_aff = fr.affine(cam, rd)
        filters = stack_filters(model)
        coeffs = gabor_coeffs(*filters, o_aff, d_aff)
        cdet = coeffs.detach()
        with torch.no_grad():
            ref = fused_gabor_train_plain(packed, cdet, rd, t, tgt, True, k)
            got = fr._train(packed, cdet, rd, t, tgt, True)
            torch.cuda.synchronize()
        errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
        for i, name in ((1, "rgb"), (2, "acc"), (3, "weights")):
            if not torch.isfinite(got[i]).all():
                fail(f"gabor train kernel {cdt}: non-finite {name}")
            errs[name] = float((got[i] - ref[i]).abs().max())
        gerr = grad_errors(torch, got[4], ref[4], grad_views)
        if not torch.isfinite(got[5]).all():
            fail(f"gabor train kernel {cdt}: non-finite coefficient cotangents")
        derr = {f"d{c}": float((got[5][j] - ref[5][j]).abs().max() / ref[5][j].abs().max())
                for j, c in enumerate("ABPQR")}
        h = model.hidden_dim

        def per_stage(grads):
            om, ph, mu, ga = grads
            out = {}
            for i in range(model.num_layers):
                cols = slice(i * h, (i + 1) * h)
                out.update({f"omega{i}": om[:, cols], f"phi{i}": ph[cols],
                            f"mu{i}": mu[cols], f"gamma{i}": ga[cols]})
            return out

        ref_f = per_stage(torch.autograd.grad(coeffs, filters, ref[5], retain_graph=True))
        got_f = per_stage(torch.autograd.grad(coeffs, filters, got[5]))
        floor = 1e-2 * max(float(v.abs().max()) for v in ref_f.values())
        ferr = {n: float((got_f[n] - ref_f[n]).abs().max())
                / max(float(ref_f[n].abs().max()), floor) for n in ref_f}
        del ref, got, ref_f, got_f, coeffs, filters
        torch.cuda.empty_cache()
        with torch.no_grad():
            fns = {"plain": lambda: fused_gabor_train_plain(packed, cdet, rd, t, tgt,
                                                             True, k),
                   "kernel": lambda: fr._train(packed, cdet, rd, t, tgt, True)}
            times = {key: [] for key in fns}
            for f in fns.values():
                f()                                    # warm-up
            for which in ("plain", "kernel", "kernel", "plain"):
                times[which] += time_calls(torch, fns[which], 2)
            torch.cuda.empty_cache()
        bad = {n: v for n, v in errs.items() if v > TOL[cdt]["rgb"]}
        for label, e in (("train", gerr), ("dA..dR", derr), ("filters", ferr)):
            w = max(e, key=e.get)
            say(f"kernel gabor {label} {cdt} R={r} S={s}: gradient error (max abs "
                f"over max |g|) worst {w}={e[w]:.3e} (tol {GRAD_TOL[cdt]:.0e}), "
                f"median {statistics.median(e.values()):.3e}"
                + ("" if label == "filters" else "; " + " ".join(
                    f"{n}={v:.1e}" for n, v in e.items())))
            bad.update({f"{label}:{n}": v for n, v in e.items() if v > GRAD_TOL[cdt]})
        say(f"kernel gabor train {cdt} R={r} S={s}: "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items())
            + f" (tol {TOL[cdt]['rgb']:.0e})")
        ms = statistics.median(times["kernel"])
        plain_ms = statistics.median(times["plain"])
        bms, by = bound_ms(r, s, cdt, weight_bytes + r * GABOR_COEF_BYTES,
                           3 * GABOR_MACS - GABOR_SKIPPED, 2 * GABOR_TRIG,
                           grad_bytes + r * GABOR_COEF_BYTES, True)
        say(f"kernel fused_render_gabor_train {cdt} R={r} S={s}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share of bound "
            f"{bms / ms:.4f}")
        worst = max(list(gerr.values()) + list(derr.values()) + list(ferr.values())
                    + list(errs.values()))
        results[("fused_render_gabor_train", cdt)] = dict(
            err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        if bad:
            fail(f"gabor train kernel {cdt} disagrees: {bad}")
    return results


# ---------------------------------------------------------------- phase 13


def kilo_bound_ms(n: int, cdt: str, g3: int, backward: bool) -> tuple:
    """Least time of the KiloNeRF forward (or backward) over ``n`` points:
    the products (2 operations a MAC) over the compute dtype's peak and the
    sines over the float32 CUDA-core rate (their sum in float32, the larger
    in bfloat16), against the bytes that must move (see KILO_MACS)."""
    macs = KILO_BWD_MACS if backward else KILO_MACS
    wbytes = g3 * KILO_R * (4 if cdt == "float32" else 2)
    nbytes = n * (24 + 16) + wbytes + (g3 * KILO_R * 4 if backward else 0)
    t_mm = 2 * macs * n / PEAK_FLOPS[cdt] * 1e3
    t_trig = KILO_TRIG * n / PEAK_FLOPS["float32"] * 1e3
    t_ops = t_mm + t_trig if cdt == "float32" else max(t_mm, t_trig)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kilo_point_sets(torch, dev) -> dict:
    """The phase-13 point sets: 1024 x 256 camera-ray samples normalised as
    the renderer normalises them (the serve and train shape), 16,384 points
    uniform over the domain (the distillation batch), 5,000 points in one
    voxel, and 37 points (most of the 512 networks empty)."""
    g = torch.Generator(device=dev).manual_seed(13)
    ro, rd, t, _ = camera_batch(torch, dev, R_SIREN, S_SIREN, 13)
    pts = ro[:, None, :] + t[..., None] * rd[:, None, :]
    pts = 2.0 * (pts - 2.0) / (6.0 - 2.0) - 1.0
    dirs = rd[:, None, :].expand(pts.shape)
    lo, hi = KILO_DOMAIN

    def unit(n):
        d = torch.randn(n, 3, generator=g, device=dev)
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    uni = torch.rand(16384, 3, generator=g, device=dev) * (hi - lo) + lo
    vox = lo + (hi - lo) * (0.3 + 0.0125 * torch.rand(5000, 3, generator=g, device=dev))
    few = torch.rand(37, 3, generator=g, device=dev) * (hi - lo) + lo
    return {"camera 1024x256": (pts.reshape(-1, 3), dirs.reshape(-1, 3)),
            "uniform 16384": (uni, unit(16384)), "one voxel 5000": (vox, unit(5000)),
            "37 points": (few, unit(37))}


def check_kilonerf_kernels(torch, dev):
    """Both KiloNeRF kernels against their plain versions on every phase-13
    point set, float32 and bfloat16 with TF32 off: outputs (max abs) and
    gradients (max abs over max |g| per tensor), the exact zeros of empty
    networks; both timed in turns (plain, kernel, kernel, plain) at the
    camera set against their bound."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        KiloNeRFField, cast_packed, dispatch, kilonerf_bwd_plain, kilonerf_fwd_plain,
        pack_f32, unpack)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    sets = kilo_point_sets(torch, dev)
    for cdt in ("float32", "bfloat16"):
        model = KiloNeRFModel(grid_res=8, hidden_dim=32, compute_dtype=cdt,
                              domain=KILO_DOMAIN,
                              generator=torch.Generator().manual_seed(7)).to(dev)
        field = KiloNeRFField(model)
        with torch.no_grad():
            wc = cast_packed(pack_f32(model), model.cdt)
        worst = {"fwd": 0.0, "bwd": 0.0}
        for label, (pts, dirs) in sets.items():
            n = pts.shape[0]
            disp = dispatch(model, pts, dirs)
            cot = torch.randn(n, 4, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(n))
            with torch.no_grad():
                ref = kilonerf_fwd_plain(wc, disp, 32, 10, 4)
                out = field._forward(wc, disp)
                ref_g = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4)
                got_g = field._backward(wc, disp, cot)
                torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and torch.isfinite(got_g).all()):
                fail(f"kilonerf kernels {cdt} {label}: non-finite output or gradient")
            err = float((out - ref).abs().max())
            g, r = unpack(got_g, 32, 63, 27), unpack(ref_g, 32, 63, 27)
            floor = 1e-2 * max(float(v.abs().max()) for v in r.values())
            gerr = {k: float((g[k] - r[k]).abs().max()) / max(float(r[k].abs().max()), floor)
                    for k in r}
            empty = disp.counts == 0
            zeros = bool((got_g[empty] == 0).all())
            w = max(gerr, key=gerr.get)
            say(f"kernel kilonerf {cdt} {label}: forward max_abs_err {err:.3e} "
                f"(tol {KILO_TOL[cdt]:.0e}); gradient error (max abs over max |g|) "
                f"worst {w}={gerr[w]:.3e} (tol {KILO_GRAD_TOL[cdt]:.0e}), median "
                f"{statistics.median(gerr.values()):.3e}; {int(empty.sum())} empty "
                f"networks, gradients exactly 0: {zeros}")
            if err > KILO_TOL[cdt] or gerr[w] > KILO_GRAD_TOL[cdt] or not zeros:
                fail(f"kilonerf kernels {cdt} {label} disagree with their plain versions")
            worst["fwd"] = max(worst["fwd"], err)
            worst["bwd"] = max(worst["bwd"], gerr[w])
            if label.startswith("camera"):
                with torch.no_grad():
                    fns = {
                        ("fused_kilonerf_fwd", "plain"):
                            lambda: kilonerf_fwd_plain(wc, disp, 32, 10, 4),
                        ("fused_kilonerf_fwd", "kernel"):
                            lambda: field._forward(wc, disp),
                        ("fused_kilonerf_bwd", "plain"):
                            lambda: kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4),
                        ("fused_kilonerf_bwd", "kernel"):
                            lambda: field._backward(wc, disp, cot),
                    }
                    times = {k: [] for k in fns}
                    for f in fns.values():
                        f()                                    # warm-up
                    # a kernel of ~0.4 ms is as long as the host takes to
                    # issue it: time runs of KILO_BATCH launches between
                    # two events, so that the queue stays full and host
                    # gaps do not count
                    for name in ("fused_kilonerf_fwd", "fused_kilonerf_bwd"):
                        for which in ("plain", "kernel", "kernel", "plain"):
                            f = fns[(name, which)]
                            times[(name, which)] += [
                                t / KILO_BATCH for t in time_calls(
                                    torch, lambda f=f: [f() for _ in range(KILO_BATCH)], 3)]
                    torch.cuda.empty_cache()
                for name in ("fused_kilonerf_fwd", "fused_kilonerf_bwd"):
                    ms = statistics.median(times[(name, "kernel")])
                    plain_ms = statistics.median(times[(name, "plain")])
                    bms, by = kilo_bound_ms(n, cdt, 512, name.endswith("bwd"))
                    say(f"kernel {name} {cdt} {label}: kernel {ms:.3f} ms, plain "
                        f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share of bound "
                        f"{bms / ms:.4f}")
                    results[(name, cdt)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                                bound_by=by)
            del ref, out, ref_g, got_g, disp
            torch.cuda.empty_cache()
        results[("fused_kilonerf_fwd", cdt)]["err"] = worst["fwd"]
        results[("fused_kilonerf_bwd", cdt)]["err"] = worst["bwd"]
    return results


# ---------------------------------------------------------------- phase 17


def field_bound_ms(n: int, cdt: str, weight_bytes: int,
                   grad_bytes: int | None = None, family: str = "nerf") -> tuple:
    """Least time of a field forward (``grad_bytes`` None) or backward over
    ``n`` points (the NeRF field's, or ``family`` "siren" / "gabor"): the
    products (2 operations a MAC) over the compute dtype's peak and the
    transcendentals over the float32 CUDA-core rate (their sum in float32,
    the larger in bfloat16), against the bytes that must move (see
    FIELD_TRIG and SG_FIELD)."""
    fwd = grad_bytes is None
    if family == "nerf":
        macs = mlp_macs(256, 63, 27) * (1 if fwd else 3)
        trig = FIELD_TRIG * (1 if fwd else 2)
    else:
        macs = SG_FIELD[family]["macs"] * (1 if fwd else 3)
        trig = SG_FIELD[family]["trig"][0 if fwd else 1]
    nbytes = n * (24 + 16) + weight_bytes
    if grad_bytes is not None:
        nbytes += n * 24 + grad_bytes
    t_mm = 2 * macs * n / PEAK_FLOPS[cdt] * 1e3
    t_trig = trig * n / PEAK_FLOPS["float32"] * 1e3
    t_ops = t_mm + t_trig if cdt == "float32" else max(t_mm, t_trig)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def field_point_sets(torch, dev) -> dict:
    """The phase-17 point sets: the first 65,536 points of the 64^3
    occupancy lattice over grid_domain with the bake's directions (0, 0, 1)
    (one chunk of the serve bake), 16,384 uniform points with
    normal-then-normalised directions (the distillation draw), and 1,000 and
    37 points (ragged last chunks)."""
    from nerf_tpu_torch.ops.occupancy import lattice

    g = torch.Generator(device=dev).manual_seed(17)
    lo, hi = FIELD_DOMAIN

    def uniform(n):
        d = torch.randn(n, 3, generator=g, device=dev)
        return (torch.rand(n, 3, generator=g, device=dev) * (hi - lo) + lo,
                d / torch.linalg.norm(d, dim=-1, keepdim=True))

    lat = lattice(64, FIELD_DOMAIN, dev)[:65536]
    up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(lat.shape).contiguous()
    return {"lattice 65536": (lat, up), "uniform 16384": uniform(16384),
            "uniform 1000": uniform(1000), "uniform 37": uniform(37)}


def check_nerf_field_kernels(torch, dev):
    """Both NeRF field kernels against their plain versions on every
    phase-17 point set, float32 and bfloat16 with TF32 off: rgb and sigma
    (max abs), the weight gradients (grad_errors) and the point and
    direction cotangents (max abs over max |g|) of a random cotangent; both
    timed in turns (plain, kernel, kernel, plain) at 65,536 and 16,384
    points against their bound."""
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_nerf import (
        NerfField, nerf_field_bwd_plain, nerf_field_plain)
    from nerf_tpu_torch.ops.cuda.fused_render import pack_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    sets = field_point_sets(torch, dev)
    for cdt in ("float32", "bfloat16"):
        model = NeRFModel(compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(7)).to(dev)
        field = NerfField(model)
        with torch.no_grad():
            packed = field.cast(*pack_f32(model))
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        worst = {"fwd": 0.0, "bwd": 0.0}
        for label, (pts, dirs) in sets.items():
            n = pts.shape[0]
            cot = torch.randn(n, 4, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(n))
            with torch.no_grad():
                ref = nerf_field_plain(packed, pts, dirs, 10, 4)
                out = field._forward(packed, pts, dirs)
                ref_g = nerf_field_bwd_plain(packed, pts, dirs, cot, 10, 4)
                got_g = field._backward(packed, pts, dirs, cot)
                torch.cuda.synchronize()
            for x in out + got_g:
                if not torch.isfinite(x).all():
                    fail(f"nerf field kernels {cdt} {label}: non-finite output or gradient")
            errs = {"rgb": float((out[0] - ref[0]).abs().max()),
                    "sigma": float((out[1] - ref[1]).abs().max())}
            gerr = grad_errors(torch, got_g[:2], ref_g[:2])
            w = max(gerr, key=gerr.get)
            pt, bad_pts = {}, 0
            for name, i in (("points", 2), ("dirs", 3)):
                e = ((got_g[i] - ref_g[i]).abs().max(dim=1).values
                     / ref_g[i].abs().max())
                pt[name] = (float(torch.quantile(e, 0.999)), float(e.max()))
                bad_pts = max(bad_pts, int((e > FIELD_PT_TOL[cdt]).sum()))
            say(f"kernel nerf field {cdt} {label}: forward max_abs_err rgb="
                f"{errs['rgb']:.3e} sigma={errs['sigma']:.3e} (tol {TOL[cdt]['rgb']:.0e}); "
                f"weight gradient error (max abs over max |g|) worst {w}={gerr[w]:.3e} "
                f"(tol {GRAD_TOL[cdt]:.0e}), median {statistics.median(gerr.values()):.3e}; "
                + "; ".join(f"{k} cotangent error 99.9% {q:.3e} (tol "
                            f"{FIELD_PT_TOL[cdt]:.0e}), worst {m:.3e}"
                            for k, (q, m) in pt.items())
                + f"; points beyond the tol: {bad_pts} of {n}")
            if (max(errs.values()) > TOL[cdt]["rgb"] or gerr[w] > GRAD_TOL[cdt]
                    or max(q for q, _ in pt.values()) > FIELD_PT_TOL[cdt]
                    or bad_pts > 0.001 * n):
                fail(f"nerf field kernels {cdt} {label} disagree with their plain versions")
            worst["fwd"] = max(worst["fwd"], *errs.values())
            worst["bwd"] = max(worst["bwd"], gerr[w], *(q for q, _ in pt.values()))
            del ref, out, ref_g, got_g
            torch.cuda.empty_cache()
            if n not in (65536, 16384):
                continue
            with torch.no_grad():
                fns = {
                    ("fused_nerf_fwd", "plain"):
                        lambda: nerf_field_plain(packed, pts, dirs, 10, 4),
                    ("fused_nerf_fwd", "kernel"):
                        lambda: field._forward(packed, pts, dirs),
                    ("fused_nerf_bwd", "plain"):
                        lambda: nerf_field_bwd_plain(packed, pts, dirs, cot, 10, 4),
                    ("fused_nerf_bwd", "kernel"):
                        lambda: field._backward(packed, pts, dirs, cot),
                }
                times = {k: [] for k in fns}
                for f in fns.values():
                    f()                                    # warm-up
                for name in ("fused_nerf_fwd", "fused_nerf_bwd"):
                    for which in ("plain", "kernel", "kernel", "plain"):
                        f = fns[(name, which)]
                        times[(name, which)] += [
                            t / FIELD_BATCH for t in time_calls(
                                torch, lambda f=f: [f() for _ in range(FIELD_BATCH)], 2)]
                torch.cuda.empty_cache()
            for name in ("fused_nerf_fwd", "fused_nerf_bwd"):
                ms = statistics.median(times[(name, "kernel")])
                plain_ms = statistics.median(times[(name, "plain")])
                bms, by = field_bound_ms(n, cdt, weight_bytes,
                                         grad_bytes if name.endswith("bwd") else None)
                say(f"kernel {name} {cdt} {label}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share of bound "
                    f"{bms / ms:.4f}")
                results[(name, cdt, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                               bound_by=by)
        for name, key in (("fused_nerf_fwd", "fwd"), ("fused_nerf_bwd", "bwd")):
            for n in (65536, 16384):
                results[(name, cdt, n)]["err"] = worst[key]
    return results


# ---------------------------------------------------------------- phase 20


def sg_plain(model):
    """The field wrapper class of a SIREN or GaborNet ``model`` and the
    plain versions ``(fwd, bwd)`` of its kernels bound to the model's
    scalars."""
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_gabor import (
        GaborField, gabor_field_bwd_plain, gabor_field_plain)
    from nerf_tpu_torch.ops.cuda.fused_siren import (
        SirenField, siren_field_bwd_plain, siren_field_plain)

    wrapper, fwd, bwd = ((SirenField, siren_field_plain, siren_field_bwd_plain)
                         if isinstance(model, SirenModel) else
                         (GaborField, gabor_field_plain, gabor_field_bwd_plain))
    k = wrapper(model).consts
    return wrapper, (lambda pk, p, d: fwd(pk, p, d, k),
                     lambda pk, p, d, c: bwd(pk, p, d, c, k))


def sg_field(torch, family: str, cdt: str, dev):
    """A seeded lego_siren.txt-width model of ``family`` ("siren" or
    "gabor": hidden 256, 8 layers / stages) on ``dev``, with ``sg_plain``'s
    wrapper class and plain versions."""
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.models.siren import SirenModel

    cls = {"siren": SirenModel, "gabor": GaborModel}[family]
    model = cls(compute_dtype=cdt, generator=torch.Generator().manual_seed(7)).to(dev)
    return (model, *sg_plain(model))


def bank_grads(torch, model, gf) -> dict:
    """The GaborNet's filter-bank gradients ``gf`` (``pack_filters``'
    layout) carried by autograd through the packing onto omega, phi, mu and
    gamma of every stage, by name."""
    from nerf_tpu_torch.ops.cuda.fused_gabor import pack_filters

    names = [(f"{kind}{i}", getattr(f, kind)) for i, f in enumerate(model.filters)
             for kind in ("omega", "phi", "mu", "gamma")]
    with torch.enable_grad():
        grads = torch.autograd.grad(pack_filters(model), [p for _, p in names],
                                    grad_outputs=gf)
    return {name: g for (name, _), g in zip(names, grads)}


def check_siren_gabor_field_kernels(torch, dev):
    """The SIREN and GaborNet field kernels (forward and backward) against
    their plain versions on every phase-17 point set, float32 and bfloat16
    with TF32 off: rgb, sigma, the weight gradients, the GaborNet's filter
    banks after autograd through the packing, and the point and direction
    cotangents of a random cotangent; each timed in turns (plain, kernel,
    kernel, plain) at 65,536 and 16,384 points against its bound."""
    from nerf_tpu_torch.ops.cuda import fused_render_gabor, fused_render_siren

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    sets = field_point_sets(torch, dev)
    views = {"siren": fused_render_siren.grad_views, "gabor": fused_render_gabor.grad_views}
    for family in ("siren", "gabor"):
        kname = {"siren": "fused_siren", "gabor": "fused_gabor"}[family]
        for cdt in ("float32", "bfloat16"):
            model, wrapper, (plain_fwd, plain_bwd) = sg_field(torch, family, cdt, dev)
            field = wrapper(model).pack()
            pk = field.packed
            packed = pk if family == "siren" else pk.packed
            n_f = 0 if family == "siren" else pk.filters.numel()
            weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                            + (packed.vec.numel() + n_f) * 4)
            grad_bytes = (packed.wmat.numel() + packed.vec.numel() + n_f) * 4
            tol_out, tol_grad, tol_pt = SG_TOL.get(
                (family, cdt), (TOL[cdt]["rgb"], GRAD_TOL[cdt], FIELD_PT_TOL[cdt]))
            worst = {"fwd": 0.0, "bwd": 0.0}
            for label, (pts, dirs) in sets.items():
                n = pts.shape[0]
                cot = torch.randn(n, 4, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(n))
                with torch.no_grad():
                    ref = plain_fwd(pk, pts, dirs)
                    out = field._forward(pk, pts, dirs)
                    ref_g = plain_bwd(pk, pts, dirs, cot)
                    got_g = field._backward(pk, pts, dirs, cot)
                    torch.cuda.synchronize()
                    if n < 1000:
                        # the plain version itself at these points inside a
                        # larger batch (its products in another order)
                        big_p, big_d = sets["uniform 1000"]
                        alt = plain_fwd(pk, torch.cat([pts, big_p]),
                                        torch.cat([dirs, big_d]))
                        say(f"kernel {family} field {cdt} {label}: the plain version "
                            f"alone against inside a {n + 1000}-point batch: rgb "
                            f"{float((alt[0][:n] - ref[0]).abs().max()):.3e}, sigma "
                            f"{float((alt[1][:n] - ref[1]).abs().max()):.3e}; the kernel "
                            f"against the batched plain version: rgb "
                            f"{float((alt[0][:n] - out[0]).abs().max()):.3e}, sigma "
                            f"{float((alt[1][:n] - out[1]).abs().max()):.3e}")
                for x in out + got_g:
                    if not torch.isfinite(x).all():
                        fail(f"{family} field kernels {cdt} {label}: non-finite output "
                             "or gradient")
                smax = float(ref[1].abs().max())
                errs = {"rgb": float((out[0] - ref[0]).abs().max()),
                        "sigma": float((out[1] - ref[1]).abs().max()) / max(smax, 1.0)}
                gerr = grad_errors(torch, got_g[:2], ref_g[:2], views[family])
                if family == "gabor":
                    bg, br = bank_grads(torch, model, got_g[2]), bank_grads(torch, model, ref_g[2])
                    floor = 1e-2 * max(float(v.abs().max()) for v in br.values())
                    for name in br:
                        gerr[name] = float((bg[name] - br[name]).abs().max()) / max(
                            float(br[name].abs().max()), floor)
                w = max(gerr, key=gerr.get)
                pt, bad_pts = {}, 0
                for name, i in (("points", -2), ("dirs", -1)):
                    e = ((got_g[i] - ref_g[i]).abs().max(dim=1).values
                         / ref_g[i].abs().max())
                    pt[name] = (float(torch.quantile(e, 0.999)), float(e.max()))
                    bad_pts = max(bad_pts, int((e > tol_pt).sum()))
                say(f"kernel {family} field {cdt} {label}: forward max_abs_err rgb="
                    f"{errs['rgb']:.3e} sigma={errs['sigma']:.3e} (over max(1, max "
                    f"sigma) = {max(smax, 1.0):.3g}; tol {tol_out:.0e}); gradient "
                    f"error (max abs over max |g|) worst {w}={gerr[w]:.3e} (tol "
                    f"{tol_grad:.0e}), median {statistics.median(gerr.values()):.3e}; "
                    + "; ".join(f"{k} cotangent error 99.9% {q:.3e} (tol "
                                f"{tol_pt:.0e}), worst {m:.3e}"
                                for k, (q, m) in pt.items())
                    + f"; points beyond the tol: {bad_pts} of {n}")
                if (max(errs.values()) > tol_out or gerr[w] > tol_grad
                        or max(q for q, _ in pt.values()) > tol_pt
                        or bad_pts > 0.001 * n):
                    fail(f"{family} field kernels {cdt} {label} disagree with their "
                         "plain versions")
                worst["fwd"] = max(worst["fwd"], *errs.values())
                worst["bwd"] = max(worst["bwd"], gerr[w], *(q for q, _ in pt.values()))
                del ref, out, ref_g, got_g
                torch.cuda.empty_cache()
                if n not in (65536, 16384):
                    continue
                with torch.no_grad():
                    fns = {
                        (f"{kname}_fwd", "plain"): lambda: plain_fwd(pk, pts, dirs),
                        (f"{kname}_fwd", "kernel"): lambda: field._forward(pk, pts, dirs),
                        (f"{kname}_bwd", "plain"): lambda: plain_bwd(pk, pts, dirs, cot),
                        (f"{kname}_bwd", "kernel"):
                            lambda: field._backward(pk, pts, dirs, cot),
                    }
                    times = {key: [] for key in fns}
                    for f in fns.values():
                        f()                                    # warm-up
                    for name in (f"{kname}_fwd", f"{kname}_bwd"):
                        for which in ("plain", "kernel", "kernel", "plain"):
                            f = fns[(name, which)]
                            times[(name, which)] += [
                                t / FIELD_BATCH for t in time_calls(
                                    torch, lambda f=f: [f() for _ in range(FIELD_BATCH)],
                                    2)]
                    torch.cuda.empty_cache()
                for name in (f"{kname}_fwd", f"{kname}_bwd"):
                    ms = statistics.median(times[(name, "kernel")])
                    plain_ms = statistics.median(times[(name, "plain")])
                    bms, by = field_bound_ms(
                        n, cdt, weight_bytes, grad_bytes if name.endswith("bwd") else None,
                        family)
                    say(f"kernel {name} {cdt} {label}: kernel {ms:.3f} ms, plain "
                        f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share of bound "
                        f"{bms / ms:.4f}")
                    results[(name, cdt, n)] = dict(ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bms, bound_by=by)
            for name, key in ((f"{kname}_fwd", "fwd"), (f"{kname}_bwd", "bwd")):
                for n in (65536, 16384):
                    results[(name, cdt, n)]["err"] = worst[key]
    return results


# ---------------------------------------------------------------- phase 15


def train_kilonerf(torch, dev, tmp: str) -> dict:
    """Phase 15: the kilonerf config's teacher (model_type nerf, hidden 32,
    use_pallas = false: the module path, as the JAX package runs a hidden-32
    NeRF) for 100 steps; then fit() of kilonerf distilling it (100 steps of
    16,384 points, the last loss under the first) and training 200
    photometric steps (the mse at 190 under that at 0) through the field
    kernels; a bit-identical resume from step 100 (no distillation); the
    launch counts; a profile of one step."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config

    base = parse_config_file(os.path.join(ROOT, "configs", "lego_siren.txt"))
    common = dict(dataset_path=os.path.join(tmp, "scene"), log_interval=10,
                  val_interval=100, save_interval=100, **KILO_OVERRIDES)
    tcfg = dataclasses.replace(base, model_type="nerf", use_pallas=False, num_iters=100,
                               save_path=os.path.join(tmp, "teacher_models"),
                               log_dir=os.path.join(tmp, "teacher_logs"), **common)
    t0 = time.perf_counter()
    fit(tcfg, device=dev, log=lambda *_: None)
    teacher = os.path.join(tcfg.save_path, "nerf_model_000100")
    tloss = read_scalars(tcfg.log_dir)["loss"]
    say(f"train: teacher (lego_siren.txt, model_type = nerf, hidden 32, module path) "
        f"100 iterations in {time.perf_counter() - t0:.1f} s, mse {tloss[0]:.6f} at 0 -> "
        f"{tloss[90]:.6f} at 90")
    cfg = dataclasses.replace(base, model_type="kilonerf", num_iters=200,
                              distill_from=teacher, distill_steps=100, distill_batch=16384,
                              save_path=os.path.join(tmp, "train_models_kilonerf"),
                              log_dir=os.path.join(tmp, "train_logs_kilonerf"), **common)
    lines: list = []
    KiloNeRFField.launches = KiloNeRFField.bwd_launches = 0   # the main path's counts
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (KiloNeRFField.launches, KiloNeRFField.bwd_launches)
    say(f"train: fit kilonerf (distillation 100 x 16384 points, then 200 iterations) in "
        f"{wall:.1f} s; launches: forward {counts[0]}, backward {counts[1]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Distill" in line:
            say(f"  {line}")
    per_image = math.ceil(HW * HW / cfg.chunk_size)
    want = (100 + 200 + per_image, 100 + 200)
    if counts != want:
        fail(f"fit kilonerf launched (forward, backward) {counts}, want {want}")
    scal = read_scalars(cfg.log_dir)
    dl = scal["distill_loss"]
    if sorted(dl) != list(range(100)) or not dl[99] < dl[0]:
        fail(f"distillation loss {dl.get(0)} at 0 -> {dl.get(99)} at 99 does not fall")
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 200, 10)) or not all(
            math.isfinite(v) for v in loss.values()):
        fail(f"kilonerf logged mse {loss}")
    if not loss[190] < loss[0]:
        fail(f"kilonerf: mse at 190 ({loss[190]}) is not under that at 0 ({loss[0]})")
    step_rps = scal["rays_per_sec"][190]
    say(f"train: distill loss {dl[0]:.6f} at 0 -> {dl[99]:.6f} at 99; mse {loss[0]:.6f} "
        f"at 0 -> {loss[190]:.6f} at 190 (ratio {loss[190] / loss[0]:.4f}); kilonerf "
        f"step {step_rps:.0f} rays/s ({cfg.num_random_rays} rays, {cfg.num_samples} "
        f"samples, {cfg.compute_dtype})")
    check_resume(torch, dev, tmp, cfg, "kilonerf", loss)
    from nerf_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device=dev)
    scene = load_scene(cfg, device=dev)
    profile_step(torch, state, scene.pool, render_settings_from_config(cfg), cfg,
                 "fused_kilonerf", "kilonerf")
    return {"fwd_launches": counts[0], "bwd_launches": counts[1], "step_rps": step_rps}


def bench_kilonerf(torch, dev) -> float:
    """bench.py's train_kilonerf row: 512 networks of hidden 32 (grid 8,
    L = 10/4) over grid_domain, bf16, 1024 x 256, the 1<<20 pool, warm-up
    (2 calls of 8 steps there: 16 steps), then 5 x 8 = 40 timed steps."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel

    model = KiloNeRFModel(grid_res=8, hidden_dim=32, compute_dtype="bfloat16",
                          domain=KILO_DOMAIN,
                          generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 40, 16, "bench train_kilonerf (bench.py "
                       "protocol, KiloNeRF 512 x h32 bf16 1024x256)")


# ---------------------------------------------------------------- phase 5


def read_scalars(log_dir: str) -> dict:
    """{tag: {step: value}} from the train.log of the one run under
    ``log_dir``."""
    runs = os.listdir(log_dir)
    if len(runs) != 1:
        fail(f"{log_dir}: expected one run directory, found {runs}")
    out: dict = {}
    with open(os.path.join(log_dir, runs[0], "train.log")) as f:
        for line in f:
            if line.startswith("scalar "):
                _, tag, step, value = line.split()
                out.setdefault(tag, {})[int(step)] = float(value)
    return out


def check_resume(torch, dev, tmp: str, cfg, name: str, loss: dict,
                 tag: str | None = None) -> None:
    """A resume from the step-100 checkpoint of ``fit``'s run: the restore
    is exact, and every resumed step to 120 repeats the first run's mse
    (``loss``) at the same state.step (the loop restarts at the saved
    iteration while state.step is one ahead). The resumed run saves and
    logs under ``tag`` (default ``name``)."""
    import dataclasses

    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state

    ckpt = os.path.join(cfg.save_path, f"{name}_model_000100")
    saved = load_checkpoint(ckpt)
    probe = create_train_state(cfg, device=dev)
    restore_train_state(probe, ckpt)
    same = probe.step == saved["train_step"] == 101
    for m, sd in ((probe.params, saved["params"]), (probe.fine_params, saved["fine_params"])):
        if m is None:
            same &= sd == {}
            continue
        same &= all(torch.equal(v.cpu(), sd[k]) for k, v in m.state_dict().items())
    for mine, theirs in ((probe.optimizer.mu, saved["optimizer"]["mu"]),
                         (probe.optimizer.nu, saved["optimizer"]["nu"])):
        same &= all(torch.equal(a.cpu(), b) for a, b in zip(mine, theirs))
    if not same:
        fail("the restored step, parameters or Adam moments differ from the save")
    del probe
    cfg2 = dataclasses.replace(cfg, num_iters=120, log_interval=1,
                               save_path=os.path.join(tmp, f"resume_models_{tag or name}"),
                               log_dir=os.path.join(tmp, f"resume_logs_{tag or name}"))
    lines2: list = []
    resumed = fit(cfg2, resume_path=ckpt, device=dev, log=lines2.append)
    loss2 = read_scalars(cfg2.log_dir)["loss"]
    pairs = [(i, i + 1) for i in sorted(loss2) if i + 1 in loss]
    if resumed.step != 121 or len(pairs) != 2:
        fail(f"resume: state.step {resumed.step}, comparable steps {pairs}")
    for i, j in pairs:
        say(f"train: resumed iteration {i} (state.step {i + 2}) mse "
            f"{loss2[i]!r}, first run iteration {j} mse {loss[j]!r}")
        if loss2[i] != loss[j]:
            fail("the resumed run does not repeat the first run bit for bit")
    del resumed


def train(torch, dev, tmp: str, config: str, fused_cls, kernel: str,
          max_ratio: float, model_type: str | None = None) -> dict:
    """Phase 5 (``config`` lego.txt, the NeRF kernels, the mse at 190 under
    ``max_ratio`` = 0.5 of that at 0), 9 (lego_siren.txt, the SIREN kernels,
    ``max_ratio`` 1) or 12 (lego_siren.txt with ``model_type`` gabor, the
    GaborNet kernels, ``max_ratio`` 1; its forward render has no backward,
    so the render route must raise instead)."""
    label = config if model_type is None else f"{config} (model_type = {model_type})"
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.render.renderer import render_rays
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config

    cfg = parse_config_file(os.path.join(ROOT, "configs", config))
    name = model_type or cfg.model_type
    cfg = dataclasses.replace(
        cfg, model_type=name, dataset_path=os.path.join(tmp, "scene"), num_iters=200,
        log_interval=10, val_interval=100, save_interval=100,
        save_path=os.path.join(tmp, f"train_models_{name}"),
        log_dir=os.path.join(tmp, f"train_logs_{name}"))
    passes = 2 if cfg.num_fine_samples > 0 else 1
    lines: list = []
    fused_cls.launches = fused_cls.train_launches = 0
    fused_cls.bwd_launches = 0              # the main path's counts start here
    t0 = time.perf_counter()
    state = fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fused_cls.train_launches, fused_cls.launches, fused_cls.bwd_launches)
    say(f"train: fit {label} 200 iterations in {wall:.1f} s; launches: "
        f"train {counts[0]}, forward {counts[1]}, backward {counts[2]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line:
            say(f"  {line}")
    want = (passes * cfg.num_iters, passes * math.ceil(HW * HW / cfg.chunk_size), 0)
    if counts != want:
        fail(f"fit {label} launched (train, forward, backward) {counts}, want {want}")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 200, 10)):
        fail(f"logged iterations {sorted(loss)}")
    if not all(math.isfinite(v) for v in loss.values()):
        fail(f"non-finite logged loss {loss}")
    if not loss[190] < max_ratio * loss[0]:
        fail(f"{label}: mse at 190 ({loss[190]}) is not under {max_ratio} of "
             f"that at 0 ({loss[0]})")
    for step in (100, 200):
        path = os.path.join(cfg.save_path, f"{name}_model_{step:06d}")
        if not (os.path.exists(path) and os.path.exists(path + ".meta.json")):
            fail(f"missing checkpoint {path}")
    step_rps = scal["rays_per_sec"][190]
    say(f"train: mse {loss[0]:.6f} at 0 -> {loss[190]:.6f} at 190 (ratio "
        f"{loss[190] / loss[0]:.4f}); {label} step {step_rps:.0f} rays/s "
        f"({cfg.num_random_rays} rays, {cfg.num_samples}+{cfg.num_fine_samples} "
        f"samples, {cfg.compute_dtype})")

    check_resume(torch, dev, tmp, cfg, name, loss)

    scene = load_scene(cfg, device=dev)
    settings = render_settings_from_config(cfg)
    fr = fused_cls(state.params, cfg.near, cfg.far)
    if model_type == "gabor":
        # the forward render has no backward (the JAX one's VJP raises): under
        # autograd it must refuse before launching anything
        g = torch.Generator(device=dev).manual_seed(cfg.seed)
        batch = scene.pool.sample(g, cfg.num_random_rays)
        fused_cls.launches = 0
        try:
            render_rays(state.params, batch.rays_o, batch.rays_d, settings,
                        generator=g, viewdirs=batch.viewdirs, fused_render=fr)
        except NotImplementedError as e:
            say(f"train: {label} render route under autograd raises "
                f"NotImplementedError ({e}); forward launches {fused_cls.launches}")
        else:
            fail(f"{label}: the forward render under autograd did not raise")
        if fused_cls.launches != 0:
            fail(f"{label}: the refused render route launched a kernel")
        profile_step(torch, state, scene.pool, settings, cfg, kernel, label)
        return {"train_launches": cfg.num_iters, "bwd_launches": 0,
                "step_rps": step_rps}

    # the render route: render_rays through the forward kernel, the loss,
    # and its backward under autograd (the backward kernel), then Adam
    fused_cls.launches = fused_cls.train_launches = 0
    fused_cls.bwd_launches = 0              # this path's counts start here
    mses = []
    for i in range(3):
        g = torch.Generator(device=dev).manual_seed(cfg.seed + i)
        batch = scene.pool.sample(g, cfg.num_random_rays)
        for m in state.models():
            m.zero_grad(set_to_none=True)
        out = render_rays(state.params, batch.rays_o, batch.rays_d, settings,
                          generator=g, fine_params=state.fine_params,
                          viewdirs=batch.viewdirs, fused_render=fr)
        mse = torch.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if passes == 2:
            loss = loss + torch.mean((out.rgb_coarse - batch.rgb) ** 2)
        loss.backward()
        state.optimizer.step()
        mses.append(float(mse.detach()))
    counts = (fused_cls.train_launches, fused_cls.launches, fused_cls.bwd_launches)
    say(f"train: {label} render route 3 steps, mse {mses}; launches: train "
        f"{counts[0]}, forward {counts[1]}, backward {counts[2]}")
    want = (0, 3 * passes, 3 * passes)
    if counts != want or not all(math.isfinite(v) for v in mses):
        fail(f"{label} render route launched {counts}, want {want}")
    profile_step(torch, state, scene.pool, settings, cfg, kernel, label)
    return {"train_launches": passes * cfg.num_iters, "bwd_launches": counts[2],
            "step_rps": step_rps}


def profile_step(torch, state, pool, settings, cfg, kernel: str,
                 config: str, occ_grid=None) -> None:
    """One train step of ``config`` under torch.profiler (with ``occ_grid``
    an occupancy-guided one, over grid_domain as fit's)."""
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.train.loop import make_regularizer
    from nerf_tpu_torch.train.step import make_train_step

    opts = None if occ_grid is None else (grid_domain(cfg), 64, 1e-2)
    step = make_train_step(state.params, settings, cfg.num_random_rays, cfg.seed,
                           occupancy_opts=opts,
                           regularizer=make_regularizer(cfg, state.params))
    step(state, pool, occ_grid)
    profile_device(torch, lambda: step(state, pool, occ_grid), kernel,
                   f"one {config} train step")


# ---------------------------------------------------------------- phase 18


def serve_occupancy(torch, dev, tmp: str, ckpt: str) -> dict:
    """Phase 18: lego.txt served from phase 5's trained checkpoint with
    --occupancy 64. The bake: four NeRF field forward launches (64^3 points
    in chunks of 65,536), its occupied share, the grid equal to the one
    baked through the field's plain version, the cells that a bake through
    the module flips, the lattice's densities and the two bakes compared at
    their median; then the three requests of ``serve`` (no field launch),
    each against the unfused render with the same grid; then a prior that
    carves (``check_carving_prior``)."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField, nerf_field_plain
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.ops.occupancy import bake_occupancy, lattice, sigma_field
    from nerf_tpu_torch.serve import RenderService

    cfg = parse_config_file(os.path.join(ROOT, "configs", "lego.txt"))
    cfg = dataclasses.replace(cfg, dataset_path=os.path.join(tmp, "scene"))
    NerfField.launches = 0                     # the main path's count starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = RenderService.from_checkpoint(cfg, ckpt, occupancy=64, device=dev, log=say)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    bake_launches = NerfField.launches
    occ = svc._renderer.occupancy
    grid = occ.grid
    if bake_launches != 4 or grid.shape != (64, 64, 64, 1):
        fail(f"occupancy bake: {bake_launches} field launches, grid {tuple(grid.shape)}")
    src = svc.params[1]
    field = NerfField(src).pack()
    domain = grid_domain(cfg)

    def plain_field(p, d):
        return nerf_field_plain(field.packed, p, d, 10, 4)

    def bake(f, **kw):
        return bake_occupancy(sigma_field(f), grid_res=64, domain=domain, device=dev, **kw)

    with torch.no_grad():
        plain, plain0 = bake(plain_field), bake(plain_field, dilate=0)
        kern0, module = bake(field, dilate=0), bake(src)
        # the lattice's densities, and both bakes thresholded at their
        # median, where half the cells are empty
        sig = sigma_field(field)(lattice(64, domain, dev))
        q = torch.quantile(sig[::16], torch.tensor([0.0, 0.01, 0.5, 0.99], device=dev))
        med = float(q[2])
        kern_m = bake(field, threshold=med, dilate=0)
        plain_m = bake(plain_field, threshold=med, dilate=0)
    share = float(grid.mean())
    say(f"serve occupancy: the 64^3 bake launched the NeRF field forward {bake_launches} "
        f"times (service set-up {setup:.2f} s); occupied share {share:.4f} (before "
        f"dilation {float(kern0.mean()):.4f}); cells that differ from the plain-version "
        f"bake: {int((grid != plain).sum())} dilated, {int((kern0 != plain0).sum())} "
        f"before dilation; cells the module bake flips: {int((grid != module).sum())}")
    say(f"serve occupancy: lattice densities min {float(q[0]):.4g}, 1% {float(q[1]):.4g}, "
        f"median {med:.4g}, 99% {float(q[3]):.4g} (threshold 1e-2); thresholded at the "
        f"median, undilated: occupied share {float(kern_m.mean()):.4f}, cells that "
        f"differ from the plain-version bake {int((kern_m != plain_m).sum())} of 262144")
    if not torch.equal(grid, plain):
        fail("the kernel-baked occupancy grid differs from the plain version's")
    before = NerfField.launches
    launches = serve(torch, dev, tmp, "lego.txt", FusedNerfRender, "fused_render_fwd",
                     svc=svc, compare=("/pose/0", "/pose/1", "/render"))
    if NerfField.launches != before:
        fail(f"occupancy requests launched the field kernel "
             f"{NerfField.launches - before} times")
    check_carving_prior(torch, dev, svc, field, med)
    return {"bake_launches": bake_launches, "launches": launches}


def check_carving_prior(torch, dev, svc, field, threshold: float) -> None:
    """The served checkpoint's prior fills its grid, so phase 18 also bakes
    one that carves (``threshold`` the lattice's median density, dilated as
    a bake dilates) and shows on request /pose/1's rays that it moves the
    coarse samples into occupied cells (their share against stratified
    sampling's) and that the fused render with it stays within mean abs
    1e-2 of the unfused render with it."""
    from nerf_tpu_torch.data.rays import compute_rays_single
    from nerf_tpu_torch.models.common import remap_domain
    from nerf_tpu_torch.ops.occupancy import (
        OccupancyGrid, _occ_trilinear, bake_occupancy, occupancy_t, sigma_field)
    from nerf_tpu_torch.ops.sampling import (
        normalize_positions, sample_positions, stratified_sample)
    from nerf_tpu_torch.serve import request_seed
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import make_eval_render

    cfg = svc.cfg
    domain = svc._renderer.occupancy.domain
    occ = OccupancyGrid(grid=bake_occupancy(sigma_field(field), grid_res=64,
                                            domain=domain, threshold=threshold,
                                            device=dev), domain=domain)
    settings = render_settings_from_config(cfg)
    h, w = svc.hw
    o, d = (torch.from_numpy(x).to(dev)
            for x in compute_rays_single(h, w, svc.focal, svc.orbit_pose(1)))
    images = []
    for fused in (True, False):
        g = torch.Generator(device=dev).manual_seed(request_seed(cfg.seed, 1))
        render = make_eval_render(svc.params[0], settings, fused=fused, occupancy=occ)
        images.append(render(*svc.params, o, d, g).rgb.clamp(0, 1))
    diff = float((images[0] - images[1]).abs().mean())

    def occupied(t):
        p = normalize_positions(sample_positions(o, d, t), cfg.near, cfg.far)
        return float((_occ_trilinear(occ.grid, remap_domain(p, domain).reshape(-1, 3))
                      > 0.5).float().mean())

    g = torch.Generator(device=dev).manual_seed(0)
    with_prior = occupied(occupancy_t(occ, o, d, cfg.near, cfg.far, cfg.num_samples,
                                      generator=g))
    stratified = occupied(stratified_sample(cfg.near, cfg.far, cfg.num_samples,
                                            o.shape[0], generator=g, device=dev))
    say(f"serve occupancy: a carving prior (median density, dilated) occupies "
        f"{float(occ.grid.mean()):.4f} of its grid; coarse samples in occupied cells "
        f"{with_prior:.4f} with it, {stratified:.4f} stratified; /pose/1's rays "
        f"through the fused render with it within mean abs {diff:.3e} of the "
        f"unfused render (tol {SERVE_TOL_MEAN:.0e})")
    if not with_prior > stratified or diff > SERVE_TOL_MEAN:
        fail("the carving prior does not move samples into occupied cells, or its "
             "fused render disagrees with the unfused one")


# ---------------------------------------------------------------- phase 19


def train_distill_occupancy(torch, dev, tmp: str, teacher: str) -> dict:
    """Phase 19: lego.txt distilled from phase 5's checkpoint (``teacher``)
    into a seeded student (100 steps of 16,384 points through the NeRF field
    kernels: teacher forward, student forward and backward), then 200
    photometric steps with occupancy_res = 64 and occupancy_interval = 100
    (the bakes through the module, as the fused render engages); the
    launch counts, the distillation loss falling, the mse at 190 under half
    of that at 0, a bit-identical resume from step 100 and a profile of one
    occupancy-guided step."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.ops.occupancy import bake_occupancy, sigma_field
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config
    from nerf_tpu_torch.train.state import create_train_state

    base = parse_config_file(os.path.join(ROOT, "configs", "lego.txt"))
    cfg = dataclasses.replace(
        base, dataset_path=os.path.join(tmp, "scene"), num_iters=200, log_interval=10,
        val_interval=100, save_interval=100, distill_from=teacher, distill_steps=100,
        distill_batch=16384, occupancy_res=64, occupancy_interval=100,
        save_path=os.path.join(tmp, "train_models_distill_occ"),
        log_dir=os.path.join(tmp, "train_logs_distill_occ"))
    lines: list = []
    NerfField.launches = NerfField.bwd_launches = 0       # the main path's counts
    FusedNerfRender.launches = FusedNerfRender.train_launches = 0
    FusedNerfRender.bwd_launches = 0
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (NerfField.launches, NerfField.bwd_launches)
    render = (FusedNerfRender.train_launches, FusedNerfRender.launches,
              FusedNerfRender.bwd_launches)
    say(f"train: fit lego.txt with distillation (100 x 16384 points from the phase-5 "
        f"checkpoint) and occupancy 64 every 100 steps, 200 iterations in {wall:.1f} s; "
        f"launches: field forward {counts[0]}, field backward {counts[1]}; render "
        f"train {render[0]}, forward {render[1]}, backward {render[2]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Distill" in line:
            say(f"  {line}")
    per_image = 2 * math.ceil(HW * HW / cfg.chunk_size)
    if counts != (200, 100) or render != (400, per_image, 0):
        fail(f"fit with distillation and occupancy launched (field forward, backward) "
             f"{counts}, want (200, 100); (render train, forward, backward) {render}, "
             f"want (400, {per_image}, 0)")
    scal = read_scalars(cfg.log_dir)
    dl = scal["distill_loss"]
    if sorted(dl) != list(range(100)) or not dl[99] < dl[0]:
        fail(f"distillation loss {dl.get(0)} at 0 -> {dl.get(99)} at 99 does not fall")
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 200, 10)) or not all(
            math.isfinite(v) for v in loss.values()):
        fail(f"distill + occupancy logged mse {loss}")
    if not loss[190] < 0.5 * loss[0]:
        fail(f"distill + occupancy: mse at 190 ({loss[190]}) is not under half of that "
             f"at 0 ({loss[0]})")
    step_rps = scal["rays_per_sec"][190]
    say(f"train: distill loss {dl[0]:.6f} at 0 -> {dl[99]:.6f} at 99; mse {loss[0]:.6f} "
        f"at 0 -> {loss[190]:.6f} at 190 (ratio {loss[190] / loss[0]:.4f}); lego.txt "
        f"occupancy-guided step {step_rps:.0f} rays/s ({cfg.num_random_rays} rays, "
        f"{cfg.num_samples}+{cfg.num_fine_samples} samples, {cfg.compute_dtype})")
    check_resume(torch, dev, tmp, cfg, "nerf", loss, tag="distill_occ")
    state = create_train_state(cfg, device=dev)
    scene = load_scene(cfg, device=dev)
    occ_grid = bake_occupancy(sigma_field(state.params), grid_res=64,
                              domain=grid_domain(cfg), device=dev)
    profile_step(torch, state, scene.pool, render_settings_from_config(cfg), cfg,
                 "fused_render_grad", "lego.txt occupancy-guided", occ_grid)
    return {"fwd_launches": counts[0], "bwd_launches": counts[1], "step_rps": step_rps}


# ---------------------------------------------------------------- phase 21


def serve_occupancy_sg(torch, dev, tmp: str, family: str, ckpt: str) -> dict:
    """Phase 21: lego_siren.txt (``family`` "siren") or its GaborNet variant
    ("gabor") served from its phase-9 / phase-12 checkpoint with
    --occupancy 64. The bake: four launches of the family's field forward
    kernel (64^3 points in chunks of 65,536), its occupied share, the grid
    equal to the one baked through the field's plain version; then the three
    requests of ``serve`` (157 render launches each, no field launch), each
    against the unfused render with the same grid, their times and a
    profile of one."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
    from nerf_tpu_torch.ops.occupancy import bake_occupancy, sigma_field
    from nerf_tpu_torch.serve import RenderService

    cfg = parse_config_file(os.path.join(ROOT, "configs", "lego_siren.txt"))
    cfg = dataclasses.replace(cfg, dataset_path=os.path.join(tmp, "scene"),
                              model_type=family)
    from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
    from nerf_tpu_torch.ops.cuda.fused_siren import SirenField

    wrapper = {"siren": SirenField, "gabor": GaborField}[family]
    wrapper.launches = 0                     # the main path's count starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = RenderService.from_checkpoint(cfg, ckpt, occupancy=64, device=dev, log=say)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    bake_launches = wrapper.launches
    grid = svc._renderer.occupancy.grid
    if bake_launches != 4 or grid.shape != (64, 64, 64, 1):
        fail(f"{family} occupancy bake: {bake_launches} field launches, grid "
             f"{tuple(grid.shape)}")
    src = svc.params[0]
    _, (plain_fwd, _) = sg_plain(src)
    field = wrapper(src).pack()
    with torch.no_grad():
        plain = bake_occupancy(
            sigma_field(lambda p, d: plain_fwd(field.packed, p, d)), grid_res=64,
            domain=grid_domain(cfg), device=dev)
    diff = int((grid != plain).sum())
    say(f"serve occupancy {family}: the 64^3 bake launched the {family} field forward "
        f"{bake_launches} times (service set-up {setup:.2f} s); occupied share "
        f"{float(grid.mean()):.4f}; cells that differ from the plain-version bake: "
        f"{diff} of 262144")
    if diff:
        fail(f"the kernel-baked {family} occupancy grid differs from the plain version's")
    fused_cls = {"siren": FusedSirenRender, "gabor": FusedGaborRender}[family]
    before = wrapper.launches
    launches = serve(torch, dev, tmp, "lego_siren.txt", fused_cls,
                     f"fused_{family}_fwd", family, svc=svc,
                     compare=("/pose/0", "/pose/1", "/render"))
    if wrapper.launches != before:
        fail(f"{family} occupancy requests launched the field kernel "
             f"{wrapper.launches - before} times")
    return {"bake_launches": bake_launches, "launches": launches}


# ---------------------------------------------------------------- phase 22


def train_distill_cross(torch, dev, tmp: str, student: str, teacher: str) -> dict:
    """Phase 22: fit() of lego_siren.txt with model_type ``student``
    ("siren" or "gabor") distilled from ``teacher``, a checkpoint of the
    other family (phase 9's or 12's): 100 distillation steps of 16,384
    points (teacher forward, student forward and backward through the field
    kernels; the loss falls), then 100 photometric steps through the
    student's fused render (the mse at 90 under that at 0, one validation
    image at 50); the launch counts and the step's rate."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
    from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
    from nerf_tpu_torch.train.loop import fit

    fields = {"siren": SirenField, "gabor": GaborField}
    s_field = fields[student]
    t_field = fields["gabor" if student == "siren" else "siren"]
    fused_cls = {"siren": FusedSirenRender, "gabor": FusedGaborRender}[student]
    base = parse_config_file(os.path.join(ROOT, "configs", "lego_siren.txt"))
    cfg = dataclasses.replace(
        base, model_type=student, dataset_path=os.path.join(tmp, "scene"),
        num_iters=100, log_interval=10, val_interval=50, save_interval=100,
        distill_from=teacher, distill_steps=100, distill_batch=16384,
        save_path=os.path.join(tmp, f"train_models_distill_{student}"),
        log_dir=os.path.join(tmp, f"train_logs_distill_{student}"))
    lines: list = []
    for cls in (SirenField, GaborField):                  # the main path's counts
        cls.launches = cls.bwd_launches = 0
    fused_cls.launches = fused_cls.train_launches = 0
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (t_field.launches, t_field.bwd_launches, s_field.launches,
              s_field.bwd_launches)
    render = (fused_cls.train_launches, fused_cls.launches)
    per_image = math.ceil(HW * HW / cfg.chunk_size)
    say(f"train: fit a {student} student of lego_siren.txt distilled from the "
        f"{t_field.family} checkpoint (100 x 16384 points), 100 iterations in "
        f"{wall:.1f} s; launches: teacher field forward {counts[0]}, backward "
        f"{counts[1]}; student field forward {counts[2]}, backward {counts[3]}; "
        f"render train {render[0]}, forward {render[1]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Distill" in line:
            say(f"  {line}")
    if counts != (100, 0, 100, 100) or render != (100, per_image):
        fail(f"cross-family distillation into {student} launched (teacher forward, "
             f"backward, student forward, backward) {counts}, want (100, 0, 100, "
             f"100); (render train, forward) {render}, want (100, {per_image})")
    scal = read_scalars(cfg.log_dir)
    dl = scal["distill_loss"]
    if sorted(dl) != list(range(100)) or not dl[99] < dl[0]:
        fail(f"{student} distillation loss {dl.get(0)} at 0 -> {dl.get(99)} at 99 "
             "does not fall")
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 100, 10)) or not all(
            math.isfinite(v) for v in loss.values()):
        fail(f"{student} after distillation logged mse {loss}")
    if not loss[90] < loss[0]:
        fail(f"{student} after distillation: mse at 90 ({loss[90]}) is not under that "
             f"at 0 ({loss[0]})")
    step_rps = scal["rays_per_sec"][90]
    say(f"train: {student} distill loss {dl[0]:.6f} at 0 -> {dl[99]:.6f} at 99; mse "
        f"{loss[0]:.6f} at 0 -> {loss[90]:.6f} at 90 (ratio {loss[90] / loss[0]:.4f}); "
        f"photometric step {step_rps:.0f} rays/s ({cfg.num_random_rays} rays, "
        f"{cfg.num_samples} samples, {cfg.compute_dtype})")
    return {"teacher_fwd": counts[0], "fwd": counts[2], "bwd": counts[3],
            "step_rps": step_rps}


# ---------------------------------------------------------------- phase 23


def grid_model(torch, dev, interp_dtype: str, seed: int = 11, r: int = GRID_R):
    """The plenoxels config's model (128^3 x 28 over lego_siren.txt's
    grid_domain) with its init plus seeded N(0, 0.5) noise on every channel,
    so that interpolation and decode see varied values."""
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel

    model = PlenoxelsModel(grid_res=r, interp_dtype=interp_dtype, domain=GRID_DOMAIN).to(dev)
    with torch.no_grad():
        model.grid.add_(0.5 * torch.randn(model.grid.shape, device=dev,
                                          generator=torch.Generator(device=dev).manual_seed(seed)))
    return model


def image_rays(torch, dev, n: int, s: int, seed: int) -> tuple:
    """(rays_o, rays_d, t): the first ``n`` rays of a 400x400 orbit image in
    tile order (8x8 pixel blocks), sorted stratified t in [2, 6]."""
    from nerf_tpu_torch.data.poses import spherical_orbit
    from nerf_tpu_torch.data.rays import compute_rays_single
    from nerf_tpu_torch.ops.cuda.fused_grid import tile_ray_order

    focal = 0.5 * HW / np.tan(0.5 * CAMERA_ANGLE_X)
    o, d = compute_rays_single(HW, HW, focal, spherical_orbit(8)[1])
    perm = tile_ray_order(HW, HW)[:n]
    g = torch.Generator(device=dev).manual_seed(seed)
    t = 2.0 + 4.0 * (torch.arange(s, device=dev) + torch.rand(n, s, generator=g, device=dev)) / s
    return (torch.from_numpy(o[perm]).to(dev), torch.from_numpy(d[perm]).to(dev), t)


def grid_points(torch, dev, kind: str, n: int, s: int, seed: int):
    """(R_rays, S, 3) points in the grid's [-1, 1] space (normalised like
    the renderer's, then remapped from grid_domain): ``train`` rays of
    ``camera_batch`` (random cameras, incoherent), ``image`` tile-ordered
    rays of one view."""
    from nerf_tpu_torch.models.common import remap_domain

    if kind == "train":
        o, d, t, _ = camera_batch(torch, dev, n, s, seed)
    else:
        o, d, t = image_rays(torch, dev, n, s, seed)
    pts = o[:, None, :] + t[..., None] * d[:, None, :]
    return remap_domain(2.0 * (pts - 2.0) / 4.0 - 1.0, GRID_DOMAIN).contiguous()


def distinct_rows(torch, cells, r: int) -> int:
    """Grid rows with a nonzero-or-not corner weight at the float cell
    coordinates ``cells`` (..., 3): the rows a kernel must read."""
    x0 = torch.floor(cells).clamp(0, r - 2).long().reshape(-1, 3)
    base = (x0[:, 0] * r + x0[:, 1]) * r + x0[:, 2]
    ids = torch.cat([base + dx * r * r + dy * r + dz
                     for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    return int(torch.unique(ids).numel())


def timed(torch, fns: dict, order: tuple, batch: int = GRID_BATCH) -> dict:
    """Median ms of each named function in ``fns``, in runs of ``batch``
    calls between two events, in the turns of ``order`` (3 runs a turn)."""
    times = {k: [] for k in fns}
    for f in fns.values():
        f()                                                     # warm-up
    for name in order:
        f = fns[name]
        times[name] += [t / batch for t in time_calls(
            torch, lambda f=f: [f() for _ in range(batch)], 3)]
    return {k: statistics.median(v) for k, v in times.items()}


def check_grid_interp_kernel(torch, dev) -> dict:
    """Row 17 (csrc/fused_grid.cu) against its plain version: 1024 x 64 and
    1024 x 256 points of random training rays and of tile-ordered camera
    rays, float32 and bfloat16, on a 128^3 x 28 grid; timed in turns
    (plain, kernel, library, library, kernel, plain) with F.grid_sample on
    the grid laid out as (1, C, R, R, R) (made once, outside the timing)
    as the library call, against the bytes bound."""
    import torch.nn.functional as F

    from nerf_tpu_torch.ops.cuda.fused_grid import (
        cells_of, grid_interp, interp_cells_plain, pack_grid)

    results = {}
    for cdt in ("float32", "bfloat16"):
        model = grid_model(torch, dev, cdt)
        grid = model.grid.detach()
        src = pack_grid(grid, cdt)
        src = grid if src is None else src
        lib_grid = grid.permute(3, 0, 1, 2)[None].contiguous()        # (1, C, X, Y, Z)
        for kind in ("train", "image"):
            for s in (64, 256):
                pts = grid_points(torch, dev, kind, 1024, s, seed=s)
                flat = pts.reshape(-1, 3)
                coords = pts[..., [2, 1, 0]][None, :, :, None, :].contiguous()

                def plain():
                    return interp_cells_plain(src, cells_of(flat, GRID_R))

                def kern():
                    return grid_interp(src, flat)

                def lib():
                    return F.grid_sample(lib_grid, coords, mode="bilinear",
                                         padding_mode="border", align_corners=True)

                with torch.no_grad():
                    ref, out = plain(), kern()
                    libv = lib()[0, :, :, :, 0].permute(1, 2, 0).reshape(-1, GRID_C)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out).all():
                        fail(f"grid_interp {cdt} {kind} S={s}: non-finite output")
                    err = float((out - ref).abs().max())
                    lib_err = float((libv - interp_cells_plain(grid, cells_of(flat, GRID_R)))
                                    .abs().max())
                    ms = timed(torch, {"plain": plain, "kernel": kern, "library": lib},
                               ("plain", "kernel", "library", "library", "kernel", "plain"))
                    rows = distinct_rows(torch, cells_of(flat, GRID_R), GRID_R)
                n = flat.shape[0]
                nbytes = n * 12 + n * GRID_C * 4 + rows * GRID_C * src.element_size()
                bms = nbytes / PEAK_BYTES * 1e3
                say(f"kernel grid_interp {cdt} {kind} 1024x{s}: max_abs_err {err:.3e} "
                    f"(tol {GRID_TOL:.0e}) | kernel {ms['kernel']:.4f} ms, plain "
                    f"{ms['plain']:.4f} ms, library (F.grid_sample, float32) "
                    f"{ms['library']:.4f} ms (vs float32 plain {lib_err:.1e}), bound {bms:.4f} ms "
                    f"(bytes; {rows} distinct rows), share of bound {bms / ms['kernel']:.4f}")
                if err > GRID_TOL:
                    fail(f"grid_interp {cdt} {kind} S={s} disagrees with its plain version")
                results[(cdt, kind, s)] = dict(err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                                               library_ms=ms["library"], bound_ms=bms,
                                               bound_by="bytes")
                del ref, out, libv
                torch.cuda.empty_cache()
        del model, grid, src, lib_grid
        torch.cuda.empty_cache()
    return results


def check_scatter_kernel(torch, dev) -> dict:
    """Row 19 (csrc/scatter_add.cu) at the training step's 8 x 262,144 rows
    x 28 into 128^3: the corner ids of 1024 x 256 training-ray points, uniform
    ids, and uniform ids with one id repeated 65,536 times; values N(0, 1).
    Each row within (K + pieces) ulps of its float64 sum's magnitude
    (``SCATTER_ULPS``), the plain version within (n + 2) ulps; two runs
    identical bit for bit; timed in turns against the plain version and
    index_add_ on unsorted and sorted ids (the library calls)."""
    from nerf_tpu_torch.ops.cuda.fused_grid import cells_of
    from nerf_tpu_torch.ops.cuda.scatter_add import scatter_add_plain, scatter_add_rows

    rows = GRID_R ** 3
    pts = grid_points(torch, dev, "train", 1024, 256, seed=19).reshape(-1, 3)
    x0 = torch.floor(cells_of(pts, GRID_R)).clamp(0, GRID_R - 2).long()
    base = (x0[:, 0] * GRID_R + x0[:, 1]) * GRID_R + x0[:, 2]
    step_ids = torch.cat([base + dx * GRID_R * GRID_R + dy * GRID_R + dz
                          for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    m = step_ids.shape[0]
    g = torch.Generator(device=dev).manual_seed(23)
    uniform = torch.randint(0, rows, (m,), generator=g, device=dev)
    repeated = uniform.clone()
    repeated[torch.randperm(m, generator=g, device=dev)[:65536]] = rows // 2 + 77
    vals = torch.randn(m, GRID_C, generator=g, device=dev)
    results = {}
    for label, ids in (("step", step_ids), ("uniform", uniform), ("one id x 65536", repeated)):
        with torch.no_grad():
            a = scatter_add_rows(ids, vals, rows)
            b = scatter_add_rows(ids, vals, rows)
            plain = scatter_add_plain(ids, vals, rows)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            exact = torch.zeros(rows, GRID_C, dtype=torch.float64, device=dev).index_add_(
                0, ids, vals.double())
            mags = torch.zeros(rows, GRID_C, dtype=torch.float64, device=dev).index_add_(
                0, ids, vals.abs().double())
            counts = torch.bincount(ids, minlength=rows).double()[:, None]
            ulp = 2.0 ** -24
            k_ratio = float(((a.double() - exact).abs()
                             / ((SCATTER_ULPS + counts / SCATTER_ULPS + 2) * ulp * mags
                                + 1e-30)).max())
            p_ratio = float(((plain.double() - exact).abs()
                             / ((counts + 2) * ulp * mags + 1e-30)).max())
            err = float((a - plain).abs().max())
            touched = int((counts > 0).sum())
            longest = int(counts.max())
            zeros = bool((a[counts[:, 0] == 0] == 0).all())
            del exact, mags, b
            torch.cuda.empty_cache()
            sorted_ids, perm = torch.sort(ids, stable=True)
            sorted_vals = vals[perm]
            ms = timed(torch, {
                "plain": lambda: scatter_add_plain(ids, vals, rows),
                "kernel": lambda: scatter_add_rows(ids, vals, rows),
                "index_add_": lambda: torch.zeros(rows, GRID_C, device=dev).index_add_(
                    0, ids, vals),
                "index_add_ sorted": lambda: torch.zeros(rows, GRID_C, device=dev).index_add_(
                    0, sorted_ids, sorted_vals),
                "sort": lambda: torch.sort(ids.to(torch.int32), stable=True)},
                ("plain", "kernel", "index_add_", "index_add_ sorted", "sort", "sort",
                 "index_add_ sorted", "index_add_", "kernel", "plain"), batch=5)
        nbytes = m * 4 + m * GRID_C * 4 + rows * GRID_C * 4
        bms = nbytes / PEAK_BYTES * 1e3
        say(f"kernel scatter_add {label} {m}x{GRID_C} -> {rows} rows ({touched} touched, "
            f"longest run {longest}): error over its bound {k_ratio:.3f} (tol 1), plain "
            f"{p_ratio:.3f}; kernel vs plain max_abs_err {err:.3e}; two runs identical: "
            f"{same}; untouched rows zero: {zeros} | kernel (sort + zeros + kernel) "
            f"{ms['kernel']:.4f} ms (the stable sort alone {ms['sort']:.4f} ms), plain "
            f"{ms['plain']:.4f} ms, library index_add_ "
            f"{ms['index_add_']:.4f} ms (sorted ids {ms['index_add_ sorted']:.4f} ms), "
            f"bound {bms:.4f} ms (bytes), share of bound {bms / ms['kernel']:.4f}")
        if not (same and zeros and k_ratio <= 1.0 and p_ratio <= 1.0):
            fail(f"scatter_add {label}: not exact within its bound or not deterministic")
        results[label] = dict(err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                              library_ms=ms["index_add_"], bound_ms=bms, bound_by="bytes")
        del a, plain, sorted_vals
        torch.cuda.empty_cache()
    return results


def check_grid_render_kernel(torch, dev) -> dict:
    """Row 18 (csrc/fused_grid_render.cu) against its plain version at 1024 x
    256, 1000 x 256 and 1024 x 37 tile-ordered camera rays, float32 and
    bfloat16, on a 128^3 x 28 grid; timed in turns against the bytes
    bound. No single PyTorch call computes this function (no library
    time)."""
    from nerf_tpu_torch.models.plenoxels import sh_basis
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedGridRender, _expand_basis, grid_render_plain)

    results = {}
    for cdt in ("float32", "bfloat16"):
        model = grid_model(torch, dev, cdt)
        fr = FusedGridRender(model, 2.0, 6.0)
        with torch.no_grad():
            pack = fr.pack(model)
        src = model.grid.detach() if pack.packed is None else pack.packed
        for n, s in ((1024, 256), (1000, 256), (1024, 37)):
            o, d, t = image_rays(torch, dev, n, s, seed=n + s)
            o_aff, d_aff = fr.affine(o, d, GRID_R)
            bexp = _expand_basis(sh_basis(d, 2)).contiguous()

            def plain():
                return grid_render_plain(src, o_aff, d_aff, t, bexp, fr.sel)

            def kern():
                return fr._launch(src, o_aff, d_aff, t, bexp)

            def wrapper():
                return fr(pack, o, d, d, t)

            with torch.no_grad():
                ref, out = plain(), wrapper()
                torch.cuda.synchronize()
                errs = {}
                for i, k in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[k]).all():
                        fail(f"grid_render {cdt} {n}x{s}: non-finite {k}")
                    errs[k] = float((out[k] - ref[i]).abs().max())
                ms = timed(torch, {"plain": plain, "kernel": kern, "wrapper": wrapper},
                           ("plain", "kernel", "wrapper", "wrapper", "kernel", "plain"))
                cells = (o_aff[:, None, :] + d_aff[:, None, :] * t[..., None]).clamp(0, GRID_R - 1)
                rows = distinct_rows(torch, cells, GRID_R)
            nbytes = n * (24 + 12 + 20) + 2 * n * s * 4 + rows * GRID_C * src.element_size()
            bms = nbytes / PEAK_BYTES * 1e3
            bad = {k: v for k, v in errs.items() if v > GRID_RENDER_TOL[k]}
            say(f"kernel grid_render {cdt} {n}x{s}: max_abs_err "
                + " ".join(f"{k}={v:.3e}(tol {GRID_RENDER_TOL[k]:.0e})" for k, v in errs.items())
                + f" | kernel {ms['kernel']:.4f} ms (with the wrapper's affine and basis "
                f"{ms['wrapper']:.4f} ms), plain {ms['plain']:.4f} ms, bound "
                f"{bms:.4f} ms (bytes; {rows} distinct rows), share of bound "
                f"{bms / ms['kernel']:.4f}")
            if bad:
                fail(f"grid_render {cdt} {n}x{s} disagrees with its plain version: {bad}")
            results[(cdt, n, s)] = dict(err=max(errs.values()), ms=ms["kernel"],
                                        plain_ms=ms["plain"], library_ms=None, bound_ms=bms,
                                        bound_by="bytes")
            del ref, out
            torch.cuda.empty_cache()
        del model, pack, src
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 24


def serve_plenoxels(torch, dev, tmp: str) -> int:
    """Phase 24: the plenoxels config (lego_siren.txt with
    PLENOXELS_OVERRIDES) from a seeded checkpoint (grid_model's noise on the
    init) served as phase 8: 157 fused grid render launches a request (tile
    order), one image held within mean abs 1e-2 of the unfused render
    through the module with float32 interpolation (row 17)."""
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender

    def init(model):
        with torch.no_grad():
            g = torch.Generator().manual_seed(11)
            model.grid.add_(0.5 * torch.randn(model.grid.shape, generator=g))

    def float32_module(model):
        import copy

        ref = copy.copy(model)
        ref.interp_dtype = "float32"
        return ref

    return serve(torch, dev, tmp, "lego_siren.txt", FusedGridRender, "grid_render_kernel",
                 "plenoxels", PLENOXELS_OVERRIDES, init=init, reference=float32_module)


# ---------------------------------------------------------------- phase 25


def train_plenoxels(torch, dev, tmp: str) -> dict:
    """Phase 25: fit() on the plenoxels config, 200 iterations with
    tv_lambda = 1e-5 and tv_sh_lambda = 1e-3 (logs every 10, validation and
    saves every 100): finite losses, the mse at 190 under that at 0, exactly
    one row-17 and one row-19 launch a step and 157 row-18 launches for the
    validation image; a bit-identical resume from step 100; then a fit from
    grid_res = 64 with upsample_steps = "50:128" (100 iterations) whose
    checkpoint reads grid_res 128 and whose resume restores a 128^3 grid;
    the step's rate and a profile of one step."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.ops.cuda.fused_grid import GridKernel
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedGridRender
    from nerf_tpu_torch.ops.cuda.scatter_add import ScatterKernel
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config
    from nerf_tpu_torch.utils.checkpoint import read_metadata

    base = parse_config_file(os.path.join(ROOT, "configs", "lego_siren.txt"))
    cfg = dataclasses.replace(
        base, model_type="plenoxels", dataset_path=os.path.join(tmp, "scene"), num_iters=200,
        log_interval=10, val_interval=100, save_interval=100, tv_lambda=1e-5,
        tv_sh_lambda=1e-3, save_path=os.path.join(tmp, "train_models_plenoxels"),
        log_dir=os.path.join(tmp, "train_logs_plenoxels"), **PLENOXELS_OVERRIDES)
    lines: list = []
    GridKernel.launches = ScatterKernel.launches = FusedGridRender.launches = 0
    t0 = time.perf_counter()
    state = fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (GridKernel.launches, ScatterKernel.launches, FusedGridRender.launches)
    say(f"train: fit plenoxels (lego_siren.txt, {PLENOXELS_OVERRIDES}, tv_lambda 1e-5, "
        f"tv_sh_lambda 1e-3) 200 iterations in {wall:.1f} s; launches: grid_interp "
        f"{counts[0]}, scatter_add {counts[1]}, grid_render {counts[2]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line:
            say(f"  {line}")
    want = (200, 200, math.ceil(HW * HW / cfg.chunk_size))
    if counts != want:
        fail(f"fit plenoxels launched (grid_interp, scatter_add, grid_render) {counts}, "
             f"want {want}")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    if sorted(loss) != list(range(0, 200, 10)) or not all(
            math.isfinite(v) for v in loss.values()):
        fail(f"plenoxels logged mse {loss}")
    if not loss[190] < loss[0]:
        fail(f"plenoxels: mse at 190 ({loss[190]}) is not under that at 0 ({loss[0]})")
    step_rps = scal["rays_per_sec"][190]
    say(f"train: mse {loss[0]:.6f} at 0 -> {loss[190]:.6f} at 190 (ratio "
        f"{loss[190] / loss[0]:.4f}); plenoxels step {step_rps:.0f} rays/s "
        f"({cfg.num_random_rays} rays, {cfg.num_samples} samples, grid "
        f"{state.params.grid_res}^3 x {GRID_C} float32)")
    check_resume(torch, dev, tmp, cfg, "plenoxels", loss)
    scene = load_scene(cfg, device=dev)
    profile_step(torch, state, scene.pool, render_settings_from_config(cfg), cfg,
                 ("grid_interp_kernel", "scatter_pieces_kernel", "scatter_runs_kernel"),
                 "plenoxels (tv)")
    del state, scene
    torch.cuda.empty_cache()

    up = dataclasses.replace(cfg, grid_res=UPSAMPLE[0], upsample_steps=f"50:{UPSAMPLE[1]}",
                             num_iters=100,
                             val_interval=1000, save_path=os.path.join(tmp, "upsample_models"),
                             log_dir=os.path.join(tmp, "upsample_logs"))
    lines = []
    t0 = time.perf_counter()
    fit(up, device=dev, log=lines.append)
    ckpt = os.path.join(up.save_path, "plenoxels_model_000100")
    meta = read_metadata(ckpt)
    ups = [line for line in lines if "Upsampled" in line]
    say(f"train: fit plenoxels from grid_res {UPSAMPLE[0]} with upsample_steps "
        f"{up.upsample_steps}, 100 iterations in {time.perf_counter() - t0:.1f} s: {ups}; "
        f"checkpoint metadata {meta}")
    if meta.get("grid_res") != UPSAMPLE[1] or len(ups) != 1 or "iteration 50" not in ups[0]:
        fail(f"upsample: checkpoint grid_res {meta.get('grid_res')}, log {ups}")
    resumed = fit(dataclasses.replace(up, num_iters=110,
                                      save_path=os.path.join(tmp, "upsample_resume")),
                  resume_path=ckpt, device=dev, log=lambda *_: None)
    shape = tuple(resumed.params.grid.shape)
    say(f"train: resume from the upsampled checkpoint (config grid_res {UPSAMPLE[0]}) "
        f"restores grid {shape}, state.step {resumed.step}")
    if shape != (UPSAMPLE[1],) * 3 + (GRID_C,) or resumed.step != 110:
        fail(f"upsample resume: grid {shape}, state.step {resumed.step}")
    del resumed
    torch.cuda.empty_cache()
    return {"grid_interp": counts[0], "scatter_add": counts[1], "grid_render": counts[2],
            "step_rps": step_rps}


# ---------------------------------------------------------------- phase 26


def bench_plenoxels(torch, dev) -> dict:
    """bench.py's plenoxels protocols on the card: train_plenoxels (S = 64)
    and train_plenoxels_occ (S = 16, an all-ones 32^3 prior at fit's
    options), each 2 warm-up steps then 12 timed chained steps (per-step
    dispatch, 1024 rays, the 1<<20 pool), and
    render_plenoxels_dense (400x400, 256 samples, no fine pass, tile order,
    chunk 8192: one warm-up frame, 3 timed), in rays/s."""
    from nerf_tpu_torch.config import Config
    from nerf_tpu_torch.data.poses import spherical_orbit
    from nerf_tpu_torch.data.rays import compute_rays_single
    from nerf_tpu_torch.models.plenoxels import PlenoxelsModel
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import make_eval_render

    def model():
        return PlenoxelsModel(domain=grid_domain(Config())).to(dev)

    out = {}
    out["train_plenoxels"] = bench_train(
        torch, dev, model(), 12, 2, "bench train_plenoxels (bench.py protocol, Plenoxels "
        "128^3 1024x64)", num_samples=64)
    torch.cuda.empty_cache()
    occ = torch.ones((32, 32, 32, 1), device=dev)
    out["train_plenoxels_occ"] = bench_train(
        torch, dev, model(), 12, 2, "bench train_plenoxels_occ (bench.py protocol, Plenoxels "
        "128^3 1024x16, occupancy 32^3)", num_samples=16,
        occupancy=(occ, (grid_domain(Config()), 64, 1e-2)))
    torch.cuda.empty_cache()
    cfg = Config(num_samples=256, num_fine_samples=0, model_type="plenoxels")
    settings = render_settings_from_config(cfg)
    m = model()
    render = make_eval_render(m, settings)
    focal = 0.5 * HW / np.tan(0.5 * 0.6911)
    ro, rd = compute_rays_single(HW, HW, focal, spherical_orbit(4)[0])
    ro, rd = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)

    def frame(i):
        g = torch.Generator(device=dev).manual_seed(i)
        return float(render(m, None, ro, rd, g, hw=(HW, HW)).rgb[0, 0])

    frame(0)
    t0 = time.perf_counter()
    for i in range(3):
        frame(i + 1)
    dt = (time.perf_counter() - t0) / 3
    out["render_plenoxels_dense"] = HW * HW / dt
    say(f"bench render_plenoxels_dense (bench.py protocol, {HW}x{HW}, 256 samples, chunk "
        f"{settings.chunk_size}): {HW * HW / dt:.0f} rays/s, {dt * 1e3:.1f} ms per frame")
    del m, render
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 6


def bench_train(torch, dev, model, steps: int, warmup: int, label: str,
                num_samples: int = 256, occupancy: tuple | None = None) -> float:
    """bench.py's train protocol for ``model`` (bf16): 1024 rays x
    ``num_samples`` samples per ray (per-ray jitter), white background, a
    1<<20 synthetic pool made on the card, ``warmup`` steps, then ``steps``
    chained steps timed to a scalar fetched on the host; ``occupancy`` =
    (grid, options) samples the coarse pass from that prior."""
    from nerf_tpu_torch.config import Config
    from nerf_tpu_torch.data.pipeline import RayPool
    from nerf_tpu_torch.render.renderer import RenderSettings
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import TrainState
    from nerf_tpu_torch.train.step import make_train_step

    state = TrainState(step=0, params=model, fine_params=None,
                       optimizer=make_optimizer(Config(), list(model.parameters())))
    g = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 20
    rays_d = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g, device=dev), dim=-1)
    pool = RayPool(rays_o=torch.randn(n, 3, generator=g, device=dev) * 0.1,
                   rays_d=rays_d, rgb=torch.rand(n, 3, generator=g, device=dev),
                   viewdirs=rays_d)
    settings = RenderSettings(near=2.0, far=6.0, num_samples=num_samples,
                              white_background=True, jitter_mode="per_ray")
    occ_grid, opts = occupancy if occupancy is not None else (None, None)
    step = make_train_step(model, settings, 1024, seed=2, occupancy_opts=opts)
    for _ in range(warmup):
        m = step(state, pool, occ_grid)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, pool, occ_grid)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail(f"{label}: non-finite loss")
    rps = steps * 1024 / dt
    say(f"{label}: {rps:.0f} rays/s, {dt / steps * 1e3:.2f} ms per step "
        f"({steps} chained steps)")
    return rps


def bench_headline(torch, dev) -> float:
    """bench.py's headline: flat NeRF, bf16, 5 warm-up steps, 30 timed."""
    from nerf_tpu_torch.models.nerf import NeRFModel

    model = NeRFModel(compute_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 30, 5, "bench headline (bench.py "
                       "protocol, flat NeRF bf16 1024x256)")


def bench_siren(torch, dev) -> float:
    """bench.py's train_siren row: flat SIREN, bf16, warm-up (two calls of
    10 steps there: 20 steps), then 5 x 10 = 50 timed steps."""
    from nerf_tpu_torch.models.siren import SirenModel

    model = SirenModel(compute_dtype="bfloat16",
                       generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 50, 20, "bench train_siren (bench.py "
                       "protocol, flat SIREN bf16 1024x256)")


def bench_gabor(torch, dev) -> float:
    """bench.py's train_gabor row: flat GaborNet, bf16, the train_siren
    protocol (20 warm-up steps, 50 timed)."""
    from nerf_tpu_torch.models.gabor import GaborModel

    model = GaborModel(compute_dtype="bfloat16",
                       generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 50, 20, "bench train_gabor (bench.py "
                       "protocol, flat GaborNet bf16 1024x256)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from nerf_tpu_torch.ops.cuda import build
        from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
        from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
        from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
        from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
    except ImportError as e:
        print(f"chip_smoke: nerf_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    infos = build.build()
    say(f"build: {len(infos)} libraries in {time.perf_counter() - t0:.1f} s "
        "(one nvcc per source, in parallel)")
    for info in infos:
        say(f"build: {info.name} {info.seconds:.1f} s -> "
            f"{os.path.relpath(info.path, ROOT)}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas: {line.strip()}")

    checks = check_kernel(torch, dev)
    grad_checks = check_grad_kernels(torch, dev)
    siren_checks = check_siren_kernels(torch, dev)
    gabor_checks = check_gabor_kernels(torch, dev)
    kilo_checks = check_kilonerf_kernels(torch, dev)
    field_checks = check_nerf_field_kernels(torch, dev)
    sg_checks = check_siren_gabor_field_kernels(torch, dev)
    interp_checks = check_grid_interp_kernel(torch, dev)
    scatter_checks = check_scatter_kernel(torch, dev)
    render_checks = check_grid_render_kernel(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve(torch, dev, tmp, "lego.txt", FusedNerfRender,
                         "fused_render_fwd")
        trained = train(torch, dev, tmp, "lego.txt", FusedNerfRender,
                        "fused_render_grad", 0.5)
        siren_launches = serve(torch, dev, tmp, "lego_siren.txt", FusedSirenRender,
                               "fused_siren_fwd")
        siren_trained = train(torch, dev, tmp, "lego_siren.txt", FusedSirenRender,
                              "fused_siren_grad", 1.0)
        gabor_launches = serve(torch, dev, tmp, "lego_siren.txt", FusedGaborRender,
                               "fused_gabor_fwd", "gabor")
        gabor_trained = train(torch, dev, tmp, "lego_siren.txt", FusedGaborRender,
                              "fused_gabor_train", 1.0, "gabor")
        kilo_launches = serve(torch, dev, tmp, "lego_siren.txt", KiloNeRFField,
                              "fused_kilonerf_fwd", "kilonerf", KILO_OVERRIDES)
        kilo_trained = train_kilonerf(torch, dev, tmp)
        lego_ckpt = os.path.join(tmp, "train_models_nerf", "nerf_model_000200")
        occ_served = serve_occupancy(torch, dev, tmp, lego_ckpt)
        distilled = train_distill_occupancy(torch, dev, tmp, lego_ckpt)
        sg_ckpt = {f: os.path.join(tmp, f"train_models_{f}", f"{f}_model_000200")
                   for f in ("siren", "gabor")}
        sg_served = {f: serve_occupancy_sg(torch, dev, tmp, f, sg_ckpt[f])
                     for f in ("siren", "gabor")}
        sg_distilled = {f: train_distill_cross(torch, dev, tmp, f,
                                               sg_ckpt["gabor" if f == "siren" else "siren"])
                        for f in ("gabor", "siren")}
        grid_served = serve_plenoxels(torch, dev, tmp)
        grid_trained = train_plenoxels(torch, dev, tmp)
    bench_headline(torch, dev)
    bench_siren(torch, dev)
    bench_gabor(torch, dev)
    bench_kilonerf(torch, dev)
    bench_plenoxels(torch, dev)

    def row(name, source, line, launched, c, err):
        return {"name": name, "route": "cuda",
                "source": f"nerf_tpu_torch/csrc/{source}", "replaces": line,
                "launches": launched, "max_abs_err": err, "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None}

    nerf_tpu = "nerf_tpu/ops/pallas/"
    kernels = [row("fused_render_fwd", "fused_render_fwd.cu",
                   f"{nerf_tpu}fused_render.py:222", launches,
                   checks[("bfloat16", 192)],
                   max(c["err"] for c in checks.values()))]
    for name, line, launched in (
            ("fused_render_train", 315, trained["train_launches"]),
            ("fused_render_bwd", 242, trained["bwd_launches"])):
        kernels.append(row(name, "fused_render_train.cu",
                           f"{nerf_tpu}fused_render.py:{line}", launched,
                           grad_checks[(name, "bfloat16", 192)],
                           max(v["err"] for k, v in grad_checks.items()
                               if k[0] == name)))
    for name, source, line, launched in (
            ("fused_render_siren_fwd", "fused_render_siren_fwd.cu", 60,
             siren_launches),
            ("fused_render_siren_train", "fused_render_siren_train.cu", 110,
             siren_trained["train_launches"]),
            ("fused_render_siren_bwd", "fused_render_siren_train.cu", 82,
             siren_trained["bwd_launches"])):
        kernels.append(row(name, source, f"{nerf_tpu}fused_render_siren.py:{line}",
                           launched, siren_checks[(name, "bfloat16")],
                           max(siren_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched in (
            ("fused_render_gabor_fwd", 166, gabor_launches),
            ("fused_render_gabor_train", 186, gabor_trained["train_launches"])):
        kernels.append(row(name, f"{name}.cu", f"{nerf_tpu}fused_render_gabor.py:{line}",
                           launched, gabor_checks[(name, "bfloat16")],
                           max(gabor_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched in (
            ("fused_kilonerf_fwd", 367, kilo_launches + kilo_trained["fwd_launches"]),
            ("fused_kilonerf_bwd", 394, kilo_trained["bwd_launches"])):
        kernels.append(row(name, f"{name}.cu", f"{nerf_tpu}fused_kilonerf.py:{line}",
                           launched, kilo_checks[(name, "bfloat16")],
                           max(kilo_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched, n in (
            ("fused_nerf_fwd", 233,
             occ_served["bake_launches"] + distilled["fwd_launches"], 65536),
            ("fused_nerf_bwd", 333, distilled["bwd_launches"], 16384)):
        kernels.append(row(name, f"{name}.cu", f"{nerf_tpu}fused_nerf.py:{line}",
                           launched, field_checks[(name, "bfloat16", n)],
                           max(field_checks[(name, c, n)]["err"]
                               for c in ("float32", "bfloat16"))))
    for family, other in (("siren", "gabor"), ("gabor", "siren")):
        fwd_launched = (sg_served[family]["bake_launches"] + sg_distilled[family]["fwd"]
                        + sg_distilled[other]["teacher_fwd"])
        for name, line, launched, n in (
                (f"fused_{family}_fwd", {"siren": 103, "gabor": 96}[family],
                 fwd_launched, 65536),
                (f"fused_{family}_bwd", {"siren": 117, "gabor": 110}[family],
                 sg_distilled[family]["bwd"], 16384)):
            kernels.append(row(name, f"{name}.cu", f"{nerf_tpu}fused_{family}.py:{line}",
                               launched, sg_checks[(name, "bfloat16", n)],
                               max(sg_checks[(name, c, n)]["err"]
                                   for c in ("float32", "bfloat16"))))
    for name, source, line, launched, c, err in (
            ("grid_interp", "fused_grid.cu", "fused_grid.py:160", grid_trained["grid_interp"],
             interp_checks[("float32", "train", 256)],
             max(v["err"] for v in interp_checks.values())),
            ("grid_render", "fused_grid_render.cu", "fused_grid_render.py:76",
             grid_served + grid_trained["grid_render"], render_checks[("bfloat16", 1024, 256)],
             max(v["err"] for v in render_checks.values())),
            ("scatter_add", "scatter_add.cu", "scatter_add.py:56", grid_trained["scatter_add"],
             scatter_checks["step"], max(v["err"] for v in scatter_checks.values()))):
        kernels.append(dict(row(name, source, f"{nerf_tpu}{line}", launched, c, err),
                            library_ms=c["library_ms"]))
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
