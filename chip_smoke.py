#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero with no result:

  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. the build of every kernel library from the sources in the checkout
     (one nvcc per source, started together with phase 35's NeRF, phase
     36's SIREN and phase 37's GaborNet libraries at the wider shapes;
     those run at niceness 19 and build while phases 3-34 run, waited for
     before phase 35), timed,
     and the count of
     tensor-core instructions in the SASS of the fourteen bf16 libraries
     on the tensor cores (the NeRF, SIREN and GaborNet train passes, the
     NeRF, SIREN and GaborNet forward renders, the KiloNeRF, NeRF, SIREN
     and GaborNet field forwards and backwards; cuobjdump): a library
     without one fails;
  3. every kernel against its plain PyTorch version on the card (TF32 off):
     the forward render at the serving shapes (8192 rays x 64 and 192
     samples), the train pass and the render backward at the training
     shapes (1024 rays x 64, 192 and 256 samples), hidden 256, float32 and
     bfloat16 (the bfloat16 forward render and train pass on the tensor
     cores, each run twice for identical bits and timed beside the
     CUDA-core kernel it replaced; the forward render's rgb, acc and
     weights against the train pass's on one 1024 x 64 batch): max errors
     against stated tolerances, the two backward routes against each
     other, median times in turns (plain, kernel, kernel, plain), the least
     time the card could take, and the share reached;
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
     timed chained steps) in rays/s, and torch.profiler traces of one
     lego.txt step and of one headline step: the train kernels' share of
     wall time, the other kernels, the device idle share;
  7. the SIREN kernels against their plain versions on the card (TF32
     off): the forward render at configs/lego_siren.txt's chunk and samples
     (1024 rays x 256), a ragged ray count (1000 x 256) and an odd S (1024 x
     37), the train pass and the render backward at 1024 x 256, float32 and
     bfloat16 (in bfloat16 all three on the tensor cores, each run twice
     for identical bits and timed beside the CUDA-core kernel it replaced;
     the forward render's rgb, acc and weights equal to the train pass's on
     one 1024 x 64 batch, and the compositing weights the render backward
     recomputes equal to the forward render's at 1024 x 256 and 1024 x
     37), timed in turns against their plain versions and their bound;
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
     off): the forward render and the train pass at 1024 x 256, 1000 x 256
     and 1024 x 37 (the train pass: loss, rgb, acc, weights, every weight
     gradient, the coefficient cotangents dA..dR, and the filter gradients
     after autograd through the prep), float32 and bfloat16 (in bfloat16
     both on the tensor cores, run twice for identical bits and timed
     beside the CUDA-core kernels they replaced; the forward render's rgb,
     acc and weights equal to the train pass's on a 1024 x 64 batch), timed
     in turns at 1024 x 256 against their plain versions and their bound;
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
     (empty networks: exactly zero gradients), two forward and two
     backward launches compared bit for bit, the bf16 forward's and
     backward's HMMA counts (both on the tensor cores), and the (rgb,
     sigma) the bf16 backward recomputes (its debug output) equal to the
     forward's bit for bit; at the camera set the forward's device time
     from a CUDA graph of 20 calls between events, the backward and both
     plain versions timed in turns (runs of 20 launches per pair of
     events), against their bound;
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
     the bfloat16 forward and backward run on the tensor cores, each twice
     for identical bits at every point set, their times printed beside the
     CUDA-core kernels' they replaced; the forward that the bfloat16
     backward recomputes is read from its stash at every point set and
     must equal the forward's output bit for bit (in float32 at 16,384
     points, where both are one chain); the bfloat16 backward also timed
     at each run of RUN_SWEEP (points a CTA: grid, partial bytes, ms);
 18. serving lego.txt with --occupancy 64 from phase 5's trained
     checkpoint: the bake's four field-kernel launches, its wall time
     (median of three bakes through the packed field) and occupied share,
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
     one occupancy-guided step; the wall time of a distillation step;
 20. the SIREN and GaborNet field kernels (forward and backward) against
     their plain versions on the card (TF32 off), lego_siren.txt's model
     (hidden 256, 8 layers / stages), float32 and bfloat16, on phase 17's
     point sets: rgb, sigma and every gradient (weights, the GaborNet's
     filter banks after autograd through the packing, points, directions);
     each timed in turns at 65,536 and 16,384 points (runs of 20 launches
     per pair of events) against its bound; the bfloat16 forwards run on
     the tensor cores, twice for identical bits at every point set, their
     times printed beside the CUDA-core kernels' they replaced, and so do
     the SIREN's and the GaborNet's bfloat16 backwards, with their
     recompute (equal to the forward's output bit for bit at every point
     set) and their run sweep as in 17;
 21. serving lego_siren.txt and its GaborNet variant with --occupancy 64
     from phase 9's and phase 12's checkpoints: four field-kernel launches
     per bake, its wall time as in 18, the grid equal to the one baked
     through the plain version,
     three 400x400 requests (157 render launches each, no field launch),
     each within mean abs 1e-2 of the unfused render with the same grid,
     their times and a profile of one;
 22. cross-family distillation through fit(): a GaborNet student of
     lego_siren.txt from phase 9's SIREN checkpoint, and a SIREN student
     from phase 12's GaborNet checkpoint, each 100 distillation steps of
     16,384 points (the loss falls; 100 teacher forward, 100 student
     forward and 100 student backward launches), then 100 photometric
     steps (the mse at 90 under that at 0; one validation image, 157
     forward launches), the step's rate and the wall time of a
     distillation step.

 23. the voxel-grid kernels against their plain versions on the card (TF32
     off), a 128^3 x 28 grid (the plenoxels config's) with seeded values:
     the trilinear interpolation (row 17) at 1024 x 64 and 1024 x 256
     points of random training rays and of tile-ordered camera rays,
     float32 and bfloat16, beside F.grid_sample; the scatter-add (row 19,
     its radix sort and every output row in the call) at the training step's 8 x 262,144 rows x 28 (the step's
     corner ids, uniform ids, one id 65,536 times; and Instant NGP's step,
     8,388,608 corner rows of 2 into 16 x 2^19 rows) against float64 sums,
     twice for identical bits, beside index_add_ on unsorted and sorted
     ids; the fused grid render (row 18) at 1024 x 256, 1000 x 256,
     1024 x 37, 1024 x 1 and 64 x 1000, float32 and bfloat16, two launches
     compared bit for bit (its device time from a CUDA graph of 20 calls
     between events, its wrapper and plain version timed in turns); each
     against its bytes bound;
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
     protocols in rays/s;
 27. row 18's factor form (the baked FastNeRF cache) against its plain
     version on the card (TF32 off): a seeded full-width FastNeRF (hidden
     256, D = 8, L = 10/4) baked at 128^3 / dir_res 64 (the bake's wall
     time), 1024 x 256, 1000 x 256, 1024 x 37, 1024 x 1 and 64 x 1000
     tile-ordered camera rays, float32 and bfloat16, two launches compared
     bit for bit, the kernel's device time from a CUDA graph of 20 calls,
     the wrapper (beta included) and the plain version timed in turns,
     against the bytes bound;
 28. FastNeRF on configs/lego.txt (model_type = fastnerf: full width, 64 +
     128 samples, bf16): fit() for 200 iterations through the module
     (finite losses, the mse at 190 under that at 0), a bit-identical
     resume from step 100, a profile of one step; then RenderService with
     bake = 128 behind the HTTP server: 40 factor-form launches a 400x400
     request, no matrix-product kernel in a request (torch.profiler), one
     image within mean abs 1e-2 of the unfused render of the same cache
     (the module with float32 interpolation); the bake's wall time and the
     request times;
 29. PlenOctrees on configs/lego.txt (model_type = plenoctree, SH degree
     2: 28 channels) as in 28, served with bake = 128 through row 18's SH
     form (40 launches a request), one image within mean abs 1e-2 of the
     unfused render of the baked grid;
 30. the eval CLI (nerf_tpu_torch.cli.eval_cli.main, in-process, on the
     card) from the checkpoints of phases 5, 9 and 28: (a) 4 lego.txt orbit
     frames at 400x400 with --video orbit.gif (40 forward launches a frame,
     each frame within mean abs 1e-2 of the unfused render of the same pose,
     the GIF read back as the quantised frames); (b) lego_siren.txt with
     --metrics over the test split (157 launches a view, metrics.json
     finite with nerf_tpu's keys, each view's PSNR inside the interval its
     pred_*.png allows); (c) the FastNeRF checkpoint with --bake 128 (40
     factor-form launches a frame); (d) lego_siren.txt with --occupancy 64,
     one frame (4 field launches for the bake, 157 render launches); each
     part's wall ms a frame beside the card;
 31. LLFF with NDC rays (configs/fern.txt: NeRF hidden 256, bf16, 64 + 64
     samples, black background) on a synthetic forward-facing scene at
     fern's shapes (20 views, images_8/ PNGs of 504x378, poses_bounds.npy
     with the full 3024x4032 hwf): (a) rows 3 and 5 in this mode against
     their plain versions (TF32 off), float32 and bfloat16, at 1024 x 128
     and 8192 x 64 (normalize off, NDC rays and t in [0, 1] from the
     scene's pool, its world view directions; the train pass with a black
     and a white background), timed against the plain versions and the
     bound; (b) fit() 200 iterations (2 train launches a step, 48 forward
     launches for the validation frame, the mse at 190 under half of that
     at 0) and a resume from step 100 to 220 that repeats the first run's
     mse bit for bit; (c) one spiral-pose request over HTTP (a 504x378
     PNG, 48 launches, within mean abs 1e-2 of the unfused render of the
     same NDC rays); (d) the eval CLI: 4 spiral frames (48 launches each,
     each within mean abs 1e-2 of the unfused render) and --metrics over
     the 3 test views;
 32. Instant NGP (configs/ngp_synthetic.txt: 16 levels of 2^19 x 2 hash
     tables, hidden 256, 64 samples, float32, a 32^3 occupancy prior) on
     phase 4's scene: the hash rows on the card equal to the CPU's; fit()
     200 iterations with a rebake at 100 (one scatter-add launch a step:
     the tables' gradient), the mse falling; a resume from step 100 that
     repeats the first run's mse bit for bit; a profiled step; one request
     over HTTP and one eval frame, 400x400 and finite;
 33. the parallel layer and the interchange: (a) phase 5's checkpoint
     exported to the reference's .pth (coarse and fine) and imported back
     bit for bit, the step kept, and the imported checkpoint served on cuda
     (a 400x400 PNG, 40 forward launches); (b) multiscene_cli on lego.txt at
     full width over four synthetic 400x400 scenes of seeded shades, 200
     iterations: finite losses, each scene's mse at 190 under half of its
     mse at 0, exactly 4 x 2 x 200 train launches and 4 x 40 forward
     launches a validation, the stacked checkpoints, a resume from 100 to
     120 that repeats every scene's mse bit for bit in 4 x 2 x 20 train
     launches, the aggregate rate beside phase 5's and a profiled 4-scene
     step (4 x 2 x 2 train launches with its warm-up); (c) fit() 20 iterations
     with multihost = true in an NCCL group of one rank, equal to the fit
     without a group bit for bit, and the all_reduce's time a step; (d) two
     processes on the card in a gloo group (named: NCCL takes one rank a
     GPU): fit() on data:2 within 1e-5 relative of the one-process losses
     in float32, and over the first 10 steps in bfloat16 (its later drift
     printed), and
     fit_multiscene on scene:2,data:1 equal to (b)'s first two scenes bit
     for bit, and gloo's all_reduce time;
 34. event files and JPEG frames: (a) the TensorBoard event files of phase
     5's fit and phase 33 (b)'s run, read by a record reader written here
     (both CRC32Cs of every record, the Event protobuf): every train.log
     scalar as one float32 event, val/render within one level of each val
     PNG, the config text, scene{i}/val_render of each scene; MetricLogger's
     log_train and log_validation timed on the host; (b) the JPEG fixtures
     of tests/data/jpeg/ decoded to their committed hashes, one 1008x756
     frame timed, and configs/fern.txt on the committed JPEG capture
     (tests/data/jpeg/llff: 20 images/ JPEGs, llff_factor 2, downsampled
     to 504x378 on load): load_scene timed, fit() 200 iterations (2 train
     launches a step, the mse at 190 under half of that at 0) and one
     spiral request over HTTP (48 launches, within mean abs 1e-2 of the
     unfused render).
 35. the NeRF kernels at the wider shapes nerf_tpu's take (each shape's
     libraries started in phase 2 with its plan's -D flags,
     nerf_tpu_torch/ops/cuda/nerf_plan.py): (a) rows 1-5 at hidden 1024
     with L = 10 / 4 (p_pad 64, d_pad 32) and at 512 and 1024 with L = 12
     / 6 (p_pad 128, d_pad 64; 512 at L = 10 / 4 and 768 in the card tests
     only), float32 and bfloat16, against their plain versions (row 3
     at 8192 x 64, rows 4-5 at 1024 x 64 and 192, rows 1-2 at 65,536,
     16,384 and 37 points; the bf16 field backward under WIDE_FIELD_TOL
     beside the plain version's own spread from float64 sums, the f32 one
     at 1024 under WIDE_F32_GRAD_TOL), each twice for identical bits, timed
     against its bound; (b) configs/lego.txt at hidden_dim = 1024 on the
     synthetic scene: fit() 40 iterations (the mse falls), a resume 20 ->
     30 bit for bit, two render-route steps (rows 3 and 4), one
     --occupancy 64 request (row 1's bake at 1024) and one eval CLI frame,
     each within mean abs 1e-2 of the unfused render; (c) fit() with
     distill_from = (b)'s checkpoint: 20 distillation steps of 16,384
     points (the teacher's row 1 and the student's rows 1 and 2, both at
     1024; the loss falls), then 10 iterations. The launches of rows 1-5
     on (b) and (c) are the wrappers' counts by shape (shape_launches).
     ``python3 chip_smoke.py --phase 35`` runs the build and phase 35
     alone.
 36. the SIREN kernels at the wider shapes nerf_tpu's take (each shape's
     libraries started in phase 2 with its plan's -D flags,
     nerf_tpu_torch/ops/cuda/siren_plan.py): (a) rows 6-10 at hidden 1024
     (L_d = 4: d_pad 32) and 512 with L_d = 6 (d_pad 64), float32 and
     bfloat16, against their plain versions under phases 7 and 20's
     tolerances (row 6 at lego_siren.txt's serving chunk, 1024 x 256, rows
     7-8 at 1024 x 256, rows 9-10 at 65,536 lattice points), each launched
     twice for identical bits, timed against its bound (siren_macs at the
     case's widths); hidden 768 is held in tests/test_torch_port_cuda.py
     only; (b) configs/lego_siren.txt at hidden_dim = 1024 on the synthetic
     scene: fit() 40 iterations (the mse falls), a resume 20 -> 30 bit for
     bit, two render-route steps (rows 6 and 7), one --occupancy 64 request
     (row 9's bake at 1024, then row 6) and one eval CLI frame, each within
     mean abs 1e-2 of the unfused render; (c) fit() with distill_from =
     (b)'s checkpoint: 20 distillation steps of 16,384 points (the
     teacher's row 9 and the student's rows 9 and 10, all at 1024; the loss
     falls), then 10 iterations. The launches of rows 6-10 on (b) and (c)
     are the wrappers' counts by shape (shape_launches), every one at
     h1024d32 bfloat16. ``python3 chip_smoke.py --phase 36`` runs the build
     (the default libraries and phase 36's) and phase 36 alone.
 37. the GaborNet kernels at the wider shapes and depths nerf_tpu's take
     (each shape's libraries started in phase 2 with its plan's -D flags,
     nerf_tpu_torch/ops/cuda/gabor_plan.py): (a) rows 11-14 at hidden 512
     and 1024 (L_d = 4: d_pad 32), 512 with L_d = 6 (d_pad 64) and hidden
     256 with 4 stages, float32 and bfloat16, against their plain versions
     under phases 10 and 20's tolerances (rows 11-12 at lego_siren.txt's
     1024 x 256 and at 1024 x 37, their plain versions over 256 rays a
     call; rows 13-14 at 65,536 lattice points and 37 points), each
     launched twice for identical bits, timed against its bound (gabor_macs
     at the case's widths and depth); hidden 768 and depths 1 and 3 are
     held in tests/test_torch_port_cuda.py only; (b) configs/lego_siren.txt
     with model_type = gabor at hidden_dim = 1024: fit() 40 iterations (the
     mse falls), a resume 20 -> 30 bit for bit, two train-pass steps
     outside fit (the forward render refuses autograd, as nerf_tpu's), one
     --occupancy 64 request (row 13's bake at 1024, then row 11) and one
     eval CLI frame, each within mean abs 1e-2 of the unfused render; (c)
     fit() with distill_from = (b)'s checkpoint: 20 distillation steps of
     16,384 points (rows 13 and 14 at 1024; the loss falls), then 10
     iterations. Every launch of (b) and (c) is counted at h1024d32n8
     bfloat16. Phases 35-37 share one checker (check_wide_family, a
     WideFamily a phase) and phases 36-37 one (b)-(c) (wide_sg).
     ``python3 chip_smoke.py --phase 37`` runs the build and phase 37
     alone.

The last lines are a JSON object of per-kernel numbers (all nineteen
kernels, row 18 in its two forms; rows 1-5, 6-10 and 11-14 with their
numbers at each phase-35, -36 and -37 shape under "widths"), the script's
wall time,
the card, and ``{"ok": true, "device": {...}}``. Needs a CUDA device and
this checkout; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()   # the script's wall time runs from here
LAPS: list = []                  # (phase, wall s) in the order run, for the summary line
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
# Row 5's bfloat16 train pass on the CUDA cores, before it moved to the
# tensor cores (csrc/fused_render_train.cu at 1024 rays x S; PERF.md row 5's
# earlier times, NVIDIA H100 80GB HBM3, 700.00 W), printed beside the
# tensor-core kernel's time.
ROW5_BF16_CUDA_CORE_MS = {64: 10.851, 192: 30.608, 256: 40.164}
# Row 4's bfloat16 render backward on the CUDA cores (the backward entry of
# csrc/fused_render_train.cu at 1024 rays x S; PERF.md row 4's earlier times,
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside the tensor-core kernel.
ROW4_BF16_CUDA_CORE_MS = {64: 10.811, 192: 30.558, 256: 40.304}
# Rows 3 and 11's bfloat16 forward renders on the CUDA cores, before they
# moved to the tensor cores (csrc/fused_render_fwd.cu at 8192 rays x S,
# csrc/fused_render_gabor_fwd.cu at 1024 x 256; PERF.md's earlier times,
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside the tensor-core kernels.
ROW3_BF16_CUDA_CORE_MS = {64: 21.164, 192: 62.040}
ROW11_BF16_CUDA_CORE_MS = 10.264
# Rows 6 and 8's bfloat16 SIREN forward render and train pass on the CUDA
# cores, before they moved to the tensor cores (csrc/fused_render_siren_fwd.cu
# and the train entry of csrc/fused_render_siren_train.cu at 1024 x 256;
# PERF.md's earlier times, NVIDIA H100 80GB HBM3, 700.00 W).
ROW6_BF16_CUDA_CORE_MS = 8.977
ROW8_BF16_CUDA_CORE_MS = 38.388
# Row 7's bfloat16 SIREN render backward on the CUDA cores, before it moved
# to the tensor cores (the backward entry of csrc/fused_render_siren_train.cu
# at 1024 x 256; PERF.md row 7's earlier time, NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside the tensor-core kernel.
ROW7_BF16_CUDA_CORE_MS = 38.406
# Rows 12 and 13's bfloat16 GaborNet train pass and field forward on the CUDA
# cores, before they moved to the tensor cores (csrc/fused_render_gabor_train.cu
# at 1024 x 256, csrc/fused_gabor_fwd.cu at 65,536 / 16,384 points; PERF.md's
# earlier times, NVIDIA H100 80GB HBM3, 700.00 W).
ROW12_BF16_CUDA_CORE_MS = 41.833
ROW13_BF16_CUDA_CORE_MS = {65536: 2.901, 16384: 0.728}
# Rows 1 and 9's bfloat16 NeRF and SIREN field forwards on the CUDA cores,
# before they moved to the tensor cores (csrc/fused_nerf_fwd.cu and
# csrc/fused_siren_fwd.cu at 65,536 / 16,384 points; PERF.md's earlier
# times, NVIDIA H100 80GB HBM3, 700.00 W).
ROW1_BF16_CUDA_CORE_MS = {65536: 2.663, 16384: 0.670}
ROW9_BF16_CUDA_CORE_MS = {65536: 2.104, 16384: 0.526}
# Rows 2 and 14's bfloat16 NeRF and GaborNet field backwards on the CUDA
# cores, before they moved to the tensor cores (csrc/fused_nerf_bwd.cu and
# csrc/fused_gabor_bwd.cu at 65,536 / 16,384 points; PERF.md's earlier
# times, NVIDIA H100 80GB HBM3, 700.00 W).
ROW2_BF16_CUDA_CORE_MS = {65536: 10.905, 16384: 3.061}
ROW14_BF16_CUDA_CORE_MS = {65536: 13.440, 16384: 3.544}
# Row 10's bfloat16 SIREN field backward on the CUDA cores, before it moved
# to the tensor cores (csrc/fused_siren_bwd.cu at 65,536 / 16,384 points;
# PERF.md's earlier times, NVIDIA H100 80GB HBM3, 700.00 W).
ROW10_BF16_CUDA_CORE_MS = {65536: 10.057, 16384: 2.721}
# the bf16 field kernels' CUDA-core times by kernel, printed beside the
# tensor-core kernels' in phases 17 and 20
FIELD_WAS_MS = {"fused_nerf_fwd": ROW1_BF16_CUDA_CORE_MS, "fused_siren_fwd": ROW9_BF16_CUDA_CORE_MS,
                "fused_gabor_fwd": ROW13_BF16_CUDA_CORE_MS,
                "fused_nerf_bwd": ROW2_BF16_CUDA_CORE_MS,
                "fused_siren_bwd": ROW10_BF16_CUDA_CORE_MS,
                "fused_gabor_bwd": ROW14_BF16_CUDA_CORE_MS}
# The field backwards' runs (points a CTA) swept in phases 17 and 20 on the
# tensor-core route, beside the plan's own (FusedField._runs).
RUN_SWEEP = (128, 256, 512, 1024)
# Where the CUDA-core field backwards' stash keeps its per-point columns
# (C_SIGP, then C_RGB: render_common.cuh), from a row's end: N_COLS = 12 for
# the NeRF, 16 for the SIREN and the GaborNet (the tensor-core ones:
# fused_nerf.py / fused_siren.py / fused_gabor.py TC_BWD_COLS_AT).
STASH_COLS = {"fused_nerf_bwd": -12, "fused_siren_bwd": -16, "fused_gabor_bwd": -16}
# the libraries of the bf16 kernels on the tensor cores (phase 2 reads
# their SASS)
TC_LIBS = ("fused_render_train_tc", "fused_render_fwd_tc", "fused_render_gabor_fwd_tc",
           "fused_render_siren_fwd_tc", "fused_render_siren_train_tc", "fused_kilonerf_fwd_tc",
           "fused_render_gabor_train_tc", "fused_gabor_fwd_tc", "fused_nerf_fwd_tc",
           "fused_siren_fwd_tc", "fused_nerf_bwd_tc", "fused_gabor_bwd_tc",
           "fused_siren_bwd_tc", "fused_kilonerf_bwd_tc")
# per-sample MACs of the backward's skipped input-gradient products
# (dz1 w1^T, dz6 w6p^T, dzr0 wr0d^T at the real widths 63/63/27)
SKIPPED_MACS = 256 * 63 + 256 * 63 + 128 * 27


def siren_macs(h: int, real_d: int) -> int:
    """MACs a sample of the SIREN MLP at hidden ``h`` and its real widths
    (``real_d`` direction-encoding columns): 3 x h, 7 h x h, the h-long
    density row, h x h (the remap), (h + real_d) x h/2, h/2 x 3; at
    lego_siren.txt's hidden 256 and real_d 27, 561,920."""
    return 3 * h + 7 * h * h + h + h * h + (h + real_d) * (h // 2) + (h // 2) * 3


def siren_trig(h: int) -> int:
    """Sines a sample of the SIREN forward (8 h + h/2; the backward takes as
    many cosines)."""
    return 8 * h + h // 2


def siren_skipped(h: int, real_d: int) -> int:
    """MACs a sample of the products the render backward skips (dz1 w1^T,
    dzr0 wr0d^T)."""
    return h * 3 + (h // 2) * real_d


def siren_field_cost(h: int, real_d: int) -> dict:
    """SG_FIELD's entry of a SIREN field at hidden ``h``: the forward's MACs
    a point and the transcendentals of the forward and the backward (the
    direction encoding's real_d - 3 sines, and as many cosines)."""
    enc = real_d - 3
    return {"macs": siren_macs(h, real_d),
            "trig": (siren_trig(h) + enc, 2 * siren_trig(h) + 2 * enc)}


R_SIREN, S_SIREN = 1024, 256   # lego_siren.txt: chunk_size, num_samples
# GaborNet at the real widths, per sample: forward MACs (7 x 256x256, the
# 256 density row, 256x256, 283x128, 128x3), transcendentals of the forward
# (a sine and an exponential per filter element, 8 x 256; the backward
# takes a sine and a cosine), and the backward's skipped input product
# (dzr0 wr0d^T). The kernels also read the per-ray coefficients (5 x 8 x
# 256 floats a ray; the train pass writes as many cotangents).
def gabor_macs(h: int, n: int, real_d: int) -> int:
    """MACs a sample of the GaborNet at hidden ``h`` with ``n`` stages and
    ``real_d`` direction-encoding columns: n - 1 h x h, the h-long density
    row, h x h (the remap), (h + real_d) x h/2, h/2 x 3; at lego_siren.txt's
    hidden 256, 8 stages and real_d 27, 561,152."""
    return (n - 1) * h * h + h + h * h + (h + real_d) * (h // 2) + (h // 2) * 3


def gabor_trig(h: int, n: int) -> int:
    """Transcendentals a sample of the GaborNet forward: a sine and an
    exponential per filter element (the backward takes a sine and a
    cosine)."""
    return 2 * n * h


def gabor_coef_bytes(h: int, n: int) -> int:
    """Bytes of a ray's per-stage filter coefficients (A, B, P, Q, R)."""
    return 5 * n * h * 4


def gabor_field_cost(h: int, n: int, real_d: int) -> dict:
    """SG_FIELD's entry of a GaborNet field at hidden ``h`` with ``n``
    stages: the forward's MACs a point (the filters' two 3-long products an
    element too) and the transcendentals of the forward and the backward
    (sine, exponential and cosine an element; the direction encoding's
    real_d - 3 sines, and as many cosines)."""
    enc = real_d - 3
    return {"macs": gabor_macs(h, n, real_d) + n * 2 * 3 * h,
            "trig": (2 * n * h + enc, 3 * n * h + 2 * enc)}


GABOR_MACS = gabor_macs(256, 8, 27)
GABOR_TRIG = gabor_trig(256, 8)
GABOR_SKIPPED = 128 * 27
GABOR_COEF_BYTES = gabor_coef_bytes(256, 8)
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
# / stages, L = 4 for the direction), per point: forward MACs (siren_macs;
# GABOR_MACS plus the filters' two 3-long products per element, 8 x 2 x 3 x
# 256) and transcendentals (SIREN: a sine per layer output and head element,
# siren_trig; GaborNet: a sine and an exponential per filter element; both
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
SG_FIELD = {"siren": siren_field_cost(256, 27), "gabor": gabor_field_cost(256, 8, 27)}


# The voxel grids (PERF.md rows 17-19) at the plenoxels config's size: the
# 128^3 x 28 grid (1 density + 3 x 9 SH channels) over lego_siren.txt's
# grid_domain. Row 17 and its plain version take the same float32 operations
# in the same order (grid_common.cuh rounds each product and sum alone, as
# PyTorch's elementwise ops do): bit for bit, within 1e-6 on values of a
# few units a fortiori. Row 18 adds
# exp, log1p and the sigmoid (libm against PyTorch's, an ulp or two) and
# the plain version's cumprod and sums in another order: 1e-5 on rgb, acc
# and weights (in [0, 1]), 1e-4 on depth (t up to 6). Row 19 is held to
# float64 sums: a run of n rows, summed in pieces of at most K = 256 rows
# and then the pieces in order, errs by at most (K + n / K + 2) ulps of its
# sum of magnitudes; its plain version (each run in order) by (n + 2).
GRID_R, GRID_C = 128, 28
GRID_DOMAIN = (-2.75, -1.25)     # grid_domain of lego_siren.txt's settings
GRID_TOL = 1e-6
# Row 17 before its redesign (a warp a point, the lanes over channels) at
# 1024 x 256 points, by kind and mode, a call timed by events through the
# wrapper (PERF.md row 17's earlier times, NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside the thread-a-point kernel's time so taken.
ROW17_WARP_MS = {("train", "float32"): 0.0837, ("train", "bfloat16"): 0.0802,
                 ("image", "float32"): 0.0693, ("image", "bfloat16"): 0.0752}
GRID_RENDER_TOL = {"rgb": 1e-5, "acc": 1e-5, "weights": 1e-5, "depth": 1e-4}
GRID_BATCH = 20        # launches per timed run of a grid kernel
SCATTER_ULPS = 256     # the scatter kernel's chunk, K
# the plenoxels config: lego_siren.txt with model_type = plenoxels and
# these overrides (models/plenoxels.py:23; the grid keeps its defaults:
# grid_res 128, sh_degree 2, interp_dtype bfloat16)
PLENOXELS_OVERRIDES = {"learning_rate": 0.01}
UPSAMPLE = (64, 128)   # phase 25's coarse-to-fine fit: from 64^3, to 128^3 at 50
BAKE_R = 128           # phases 27-29: the caches' resolution (serve.py --bake 128)
BAKE_ITERS = 200       # phases 28-29: fit() iterations of FastNeRF and PlenOctree


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def lap(phase: str) -> None:
    """Record the wall time since the previous lap (or the start) as
    ``phase``'s, for the summary line before the card's."""
    LAPS.append((phase, time.perf_counter() - T_START - sum(t for _, t in LAPS)))


def say(msg: str) -> None:
    print(msg, flush=True)


def tensor_core_instructions(path: str) -> tuple | None:
    """(HMMA, HGMMA) instruction counts in a built library's SASS, by the
    toolkit's cuobjdump; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout.splitlines()
    return (sum("HMMA" in line for line in sass), sum("HGMMA" in line for line in sass))


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
    """The forward render against its plain version at 8192 rays x 64 and
    192 samples, float32 and bfloat16, TF32 off. The bfloat16 one runs on
    the tensor cores (csrc/fused_render_fwd_tc.cu): two launches must give
    the same bits, its time is printed beside the CUDA-core kernel's it
    replaced, and its rgb, acc and weights are held against those of the
    bfloat16 train pass (the same chain, csrc/fused_render_train_tc.cu) on
    one 1024 x 64 batch."""
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
                again = kern()
                torch.cuda.synchronize()
                if not all(torch.equal(out[k], again[k]) for k in out):
                    fail(f"kernel {cdt} S={s}: two launches differ")
                errs = {}
                for i, k in enumerate(("rgb", "acc", "depth", "weights")):
                    x = out[k]
                    if not torch.isfinite(x).all():
                        fail(f"kernel {cdt} S={s}: non-finite {k}")
                    errs[k] = float((x - ref[i]).abs().max())
                del ref, out, again
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
            tc = fr.fwd_library() == "fused_render_fwd_tc"
            say(f"kernel fused_render_fwd {cdt} R={R_CHECK} S={s}: max_abs_err "
                + " ".join(f"{k}={v:.3e}(tol {TOL[cdt][k]:.0e})"
                           for k, v in errs.items())
                + f" | kernel {ms:.3f} ms"
                + (f" (tensor cores; the CUDA-core kernel it replaced "
                   f"{ROW3_BF16_CUDA_CORE_MS[s]:.3f} ms, x"
                   f"{ROW3_BF16_CUDA_CORE_MS[s] / ms:.2f})" if tc else "")
                + f", two launches bit-identical, plain {plain_ms:.3f} ms, "
                f"bound {bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
            if bad:
                fail(f"kernel {cdt} S={s} disagrees with its plain version: {bad}")
            results[(cdt, s)] = dict(err=max(errs.values()), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    # the bf16 forward render and train pass run one chain: on one batch
    # their rgb, acc and compositing weights agree
    rays_o, rays_d, t, target = camera_batch(torch, dev, R_TRAIN, 64, 3064)
    o_aff, d_aff = fr.affine(rays_o, rays_d)
    with torch.no_grad():
        out = fr(packed, rays_o, rays_d, rays_d, t)
        _, rgb, acc, weights, _ = fr._train(packed, o_aff, d_aff, rays_d, t, target, True)
        torch.cuda.synchronize()
    diff = {"rgb": float((out["rgb"] - rgb).abs().max()),
            "acc": float((out["acc"] - acc).abs().max()),
            "weights": float((out["weights"] - weights).abs().max())}
    say(f"kernel fused_render_fwd bfloat16 R={R_TRAIN} S=64 against the train pass "
        f"({fr.grad_library(True)}): max abs "
        + " ".join(f"{k}={v:.3e}(tol {TOL['bfloat16'][k]:.0e})" for k, v in diff.items()))
    if any(v > TOL["bfloat16"][k] for k, v in diff.items()):
        fail(f"the bf16 forward render and train pass disagree: {diff}")
    return results


# ---------------------------------------------------------------- phase 4

CAMERA_ANGLE_X = 0.6911112070083618  # Blender synthetic FOV


def write_sphere_scene(root: str, hw: int, color: tuple = (0.9, 0.3, 0.2)) -> None:
    """A Blender-format scene (one frame per split) of a shaded sphere of
    ``color``, a small copy of the repository's tests/synthetic.py writer."""
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
        img[hit, :3] = np.array(color)[None] * shade[hit, None]
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
          svc=None, compare: tuple = ("/pose/1",), init=None, reference=None,
          routes: tuple = ("/pose/0", "/pose/1", "/render")):
    """Phase 4 (``config`` lego.txt, the NeRF kernels), 8 (lego_siren.txt,
    the SIREN kernels), 11 (lego_siren.txt with ``model_type`` gabor, the
    GaborNet kernels) or 14 (the kilonerf config: lego_siren.txt with
    ``model_type`` kilonerf and ``overrides`` hidden_dim 32, grid_res 8;
    the KiloNeRF field kernels): a checkpoint of ``config`` from its seed,
    served on cuda over loopback; or phase 18 (``svc`` a service of
    lego.txt already built with an occupancy prior, every request in
    ``compare``); or phase 24 (the plenoxels config, ``init`` applied to
    the seeded model before the save, the unfused render through
    ``reference(model)``); or phase 35 (``svc`` lego.txt at hidden 1024
    with an occupancy prior, the one request of ``routes``, no profile);
    returns the kernel launches of the image requests."""
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
        for route in (r if r != "/render" else f"/render?m={m}" for r in routes):
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
    if launches != len(routes) * per_image:
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
    if len(routes) > 1:
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
    for label, events, top in (("kernel", mine, 3), ("other", others, 10)):
        by_name: dict = {}
        for e in events:
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
        if label == "kernel" and len(by_name) < 2:
            continue
        for name, (c, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:top]:
            say(f"  {label}: {t / 1e3:.2f} ms ({t / wall_us:.4f}) in {c} launches: "
                f"{name[:90]}")
    gathers = [e for e in others if "index" in e.name or "gather" in e.name]
    t_gather = sum(e.time_range.elapsed_us() for e in gathers)
    say(f"  other: indexing kernels (gathers and scatters by an index) {t_gather / 1e3:.2f} ms "
        f"in {len(gathers)} launches")
    adam = [e for e in others if "multi_tensor_apply" in e.name]
    if adam:
        t_adam = sum(e.time_range.elapsed_us() for e in adam)
        say(f"  other: multi_tensor_apply kernels (Adam's _foreach ops) {t_adam / 1e3:.2f} ms "
            f"({t_adam / wall_us:.4f}) in {len(adam)} launches; the rest "
            f"{(t_other - t_adam) / 1e3:.2f} ms in {len(others) - len(adam)} launches")


# ---------------------------------------------------------------- phase 3b


def grad_errors(torch, got, ref, views=None, hidden: int = 256, pads=None) -> dict:
    """Per gradient tensor, max |kernel - plain| over max |plain|, the max
    floored at 1e-2 of the model's largest gradient element (b10s is one
    sum of terms of both signs, whose residue alone is no scale). ``views``
    names the tensors of a flat pair (default: the NeRF layout at
    ``hidden`` with the encodings padded to ``pads``; a family's
    ``grad_views`` at ``hidden`` with its own ``pads``)."""
    from nerf_tpu_torch.ops.cuda.fused_render import DP, PP, grad_views

    if views is None:
        g, r = (grad_views(*x, hidden, pads or (PP, DP)) for x in (got, ref))
    else:
        g, r = (views(*x, hidden, *(pads or ())) for x in (got, ref))
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
    against each other. In bfloat16 both run on the tensor cores
    (csrc/fused_render_train_tc.cu): two launches of each must give the
    same bits, the compositing weights the render backward recomputes must
    equal the bf16 forward render's (row 3) bit for bit, and their times
    are printed beside the CUDA-core kernels' they replaced."""
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
                again = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got[:4] + got[4],
                                                             again[:4] + again[4]))
                del again
                if not same:
                    fail(f"train kernel {cdt} S={s}: two launches differ")
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
                if cdt == "bfloat16":
                    # two launches, the second with the recomputed weights
                    # written out, against the forward render's weights
                    grads_d, _, _, _, w_bwd = fr._launch_grad(
                        packed, o_aff, d_aff, rd, t, g_ray, False, False, True)
                    w_fwd = fr._forward(packed, o_aff, d_aff, rd, t)[3]
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(got_b, grads_d)):
                        fail(f"backward kernel {cdt} S={s}: two launches differ")
                    w_gap = float((w_bwd - w_fwd).abs().max())
                    say(f"kernel bwd {cdt} R={R_TRAIN} S={s}: two launches bit-identical; "
                        f"recomputed weights equal to the forward render's: "
                        f"{torch.equal(w_bwd, w_fwd)} (max abs {w_gap:.3e})")
                    if not torch.equal(w_bwd, w_fwd):
                        fail(f"backward kernel {cdt} S={s}: the recomputed weights are not "
                             f"the forward render's (max abs {w_gap:.3e})")
                    del grads_d, w_bwd, w_fwd
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
                was = (ROW5_BF16_CUDA_CORE_MS if name == "fused_render_train"
                       else ROW4_BF16_CUDA_CORE_MS)
                say(f"kernel {name} {cdt} R={R_TRAIN} S={s}: kernel {ms:.3f} ms"
                    + (f" (tensor cores; the CUDA-core kernel it replaced "
                       f"{was[s]:.3f} ms, x{was[s] / ms:.2f}; two launches "
                       f"bit-identical)" if cdt == "bfloat16" else "")
                    + f", plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), "
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
    kernels. The bfloat16 forward and train pass run on the tensor cores
    (csrc/fused_render_siren_fwd_tc.cu, csrc/fused_render_siren_train_tc.cu):
    two launches of each must give the same bits, their times are printed
    beside the CUDA-core kernels' they replaced, and the forward's rgb, acc
    and weights must equal the train pass's (one chain) on a 1024 x 64
    batch."""
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
                again = kern()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(out, again)):
                    fail(f"siren kernel {cdt} R={r} S={s}: two launches differ")
                errs = {}
                for i, name in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[i]).all():
                        fail(f"siren kernel {cdt} R={r} S={s}: non-finite {name}")
                    errs[name] = float((out[i] - ref[i]).abs().max())
                del ref, out, again
                torch.cuda.empty_cache()
                timed = (r, s) == (R_SIREN, S_SIREN)
                if timed:
                    times = {"plain": [], "kernel": []}
                    plain(); kern()                       # warm-up
                    for name in ("plain", "kernel", "kernel", "plain"):
                        fn = plain if name == "plain" else kern
                        times[name] += time_calls(torch, fn, 3)
                    torch.cuda.empty_cache()
            tc = fr.fwd_library() == "fused_render_siren_fwd_tc"
            bad = {n: v for n, v in errs.items() if v > TOL[cdt][n]}
            line = (f"kernel fused_render_siren_fwd {cdt} R={r} S={s}: max_abs_err "
                    + " ".join(f"{n}={v:.3e}(tol {TOL[cdt][n]:.0e})" for n, v in errs.items())
                    + ", two launches bit-identical")
            if timed:
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                bms, by = bound_ms(r, s, cdt, weight_bytes, siren_macs(256, 27),
                                   siren_trig(256))
                line += (f" | kernel {ms:.3f} ms"
                         + (f" (tensor cores; the CUDA-core kernel it replaced "
                            f"{ROW6_BF16_CUDA_CORE_MS:.3f} ms, x"
                            f"{ROW6_BF16_CUDA_CORE_MS / ms:.2f})" if tc else "")
                         + f", plain {plain_ms:.3f} ms, bound "
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
            again = fr._train(packed, o_aff, d_aff, rd, t, tgt, True)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got[:4] + got[4],
                                                         again[:4] + again[4])):
                fail(f"siren train kernel {cdt}: two launches differ")
            del again
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
            if cdt == "bfloat16":
                again_b = fr._backward(packed, o_aff, d_aff, rd, t, g_ray)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got_b, again_b)):
                    fail(f"siren backward kernel {cdt}: two launches differ")
                del again_b
                check_siren_bwd_weights(torch, dev, fr, packed, o_aff, d_aff, rd, t, g_ray)
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
                               3 * siren_macs(256, 27) - siren_skipped(256, 27),
                               2 * siren_trig(256),
                               grad_bytes, name == "fused_render_siren_train")
            tc = fr.grad_library(name == "fused_render_siren_train").endswith("_tc")
            was = (ROW8_BF16_CUDA_CORE_MS if name == "fused_render_siren_train"
                   else ROW7_BF16_CUDA_CORE_MS)
            say(f"kernel {name} {cdt} R={r} S={s}: kernel {ms:.3f} ms"
                + (f" (tensor cores; the CUDA-core kernel it replaced "
                   f"{was:.3f} ms, x{was / ms:.2f}; two launches bit-identical)"
                   if tc else "")
                + f", plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share of "
                f"bound {bms / ms:.4f}")
            e = gerr if name == "fused_render_siren_train" else berr
            worst = max(list(e.values()) + (list(errs.values()) if name ==
                                            "fused_render_siren_train" else []))
            results[(name, cdt)] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bms, bound_by=by)
        if bad:
            fail(f"siren train/backward kernels {cdt} disagree: {bad}")
    # the bf16 forward render and train pass run one chain: on one batch
    # their rgb, acc and compositing weights are equal bit for bit
    rays_o, rays_d, t, target = camera_batch(torch, dev, R_TRAIN, 64, 4064)
    o_aff, d_aff = fr.affine(rays_o, rays_d)
    with torch.no_grad():
        out = fr._forward(packed, o_aff, d_aff, rays_d, t)
        _, rgb, acc, weights, _ = fr._train(packed, o_aff, d_aff, rays_d, t, target, True)
        torch.cuda.synchronize()
    diff = {"rgb": float((out[0] - rgb).abs().max()), "acc": float((out[1] - acc).abs().max()),
            "weights": float((out[3] - weights).abs().max())}
    say(f"kernel fused_render_siren_fwd bfloat16 R={R_TRAIN} S=64 against the train pass "
        f"({fr.grad_library(True)}): max abs "
        + " ".join(f"{n}={v:.3e}" for n, v in diff.items()) + " (want 0: one chain)")
    if any(diff.values()):
        fail(f"the bf16 SIREN forward render and train pass disagree: {diff}")
    return results


def check_siren_bwd_weights(torch, dev, fr, packed, o_aff, d_aff, rd, t, g_ray) -> None:
    """Row 7 in bfloat16 (the render backward entry of
    csrc/fused_render_siren_train_tc.cu) runs row 6's forward chain: the
    compositing weights it recomputes, written out by a debug launch, must
    equal the bf16 forward render's bit for bit, at the batch given and at
    an odd S (1024 x 37, cotangent drawn from a seed)."""
    r37 = R_TRAIN
    ro37, rd37, t37, _ = camera_batch(torch, dev, r37, 37, 4037)
    oa37, da37 = fr.affine(ro37, rd37)
    g37 = torch.randn(r37, 8, generator=torch.Generator(device=dev).manual_seed(37),
                      device=dev) * 1e-3
    g37[:, 5:] = 0.0
    for (oa, da, d, tt, g) in ((o_aff, d_aff, rd, t, g_ray), (oa37, da37, rd37, t37, g37)):
        _, _, _, _, w_bwd = fr._launch_grad(packed, oa, da, d, tt, g, False, False, True)
        w_fwd = fr._forward(packed, oa, da, d, tt)[3]
        torch.cuda.synchronize()
        gap = float((w_bwd - w_fwd).abs().max())
        same = torch.equal(w_bwd, w_fwd)
        say(f"kernel siren bwd bfloat16 R={tt.shape[0]} S={tt.shape[1]}: recomputed weights "
            f"equal to the forward render's: {same} (max abs {gap:.3e})")
        if not same:
            fail(f"siren backward kernel bfloat16 S={tt.shape[1]}: the recomputed weights "
                 f"are not the forward render's (max abs {gap:.3e})")


# ---------------------------------------------------------------- phase 10


def check_gabor_kernels(torch, dev):
    """The GaborNet forward and train pass at 1024 x 256 (lego_siren.txt's
    chunk, step and samples), 1000 x 256 (ragged) and 1024 x 37 (odd S:
    chunks span rays); the train pass's coefficient cotangents dA..dR (max
    abs over max |d| per coefficient) and the filter gradients after
    autograd through the prep (as grad_errors); float32 and bfloat16, TF32
    off; the tolerances of the NeRF kernels. In bfloat16 both run on the
    tensor cores (csrc/fused_render_gabor_fwd_tc.cu,
    csrc/fused_render_gabor_train_tc.cu): two launches of each must give
    the same bits at each shape, their times at 1024 x 256 are printed
    beside the CUDA-core kernels' they replaced, and the forward's rgb, acc
    and weights must equal the train pass's (one chain) on a 1024 x 64
    batch."""
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_render_plain, gabor_coeffs)

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
                again = kern()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(out, again)):
                    fail(f"gabor kernel {cdt} R={r} S={s}: two launches differ")
                errs = {}
                for i, name in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[i]).all():
                        fail(f"gabor kernel {cdt} R={r} S={s}: non-finite {name}")
                    errs[name] = float((out[i] - ref[i]).abs().max())
                del ref, out, again
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
            tc = fr.fwd_library() == "fused_render_gabor_fwd_tc"
            line = (f"kernel fused_render_gabor_fwd {cdt} R={r} S={s}: max_abs_err "
                    + " ".join(f"{n}={v:.3e}(tol {TOL[cdt][n]:.0e})"
                               for n, v in errs.items())
                    + ", two launches bit-identical")
            if timed:
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                bms, by = bound_ms(r, s, cdt, weight_bytes + r * GABOR_COEF_BYTES,
                                   GABOR_MACS, GABOR_TRIG)
                line += (f" | kernel {ms:.3f} ms"
                         + (f" (tensor cores; the CUDA-core kernel it replaced "
                            f"{ROW11_BF16_CUDA_CORE_MS:.3f} ms, x"
                            f"{ROW11_BF16_CUDA_CORE_MS / ms:.2f})" if tc else "")
                         + f", plain {plain_ms:.3f} ms, bound "
                         f"{bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
                results[("fused_render_gabor_fwd", cdt)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            say(line)
            if bad:
                fail(f"gabor kernel {cdt} R={r} S={s} disagrees with its plain "
                     f"version: {bad}")
            worst = max(worst, max(errs.values()))
        results[("fused_render_gabor_fwd", cdt)]["err"] = worst

        # the train pass at the forward's shapes, then the filter gradients
        # through the prep from each side's dA..dR
        tc = fr.grad_library(True) == "fused_render_gabor_train_tc"
        worst = 0.0
        for r, s in ((R_TRAIN, S_SIREN), (1000, S_SIREN), (R_TRAIN, 37)):
            worst = max(worst, check_gabor_train(torch, dev, model, fr, packed, cdt, r, s,
                                                 tc, results))
        results[("fused_render_gabor_train", cdt)]["err"] = worst
    # the bf16 forward render and train pass run one chain: on one batch
    # their rgb, acc and compositing weights are equal bit for bit
    rays_o, rays_d, t, target = camera_batch(torch, dev, R_TRAIN, 64, 6064)
    with torch.no_grad():
        coeffs = gabor_coeffs(*gpack.filters, *fr.affine(rays_o, rays_d))
        out = fr._forward(packed, coeffs, rays_d, t)
        _, rgb, acc, weights, _, _ = fr._train(packed, coeffs, rays_d, t, target, True)
        torch.cuda.synchronize()
    diff = {"rgb": float((out[0] - rgb).abs().max()), "acc": float((out[1] - acc).abs().max()),
            "weights": float((out[3] - weights).abs().max())}
    say(f"kernel fused_render_gabor_fwd bfloat16 R={R_TRAIN} S=64 against the train pass "
        f"({fr.grad_library(True)}): max abs "
        + " ".join(f"{n}={v:.3e}" for n, v in diff.items()) + " (want 0: one chain)")
    if any(diff.values()):
        fail(f"the bf16 GaborNet forward render and train pass disagree: {diff}")
    return results


def check_gabor_train(torch, dev, model, fr, packed, cdt: str, r: int, s: int, tc: bool,
                      results: dict) -> float:
    """Phase 10's train pass at r x s (``tc``: the bfloat16 one on the tensor
    cores, launched twice for identical bits): loss, rgb, acc, weights, every
    weight gradient, dA..dR and the filter gradients through the prep
    against the plain version; at 1024 x 256 also timed in turns against it
    and the bound into ``results``. Returns the worst error."""
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        fused_gabor_train_plain, gabor_coeffs, grad_views, stack_filters)

    k = fr.consts
    weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                    + packed.vec.numel() * 4)
    grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
    cam, rd, t, tgt = camera_batch(torch, dev, r, s, 6000 + s + r - R_TRAIN)
    o_aff, d_aff = fr.affine(cam, rd)
    filters = stack_filters(model)
    coeffs = gabor_coeffs(*filters, o_aff, d_aff)
    cdet = coeffs.detach()
    with torch.no_grad():
        ref = fused_gabor_train_plain(packed, cdet, rd, t, tgt, True, k)
        got = fr._train(packed, cdet, rd, t, tgt, True)
        if tc:
            again = fr._train(packed, cdet, rd, t, tgt, True)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got[:4] + got[4] + got[5:],
                                                         again[:4] + again[4] + again[5:])):
                fail(f"gabor train kernel {cdt} R={r} S={s}: two launches differ")
            del again
        torch.cuda.synchronize()
    errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
    for i, name in ((1, "rgb"), (2, "acc"), (3, "weights")):
        if not torch.isfinite(got[i]).all():
            fail(f"gabor train kernel {cdt} R={r} S={s}: non-finite {name}")
        errs[name] = float((got[i] - ref[i]).abs().max())
    gerr = grad_errors(torch, got[4], ref[4], grad_views)
    if not torch.isfinite(got[5]).all():
        fail(f"gabor train kernel {cdt} R={r} S={s}: non-finite coefficient cotangents")
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
        + f" (tol {TOL[cdt]['rgb']:.0e})" + (", two launches bit-identical" if tc else ""))
    if bad:
        fail(f"gabor train kernel {cdt} R={r} S={s} disagrees: {bad}")
    if (r, s) == (R_TRAIN, S_SIREN):
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
        ms = statistics.median(times["kernel"])
        plain_ms = statistics.median(times["plain"])
        bms, by = bound_ms(r, s, cdt, weight_bytes + r * GABOR_COEF_BYTES,
                           3 * GABOR_MACS - GABOR_SKIPPED, 2 * GABOR_TRIG,
                           grad_bytes + r * GABOR_COEF_BYTES, True)
        say(f"kernel fused_render_gabor_train {cdt} R={r} S={s}: kernel {ms:.3f} ms"
            + (f" (tensor cores; the CUDA-core kernel it replaced "
               f"{ROW12_BF16_CUDA_CORE_MS:.3f} ms, x{ROW12_BF16_CUDA_CORE_MS / ms:.2f}; "
               f"two launches bit-identical)" if tc else "")
            + f", plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share of bound "
            f"{bms / ms:.4f}")
        results[("fused_render_gabor_train", cdt)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return max(list(gerr.values()) + list(derr.values()) + list(ferr.values())
               + list(errs.values()))


# ---------------------------------------------------------------- phase 13


def kilo_bound_ms(n: int, cdt: str, g3: int, backward: bool) -> tuple:
    """Least time of the KiloNeRF forward (or backward) over ``n`` points:
    the products (2 operations a MAC) over the compute dtype's peak and the
    sines over the float32 CUDA-core rate (their sum in float32, the larger
    in bfloat16), against the bytes that must move (see KILO_MACS): a
    point's position and direction (24 bytes) and its 16-byte output, or
    for the backward its cotangent, the weights, and the backward's float32
    gradients. The sort order and the payload's layout are the design's,
    not the function's, and are not counted."""
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
    point set, float32 and bfloat16 with TF32 off: outputs in point order
    (max abs) and gradients (max abs over max |g| per tensor), the exact
    zeros of empty networks, two forward and two backward launches
    compared bit for bit, and in bfloat16 the (rgb, sigma) the backward
    recomputes (its debug output) equal to the forward's bit for bit; the
    HMMA count of the bfloat16 forward's and backward's libraries (0
    fails); at the camera
    set the forward's device time (``device_ms``) and the backward timed in
    turns with the plain versions (plain, kernel, kernel, plain), against
    their bound, with the times PERF.md §6 records for the earlier kernels
    as "was"."""
    from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
    from nerf_tpu_torch.ops.cuda import build
    from nerf_tpu_torch.ops.cuda.fused_kilonerf import (
        KiloNeRFField, cast_packed, dispatch, kilonerf_bwd_plain, kilonerf_fwd_plain,
        pack_f32, unpack)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = {b.name: str(b.path) for b in build.build()}
    for name in ("fused_kilonerf_fwd", "fused_kilonerf_bwd"):
        mma = tensor_core_instructions(paths[name + "_tc"])
        if mma is None:
            say(f"kernel {name} bfloat16: SASS not read (no cuobjdump): HMMA not measured")
            continue
        say(f"kernel {name} bfloat16: {name}_tc SASS holds {mma[0]} HMMA and {mma[1]} HGMMA "
            "instructions")
        if mma[0] == 0:
            fail(f"{name}_tc, a bf16 KiloNeRF kernel, holds no HMMA instruction")
    was = {("fused_kilonerf_fwd", "bfloat16"): 0.291, ("fused_kilonerf_fwd", "float32"): 0.286,
           ("fused_kilonerf_bwd", "bfloat16"): 1.498, ("fused_kilonerf_bwd", "float32"): 1.404}
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
                same = torch.equal(out, field._forward(wc, disp))
                ref_g = kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4)
                got_g = field._backward(wc, disp, cot)
                same_g = torch.equal(got_g, field._backward(wc, disp, cot))
                rec_same = None
                if cdt == "bfloat16":
                    # the forward the backward recomputes, from its debug output
                    rec = torch.empty(n, 4, device=dev)
                    field._launch_bwd(wc, disp, cot, rec=rec)
                    rec_same = torch.equal(rec, out)
                    del rec
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
                f"networks, gradients exactly 0: {zeros}; two forward launches identical: "
                f"{same}, two backward launches identical: {same_g}"
                + ("" if rec_same is None else
                   f"; the backward's recompute is the forward's bit for bit: {rec_same}"))
            if (err > KILO_TOL[cdt] or gerr[w] > KILO_GRAD_TOL[cdt] or not zeros or not same
                    or not same_g or rec_same is False):
                fail(f"kilonerf kernels {cdt} {label} disagree with their plain versions, "
                     "are not deterministic or recompute another forward")
            worst["fwd"] = max(worst["fwd"], err)
            worst["bwd"] = max(worst["bwd"], gerr[w])
            if label.startswith("camera"):
                with torch.no_grad():
                    fns = {
                        ("fused_kilonerf_fwd", "plain"):
                            lambda: kilonerf_fwd_plain(wc, disp, 32, 10, 4),
                        ("fused_kilonerf_bwd", "plain"):
                            lambda: kilonerf_bwd_plain(wc, disp, cot, 32, 10, 4),
                        ("fused_kilonerf_bwd", "kernel"):
                            lambda: field._backward(wc, disp, cot),
                    }
                    times = {k: [] for k in fns}
                    for f in fns.values():
                        f()                                    # warm-up
                    # time runs of KILO_BATCH launches between two events,
                    # so that the queue stays full and host gaps do not
                    # count; the forward kernel is shorter than the host's
                    # work to issue it, so its time is the device's, from a
                    # CUDA graph (the run plan's three small kernels and
                    # the kernel)
                    for key in (("fused_kilonerf_fwd", "plain"), ("fused_kilonerf_bwd", "plain"),
                                ("fused_kilonerf_bwd", "kernel"), ("fused_kilonerf_bwd", "kernel"),
                                ("fused_kilonerf_fwd", "plain"), ("fused_kilonerf_bwd", "plain")):
                        f = fns[key]
                        times[key] += [t / KILO_BATCH for t in time_calls(
                            torch, lambda f=f: [f() for _ in range(KILO_BATCH)], 3)]
                    torch.cuda.empty_cache()
                    times[("fused_kilonerf_fwd", "kernel")] = [
                        device_ms(torch, lambda: field._forward(wc, disp))]
                for name in ("fused_kilonerf_fwd", "fused_kilonerf_bwd"):
                    ms = statistics.median(times[(name, "kernel")])
                    plain_ms = statistics.median(times[(name, "plain")])
                    bms, by = kilo_bound_ms(n, cdt, 512, name.endswith("bwd"))
                    say(f"kernel {name} {cdt} {label}: kernel {ms:.4f} ms (was "
                        f"{was[(name, cdt)]:.3f}, PERF.md §6), plain {plain_ms:.3f} ms, bound "
                        f"{bms:.4f} ms ({by}), share of bound {bms / ms:.4f}")
                    results[(name, cdt)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                                bound_by=by)
            del ref, out, ref_g, got_g, disp
            torch.cuda.empty_cache()
        results[("fused_kilonerf_fwd", cdt)]["err"] = worst["fwd"]
        results[("fused_kilonerf_bwd", cdt)]["err"] = worst["bwd"]
    return results


# ---------------------------------------------------------------- phase 17


def field_bound_ms(n: int, cdt: str, weight_bytes: int,
                   grad_bytes: int | None = None, family: str = "nerf",
                   macs: int | None = None, cost: dict | None = None) -> tuple:
    """Least time of a field forward (``grad_bytes`` None) or backward over
    ``n`` points (the NeRF field's, its forward's MACs a point ``macs``,
    lego.txt's by default; or ``family`` "siren" / "gabor", at
    lego_siren.txt's widths or at those of ``cost``, SG_FIELD's entry of
    another shape): the products
    (2 operations a MAC) over the compute dtype's peak and the
    transcendentals over the float32 CUDA-core rate (their sum in float32,
    the larger in bfloat16), against the bytes that must move (see
    FIELD_TRIG and SG_FIELD)."""
    fwd = grad_bytes is None
    if family == "nerf":
        macs = (macs or mlp_macs(256, 63, 27)) * (1 if fwd else 3)
        trig = FIELD_TRIG * (1 if fwd else 2)
    else:
        cost = cost or SG_FIELD[family]
        macs = cost["macs"] * (1 if fwd else 3)
        trig = cost["trig"][0 if fwd else 1]
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
    points against their bound. The tensor-core kernels (bfloat16) run
    twice for identical bits; the backward's recompute must be the
    forward's output, and its runs are swept (sweep_runs)."""
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
        # the bf16 forward and backward on the tensor cores (rows 1 and 2)
        libs = {"fused_nerf_fwd": field.fwd_library(), "fused_nerf_bwd": field.bwd_library()}
        tc_fwd, tc_bwd = (libs[k].endswith("_tc") for k in ("fused_nerf_fwd", "fused_nerf_bwd"))
        worst = {"fwd": 0.0, "bwd": 0.0}
        for label, (pts, dirs) in sets.items():
            n = pts.shape[0]
            cot = torch.randn(n, 4, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(n))
            with torch.no_grad():
                ref = nerf_field_plain(packed, pts, dirs, 10, 4)
                out = field._forward(packed, pts, dirs)
                if tc_fwd:
                    again = field._forward(packed, pts, dirs)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(out, again)):
                        fail(f"nerf field forward {cdt} {label}: two launches differ")
                    del again
                ref_g = nerf_field_bwd_plain(packed, pts, dirs, cot, 10, 4)
                got_g = field._backward(packed, pts, dirs, cot)
                torch.cuda.synchronize()
                if tc_bwd:
                    check_bwd_twice(torch, "nerf", field, packed, pts, dirs, cot, got_g, cdt,
                                    label)
                if n == 16384 or tc_bwd:
                    say_recompute_gap(torch, "nerf", field, packed, pts, dirs, out, cdt, label)
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
                + f"; points beyond the tol: {bad_pts} of {n}"
                + ("; forward two launches bit-identical" if tc_fwd else "")
                + ("; backward two launches bit-identical" if tc_bwd else ""))
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
            if tc_bwd:
                sweep_runs(torch, "nerf", field, packed, pts, dirs, cot, f"{cdt} {label}")
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
                was = FIELD_WAS_MS[name][n] if libs[name].endswith("_tc") else None
                say(f"kernel {name} {cdt} {label}: kernel {ms:.3f} ms ({libs[name]})"
                    + (f" (tensor cores; the CUDA-core kernel it replaced {was:.3f} ms, "
                       f"x{was / ms:.2f})" if was else "")
                    + f", plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share of "
                    f"bound {bms / ms:.4f}")
                results[(name, cdt, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                               bound_by=by, library=libs[name])
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


def recomputed_forward(torch, family: str, field, packed, pts, dirs):
    """rgb and sigma of the forward that a field backward (row 2, 10 or 14
    for ``family`` "nerf", "siren" or "gabor", through the library its
    ``bwd_library()`` names) recomputes, read from its stash after one
    launch with a zero cotangent on ``packed``: each CTA's stash holds its
    per-point columns where STASH_COLS (or TC_BWD_COLS_AT) says, C_SIGP = 0
    the sigma_pre and
    C_RGB = 1..3 the rgb (render_common.cuh); sigma = relu(sigma_pre),
    times sigma_mul for the SIREN and the GaborNet, as the forward forms
    it."""
    from nerf_tpu_torch.ops.cuda import fused_gabor, fused_nerf, fused_siren

    n = pts.shape[0]
    stash = {}
    field._backward(packed, pts, dirs, torch.zeros(n, 4, device=pts.device), stash=stash)
    torch.cuda.synchronize()
    run, grid, per_point = stash["run"], stash["grid"], stash["per_point"]
    at = {"fused_nerf_bwd_tc": fused_nerf.TC_BWD_COLS_AT,
          "fused_siren_bwd_tc": fused_siren.TC_BWD_COLS_AT,
          "fused_gabor_bwd_tc": fused_gabor.TC_BWD_COLS_AT,
          **STASH_COLS}[field.bwd_library()] % per_point
    cols = stash["scratch"].view(grid, per_point * run)[:, at * run:(at + 4) * run]
    cols = cols.reshape(grid, 4, run)
    sigma_mul = 1.0 if family == "nerf" else field.consts.sigma_mul
    sigma = torch.clamp_min(cols[:, 0].reshape(-1)[:n], 0.0) * sigma_mul
    rgb = cols[:, 1:4].permute(0, 2, 1).reshape(-1, 3)[:n]
    return rgb, sigma


def say_recompute_gap(torch, family: str, field, packed, pts, dirs, out, cdt: str,
                      label: str) -> None:
    """Print how far the forward that the family's field backward
    recomputes (``recomputed_forward``) lies from the forward kernel's
    output ``out``: in float32 both are one chain, so a zero there shows
    the stash was read right; in bfloat16 rows 2, 10 and 14 run their
    forward's own tensor-core chain, so anything but a zero fails."""
    rows = {"nerf": (2, 1), "siren": (10, 9), "gabor": (14, 13)}[family]
    rec = recomputed_forward(torch, family, field, packed, pts, dirs)
    gap = (float((rec[0] - out[0]).abs().max()), float((rec[1] - out[1]).abs().max()))
    say(f"kernel {family} field {cdt} {label}: row {rows[0]}'s recomputed forward "
        f"({field.bwd_library()}) against row {rows[1]}'s: max abs rgb {gap[0]:.3e}, "
        f"sigma {gap[1]:.3e} (max sigma {float(out[1].abs().max()):.3g})")
    if field.bwd_library().endswith("_tc") and max(gap) != 0.0:
        fail(f"{family} field {cdt} {label}: row {rows[0]}'s recompute is not row "
             f"{rows[1]}'s forward")


def check_bwd_twice(torch, family: str, field, packed, pts, dirs, cot, got, cdt: str,
                    label: str) -> None:
    """A tensor-core field backward launched again on the same inputs gives
    the same bits (no float atomics)."""
    again = field._backward(packed, pts, dirs, cot)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{family} field backward {cdt} {label}: two launches differ")


def sweep_runs(torch, family: str, field, packed, pts, dirs, cot, label: str) -> None:
    """Time a tensor-core field backward at each run of RUN_SWEEP and the
    plan's own: per run the grid, the gradient partials' bytes (written
    once and read back once by the in-order sum) and the card ms (the
    median of two timed runs of FIELD_BATCH launches); then a profile of
    FIELD_BATCH launches at the plan's run, by kernel."""
    n, dev = pts.shape[0], pts.device
    sizes = field._bwd_entry()[2]
    vals = [ctypes.c_int() for _ in sizes.argtypes]
    sizes(*(ctypes.byref(v) for v in vals))
    npart = vals[1].value
    plan_run = field._bwd_plan(n, dev, None)[0]
    for run in sorted({*RUN_SWEEP, plan_run}):
        if run > n:
            continue
        with torch.no_grad():
            field._backward(packed, pts, dirs, cot, run=run)       # warm-up
            ms = statistics.median(t / FIELD_BATCH for t in time_calls(
                torch, lambda: [field._backward(packed, pts, dirs, cot, run=run)
                                for _ in range(FIELD_BATCH)], 2))
        grid = -(-n // run)
        say(f"kernel {field.bwd_library()} {label} run sweep: run {run}"
            f"{' (the plan)' if run == plan_run else ''}, grid {grid}, partials "
            f"{grid * npart * 4 / 1e6:.1f} MB, {ms:.3f} ms")
    with torch.no_grad():
        profile_device(torch, lambda: [field._backward(packed, pts, dirs, cot)
                                       for _ in range(FIELD_BATCH)],
                       ("bwd_tc_fwd", "bwd_tc_bwd", "reduce_partials"),
                       f"{FIELD_BATCH} launches of {field.bwd_library()} {label} (its three "
                       "kernels: the forward that stashes, the backward, the in-order sum)")
    torch.cuda.empty_cache()


def check_siren_gabor_field_kernels(torch, dev):
    """The SIREN and GaborNet field kernels (forward and backward) against
    their plain versions on every phase-17 point set, float32 and bfloat16
    with TF32 off: rgb, sigma, the weight gradients, the GaborNet's filter
    banks after autograd through the packing, and the point and direction
    cotangents of a random cotangent; each timed in turns (plain, kernel,
    kernel, plain) at 65,536 and 16,384 points against its bound. The
    tensor-core kernels (every bfloat16 one) run twice for identical bits;
    the backwards' recompute must be the forward's output, and their runs
    are swept (sweep_runs)."""
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
            # the bf16 forwards and backwards on the tensor cores (rows 9,
            # 10, 13 and 14)
            libs = {f"{kname}_fwd": field.fwd_library(), f"{kname}_bwd": field.bwd_library()}
            tc_fwd = libs[f"{kname}_fwd"].endswith("_tc")
            tc_bwd = libs[f"{kname}_bwd"].endswith("_tc")
            worst = {"fwd": 0.0, "bwd": 0.0}
            for label, (pts, dirs) in sets.items():
                n = pts.shape[0]
                cot = torch.randn(n, 4, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(n))
                with torch.no_grad():
                    ref = plain_fwd(pk, pts, dirs)
                    out = field._forward(pk, pts, dirs)
                    if tc_fwd:
                        again = field._forward(pk, pts, dirs)
                        torch.cuda.synchronize()
                        if not all(torch.equal(x, y) for x, y in zip(out, again)):
                            fail(f"{family} field forward {cdt} {label}: two launches "
                                 "differ")
                        del again
                    ref_g = plain_bwd(pk, pts, dirs, cot)
                    got_g = field._backward(pk, pts, dirs, cot)
                    torch.cuda.synchronize()
                    if tc_bwd:
                        check_bwd_twice(torch, family, field, pk, pts, dirs, cot, got_g, cdt,
                                        label)
                    if n == 16384 or tc_bwd:
                        # the forward the backward's gradient is taken at
                        say_recompute_gap(torch, family, field, pk, pts, dirs, out, cdt,
                                          label)
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
                    + f"; points beyond the tol: {bad_pts} of {n}"
                    + ("; forward two launches bit-identical" if tc_fwd else "")
                    + ("; backward two launches bit-identical" if tc_bwd else ""))
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
                if tc_bwd:
                    sweep_runs(torch, family, field, pk, pts, dirs, cot, f"{cdt} {label}")
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
                    was = FIELD_WAS_MS[name][n] if libs[name].endswith("_tc") else None
                    say(f"kernel {name} {cdt} {label}: kernel {ms:.3f} ms ({libs[name]})"
                        + (f" (tensor cores; the CUDA-core kernel it replaced {was:.3f} "
                           f"ms, x{was / ms:.2f})" if was else "")
                        + f", plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share "
                        f"of bound {bms / ms:.4f}")
                    results[(name, cdt, n)] = dict(ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bms, bound_by=by,
                                                   library=libs[name])
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
                 tag: str | None = None, until: int = 120, at: int = 100) -> None:
    """A resume from the step-``at`` checkpoint of ``fit``'s run: the
    restore is exact, and every resumed step to ``until`` that the first run
    logged repeats the first run's mse (``loss``) at the same state.step
    (the loop restarts at the saved iteration while state.step is one
    ahead). The resumed run saves and logs under ``tag`` (default
    ``name``)."""
    import dataclasses

    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state

    ckpt = os.path.join(cfg.save_path, f"{name}_model_{at:06d}")
    saved = load_checkpoint(ckpt)
    probe = create_train_state(cfg, device=dev)
    restore_train_state(probe, ckpt)
    same = probe.step == saved["train_step"] == at + 1
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
    cfg2 = dataclasses.replace(cfg, num_iters=until, log_interval=1,
                               save_path=os.path.join(tmp, f"resume_models_{tag or name}"),
                               log_dir=os.path.join(tmp, f"resume_logs_{tag or name}"))
    lines2: list = []
    resumed = fit(cfg2, resume_path=ckpt, device=dev, log=lines2.append)
    loss2 = read_scalars(cfg2.log_dir)["loss"]
    pairs = [(i, i + 1) for i in sorted(loss2) if i + 1 in loss]
    if resumed.step != until + 1 or len(pairs) != sum(at < j <= until for j in loss):
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


def bake_wall_ms(torch, field, domain, dev) -> float:
    """Wall ms of a 64^3 occupancy bake through ``field`` (a packed field
    wrapper: four forward launches of 65,536 points), each bake ended by a
    synchronize: the median of three after one warm-up bake."""
    from nerf_tpu_torch.ops.occupancy import bake_occupancy, sigma_field

    times = []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bake_occupancy(sigma_field(field), grid_res=64, domain=domain, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def distill_step_ms(torch, cfg, dev, steps: int = 20) -> float:
    """Wall ms of one distillation step of ``cfg`` (its teacher checkpoint,
    a fresh seeded student, both through the field kernels, the batch of
    ``cfg.distill_batch`` points and the student's Adam step): ``steps``
    chained steps after one warm-up step, ended by a synchronize."""
    from nerf_tpu_torch.models.registry import grid_domain
    from nerf_tpu_torch.train.distill import load_teacher, make_distill_step
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.train.step import fused_field_for

    state = create_train_state(cfg, device=dev)
    teacher = load_teacher(cfg, cfg.distill_from, dev)
    student = fused_field_for(state.params)
    args = (student, teacher, cfg.distill_batch, cfg.seed, grid_domain(cfg))
    make_distill_step(*args, 1)(state)
    run = make_distill_step(*args, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


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
    bake_ms = bake_wall_ms(torch, field, domain, dev)
    say(f"serve occupancy: the 64^3 bake launched the NeRF field forward {bake_launches} "
        f"times ({field.fwd_library()}; service set-up {setup:.2f} s; a bake {bake_ms:.3f} "
        f"ms wall, median of 3); occupied share {share:.4f} (before "
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
    step_ms = distill_step_ms(torch, cfg, dev)
    say(f"train: a lego.txt distillation step (16384 points: teacher and student "
        f"forward, student backward, Adam) {step_ms:.3f} ms wall (20 chained steps)")
    check_resume(torch, dev, tmp, cfg, "nerf", loss, tag="distill_occ")
    state = create_train_state(cfg, device=dev)
    scene = load_scene(cfg, device=dev)
    occ_grid = bake_occupancy(sigma_field(state.params), grid_res=64,
                              domain=grid_domain(cfg), device=dev)
    profile_step(torch, state, scene.pool, render_settings_from_config(cfg), cfg,
                 "fused_render_train_tc", "lego.txt occupancy-guided", occ_grid)
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
    bake_ms = bake_wall_ms(torch, field, grid_domain(cfg), dev)
    say(f"serve occupancy {family}: the 64^3 bake launched the {family} field forward "
        f"{bake_launches} times ({field.fwd_library()}; service set-up {setup:.2f} s; a "
        f"bake {bake_ms:.3f} ms wall, median of 3); occupied share "
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
    step_ms = distill_step_ms(torch, cfg, dev)
    say(f"train: a {student} distillation step from the {t_field.family} teacher "
        f"(16384 points: teacher and student forward, student backward, Adam) "
        f"{step_ms:.3f} ms wall (20 chained steps)")
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


def device_ms(torch, fn, reps: int = GRID_BATCH) -> float:
    """Median device time (ms) of one call of ``fn``: ``reps`` calls
    captured into a CUDA graph, the graph replayed between two events, 3
    times. The device's time for the call's kernels, where a call's host
    work outlasts them and events around back-to-back calls would time the
    host instead. (torch.profiler's CUDA traces on the card lost every
    launch of some windows, and are not used for this.)"""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(time_calls(torch, graph.replay, 3)) / reps


def check_grid_interp_kernel(torch, dev) -> dict:
    """Row 17 (csrc/fused_grid.cu) against its plain version, bit for bit:
    1024 x 64 and 1024 x 256 points of random training rays and of
    tile-ordered camera rays, float32 and bfloat16, on a 128^3 x 28 grid;
    timed in turns (plain, kernel, library, library, kernel, plain) by
    events through the wrapper, with F.grid_sample on the grid laid out as
    (1, C, R, R, R) (made once, outside the timing) as the library call,
    and the kernel and the library call on the device (``device_ms``, in
    turns); against the bytes bound, and at 1024 x 256 beside the
    warp-a-point kernel's times it replaced."""
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
                    same = torch.equal(out, ref)
                    lib_err = float((libv - interp_cells_plain(grid, cells_of(flat, GRID_R)))
                                    .abs().max())
                    ms = timed(torch, {"plain": plain, "kernel": kern, "library": lib},
                               ("plain", "kernel", "library", "library", "kernel", "plain"))
                    dms = {"kernel": [], "library": []}
                    for name in ("kernel", "library", "library", "kernel"):
                        dms[name].append(device_ms(torch, kern if name == "kernel" else lib))
                    kms, lms = statistics.median(dms["kernel"]), statistics.median(dms["library"])
                    rows = distinct_rows(torch, cells_of(flat, GRID_R), GRID_R)
                n = flat.shape[0]
                nbytes = n * 12 + n * GRID_C * 4 + rows * GRID_C * src.element_size()
                bms = nbytes / PEAK_BYTES * 1e3
                was = ROW17_WARP_MS.get((kind, cdt)) if s == 256 else None
                say(f"kernel grid_interp {cdt} {kind} 1024x{s}: max_abs_err {err:.3e} "
                    f"(tol {GRID_TOL:.0e}), bit-identical to the plain version: {same} | "
                    f"kernel {kms:.4f} ms on the device (a CUDA graph), {ms['kernel']:.4f} ms "
                    f"a call timed by events through the wrapper"
                    + (f" (the warp-a-point kernel it replaced: {was:.4f} ms so timed, "
                       f"PERF.md §6)" if was else "")
                    + f"; plain {ms['plain']:.4f} ms, library (F.grid_sample, float32) "
                    f"{lms:.4f} ms on the device, {ms['library']:.4f} ms by events (vs float32 "
                    f"plain {lib_err:.1e}); bound {bms:.4f} ms (bytes; {rows} distinct rows), "
                    f"share of bound {bms / kms:.4f}")
                if not same or err > GRID_TOL:
                    fail(f"grid_interp {cdt} {kind} S={s} is not its plain version bit for "
                         f"bit (max abs {err:.3e})")
                results[(cdt, kind, s)] = dict(err=err, ms=kms, plain_ms=ms["plain"],
                                               library_ms=lms, bound_ms=bms, bound_by="bytes")
                del ref, out, libv
                torch.cuda.empty_cache()
        del model, grid, src, lib_grid
        torch.cuda.empty_cache()
    return results


def check_scatter_kernel(torch, dev) -> dict:
    """Row 19 (csrc/scatter_add.cu) at the training step's 8 x 262,144 rows
    x 28 into 128^3: the corner ids of 1024 x 256 training-ray points, uniform
    ids, and uniform ids with one id repeated 65,536 times; and at Instant
    NGP's step, 16 levels x 8 corners of 1024 x 64 training-ray points
    (8,388,608 rows of 2) into 16 x 2^19 rows; values N(0, 1).
    Each row within (K + pieces) ulps of its float64 sum's magnitude
    (``SCATTER_ULPS``), the plain version within (n + 2) ulps; two runs
    identical bit for bit; timed in turns against the plain version and
    index_add_ on unsorted and sorted ids (the library calls; each with its
    torch.zeros, while the kernel's call writes every row itself)."""
    from nerf_tpu_torch.models.ngp import NGPModel
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
    # Instant NGP's table gradient (ngp_synthetic.txt): the 8 corner rows of
    # 16 levels of 1024 x 64 training-ray points into 16 x 2^19 rows of 2
    ngp = NGPModel(log2_table=19).to(dev)
    npts = grid_points(torch, dev, "train", 1024, 64, seed=32).reshape(-1, 3)
    nrows = torch.stack([r for r, _ in ngp._cells(npts)])
    ngp_ids = (nrows + torch.arange(16, device=dev)[:, None, None] * (1 << 19)).reshape(-1)
    vals = torch.randn(m, GRID_C, generator=g, device=dev)
    cases = [(label, ids, vals, rows) for label, ids in (
        ("step", step_ids), ("uniform", uniform), ("one id x 65536", repeated))]
    cases.append(("ngp", ngp_ids, torch.randn(ngp_ids.shape[0], 2, generator=g, device=dev),
                  16 << 19))
    del ngp, npts, nrows, vals
    results = {}
    for label, ids, vals, rows in cases:
        m, chans = vals.shape
        with torch.no_grad():
            a = scatter_add_rows(ids, vals, rows)
            b = scatter_add_rows(ids, vals, rows)
            plain = scatter_add_plain(ids, vals, rows)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            exact = torch.zeros(rows, chans, dtype=torch.float64, device=dev).index_add_(
                0, ids, vals.double())
            mags = torch.zeros(rows, chans, dtype=torch.float64, device=dev).index_add_(
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
                "index_add_": lambda: torch.zeros(rows, chans, device=dev).index_add_(
                    0, ids, vals),
                "index_add_ sorted": lambda: torch.zeros(rows, chans, device=dev).index_add_(
                    0, sorted_ids, sorted_vals)},
                ("plain", "kernel", "index_add_", "index_add_ sorted",
                 "index_add_ sorted", "index_add_", "kernel", "plain"), batch=5)
        nbytes = m * 4 + m * chans * 4 + rows * chans * 4
        bms = nbytes / PEAK_BYTES * 1e3
        say(f"kernel scatter_add {label} {m}x{chans} -> {rows} rows ({touched} touched, "
            f"longest run {longest}): error over its bound {k_ratio:.3f} (tol 1), plain "
            f"{p_ratio:.3f}; kernel vs plain max_abs_err {err:.3e}; two runs identical: "
            f"{same}; untouched rows zero: {zeros} | kernel (the whole call: sort, "
            f"row pointer, sums, every row written) {ms['kernel']:.4f} ms, plain "
            f"{ms['plain']:.4f} ms, library index_add_ "
            f"{ms['index_add_']:.4f} ms (sorted ids {ms['index_add_ sorted']:.4f} ms), "
            f"faster than index_add_: {ms['kernel'] < ms['index_add_']} "
            f"(x{ms['index_add_'] / ms['kernel']:.2f}), "
            f"bound {bms:.4f} ms (bytes), share of bound {bms / ms['kernel']:.4f}")
        if not (same and zeros and k_ratio <= 1.0 and p_ratio <= 1.0):
            fail(f"scatter_add {label}: not exact within its bound or not deterministic")
        results[label] = dict(err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                              library_ms=ms["index_add_"], bound_ms=bms, bound_by="bytes")
        del a, plain, sorted_vals
        torch.cuda.empty_cache()
    return results


def check_grid_render_kernel(torch, dev) -> dict:
    """Row 18 (csrc/fused_grid_render.cu) against its plain composition
    (the affine, sh_basis, _expand_basis and grid_render_plain, as the CPU
    route runs them) at 1024 x 256, 1000 x 256, 1024 x 37, 1024 x 1 and 64
    x 1000 tile-ordered camera rays, float32 and bfloat16, on a 128^3 x 28
    grid; two launches compared bit for bit; timed in turns against the
    bytes bound, with the earlier kernel's time at 1024 x 256 as "was"
    (PERF.md §6). No single PyTorch call computes this function (no library
    time)."""
    from nerf_tpu_torch.models.plenoxels import sh_basis
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedGridRender, _expand_basis, cells_affine, grid_render_plain)

    was = {"float32": 0.2789, "bfloat16": 0.2989}
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = grid_model(torch, dev, cdt)
        fr = FusedGridRender(model, 2.0, 6.0)
        with torch.no_grad():
            pack = fr.pack(model)
        src = model.grid.detach() if pack.packed is None else pack.packed
        scale, off = fr.affine(GRID_R)
        for n, s in ((1024, 256), (1000, 256), (1024, 37), (1024, 1), (64, 1000)):
            o, d, t = image_rays(torch, dev, n, s, seed=n + s)
            o_aff, d_aff = cells_affine(o, d, scale, off)

            def plain():
                bexp = _expand_basis(sh_basis(d, 2)).contiguous()
                return grid_render_plain(src, o_aff, d_aff, t, bexp, fr.sel)

            def kern():
                return fr._launch(src, o, d, d, t, scale, off)

            def wrapper():
                return fr(pack, o, d, d, t)

            with torch.no_grad():
                ref, out, again = plain(), wrapper(), kern()
                torch.cuda.synchronize()
                errs = {}
                for i, k in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[k]).all():
                        fail(f"grid_render {cdt} {n}x{s}: non-finite {k}")
                    errs[k] = float((out[k] - ref[i]).abs().max())
                same = all(torch.equal(out[k], again[i])
                           for i, k in enumerate(("rgb", "acc", "depth", "weights")))
                ms = timed(torch, {"plain": plain, "wrapper": wrapper},
                           ("plain", "wrapper", "wrapper", "plain"))
                kms = device_ms(torch, kern)
                cells = (o_aff[:, None, :] + d_aff[:, None, :] * t[..., None]).clamp(0, GRID_R - 1)
                rows = distinct_rows(torch, cells, GRID_R)
            nbytes = n * (36 + 20) + 2 * n * s * 4 + rows * GRID_C * src.element_size()
            bms = nbytes / PEAK_BYTES * 1e3
            bad = {k: v for k, v in errs.items() if v > GRID_RENDER_TOL[k]}
            was_s = f" (was {was[cdt]:.4f}, PERF.md §6)" if (n, s) == (1024, 256) else ""
            say(f"kernel grid_render {cdt} {n}x{s}: max_abs_err "
                + " ".join(f"{k}={v:.3e}(tol {GRID_RENDER_TOL[k]:.0e})" for k, v in errs.items())
                + f"; two launches identical: {same} | kernel {kms:.4f} ms on the device "
                f"(a CUDA graph){was_s}; a call timed by events through the wrapper "
                f"{ms['wrapper']:.4f} ms (host-bound where above the kernel); plain "
                f"{ms['plain']:.4f} ms, bound {bms:.4f} ms (bytes; {rows} distinct rows), "
                f"share of bound {bms / kms:.4f}")
            if bad or not same:
                fail(f"grid_render {cdt} {n}x{s} disagrees with its plain version {bad} or "
                     f"is not deterministic (identical: {same})")
            results[(cdt, n, s)] = dict(err=max(errs.values()), ms=kms,
                                        plain_ms=ms["plain"], library_ms=None, bound_ms=bms,
                                        bound_by="bytes")
            del ref, out, again
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
                 ("grid_interp_kernel", "scatter_add_"),
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


# ---------------------------------------------------------------- phase 27


def fastnerf_cache(torch, dev, seed: int = 27):
    """The phase-27 cache: a seeded full-width FastNeRF (hidden 256, D = 8,
    L = 10/4, float32) over lego.txt's grid_domain baked at BAKE_R^3 /
    dir_res 64 (TF32 off), and the bake's wall time in ms."""
    from nerf_tpu_torch.models.fastnerf import FastNeRFModel

    model = FastNeRFModel(domain=FIELD_DOMAIN,
                          generator=torch.Generator().manual_seed(seed)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = model.bake(grid_res=BAKE_R, dir_res=64)
    torch.cuda.synchronize()
    return cache, (time.perf_counter() - t0) * 1e3


def check_factor_render_kernel(torch, dev) -> dict:
    """Row 18's factor form (csrc/fused_grid_render.cu, FusedFactorRender)
    against its plain composition (BakedFastNeRF.beta, _expand_basis with
    repeat_block=False, grid_render_plain with relu density) on phase 27's
    cache at the phase-23 shapes (tile-ordered camera rays), float32
    (pos_grid) and bfloat16 (its copy packed_pos); two launches compared bit
    for bit; the kernel's device time from a CUDA graph of 20 calls between
    events, the wrapper (beta included) and the plain version timed in
    turns, against the bytes bound. No single PyTorch call computes this
    function (no library time)."""
    from nerf_tpu_torch.models.fastnerf import BakedFastNeRF
    from nerf_tpu_torch.ops.cuda.fused_grid_render import (
        FusedFactorRender, _expand_basis, cells_affine, grid_render_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cache, bake_ms = fastnerf_cache(torch, dev)
    d_dim, c = cache.num_factors, cache.pos_grid.shape[-1]
    say(f"kernel grid_render factors: cache of a seeded FastNeRF (hidden 256, D = {d_dim}, "
        f"L = 10/4) baked at {BAKE_R}^3 x {c} / dir_res 64 in {bake_ms:.1f} ms wall "
        f"({cache.pos_grid.numel() * 4 / 1e6:.1f} MB float32, "
        f"{cache.packed_pos.numel() * 2 / 1e6:.1f} MB bfloat16)")
    results = {}
    for cdt in ("float32", "bfloat16"):
        baked = cache if cdt == "bfloat16" else BakedFastNeRF(
            cache.pos_grid, cache.beta_grid, d_dim, domain=cache.domain)
        fr = FusedFactorRender(baked, 2.0, 6.0)
        _, src = fr.grids(baked)
        scale, off = fr.affine(BAKE_R)
        for n, s in ((1024, 256), (1000, 256), (1024, 37), (1024, 1), (64, 1000)):
            o, d, t = image_rays(torch, dev, n, s, seed=n + s + 27)
            o_aff, d_aff = cells_affine(o, d, scale, off)
            with torch.no_grad():
                beta = baked.beta(d).contiguous()

            def plain():
                bexp = _expand_basis(baked.beta(d), repeat_block=False).contiguous()
                return grid_render_plain(src, o_aff, d_aff, t, bexp, fr.sel, relu_sigma=True)

            def kern():
                return fr._launch(src, o, d, beta, t, scale, off)

            def wrapper():
                return fr(baked, o, d, d, t)

            with torch.no_grad():
                ref, out, again = plain(), wrapper(), kern()
                torch.cuda.synchronize()
                errs = {}
                for i, k in enumerate(("rgb", "acc", "depth", "weights")):
                    if not torch.isfinite(out[k]).all():
                        fail(f"grid_render factors {cdt} {n}x{s}: non-finite {k}")
                    errs[k] = float((out[k] - ref[i]).abs().max())
                same = all(torch.equal(out[k], again[i])
                           for i, k in enumerate(("rgb", "acc", "depth", "weights")))
                ms = timed(torch, {"plain": plain, "wrapper": wrapper},
                           ("plain", "wrapper", "wrapper", "plain"))
                kms = device_ms(torch, kern)
                cells = (o_aff[:, None, :] + d_aff[:, None, :] * t[..., None]).clamp(0, BAKE_R - 1)
                rows = distinct_rows(torch, cells, BAKE_R)
            nbytes = n * (24 + 4 * d_dim + 20) + 2 * n * s * 4 + rows * c * src.element_size()
            bms = nbytes / PEAK_BYTES * 1e3
            bad = {k: v for k, v in errs.items() if v > GRID_RENDER_TOL[k]}
            say(f"kernel grid_render factors {cdt} {n}x{s}: max_abs_err "
                + " ".join(f"{k}={v:.3e}(tol {GRID_RENDER_TOL[k]:.0e})" for k, v in errs.items())
                + f"; two launches identical: {same} | kernel {kms:.4f} ms on the device "
                f"(a CUDA graph); a call through the wrapper (beta included) "
                f"{ms['wrapper']:.4f} ms; plain {ms['plain']:.4f} ms, bound {bms:.4f} ms "
                f"(bytes; {rows} distinct rows), share of bound {bms / kms:.4f}")
            if bad or not same:
                fail(f"grid_render factors {cdt} {n}x{s} disagrees with its plain version "
                     f"{bad} or is not deterministic (identical: {same})")
            results[(cdt, n, s)] = dict(err=max(errs.values()), ms=kms, wrapper_ms=ms["wrapper"],
                                        plain_ms=ms["plain"], library_ms=None, bound_ms=bms,
                                        bound_by="bytes")
            del ref, out, again
            torch.cuda.empty_cache()
        del baked, fr, src
        torch.cuda.empty_cache()
    del cache
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phases 28-29


def matmul_kernels(torch, fn) -> list | None:
    """Names of the device kernels of ``fn()`` that are matrix products
    (gemm, cutlass, xmma), from a torch.profiler trace; None where the trace
    holds no device event (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return None
    return sorted({e.name for e in dev_events
                   if any(k in e.name.lower() for k in ("gemm", "cutlass", "xmma"))})


def bake_and_serve(torch, dev, tmp: str, family: str) -> dict:
    """Phase 28 (``family`` fastnerf) or 29 (plenoctree): fit() on
    configs/lego.txt with that model_type for BAKE_ITERS iterations (logs
    every 10, validation and saves every 100; finite losses, the mse at the
    last logged iteration under that at 0), a bit-identical resume from
    step 100, a profile of one step; then the final checkpoint served by
    RenderService with bake = BAKE_R behind the HTTP server (serve's
    requests): 2 x ceil(160000/8192) = 40 launches of row 18's factor form
    (fastnerf) or SH form (plenoctree) a request, no matrix product on the
    card in a request, one image within mean abs 1e-2 of the unfused
    render of the same cache (the module, float32 interpolation)."""
    import copy
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedFactorRender, FusedGridRender
    from nerf_tpu_torch.serve import RenderService
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config

    fused_cls = FusedFactorRender if family == "fastnerf" else FusedGridRender
    base = parse_config_file(os.path.join(ROOT, "configs", "lego.txt"))
    cfg = dataclasses.replace(
        base, model_type=family, dataset_path=os.path.join(tmp, "scene"), num_iters=BAKE_ITERS,
        log_interval=10, val_interval=100, save_interval=100,
        save_path=os.path.join(tmp, f"train_models_{family}"),
        log_dir=os.path.join(tmp, f"train_logs_{family}"))
    label = f"lego.txt (model_type = {family})"
    lines: list = []
    fused_cls.launches = 0
    t0 = time.perf_counter()
    state = fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    say(f"train: fit {label} {BAKE_ITERS} iterations in {time.perf_counter() - t0:.1f} s "
        f"through the module (no kernel: row 18 launches {fused_cls.launches})")
    for line in lines:
        if "[Iter" in line or "Validation" in line:
            say(f"  {line}")
    last = BAKE_ITERS - 10
    scal = read_scalars(cfg.log_dir)
    loss, rps = scal["loss"], scal["rays_per_sec"][last]
    if sorted(loss) != list(range(0, BAKE_ITERS, 10)) or not all(
            math.isfinite(v) for v in loss.values()):
        fail(f"{label} logged mse {loss}")
    if not loss[last] < loss[0]:
        fail(f"{label}: mse at {last} ({loss[last]}) is not under that at 0 ({loss[0]})")
    say(f"train: mse {loss[0]:.6f} at 0 -> {loss[last]:.6f} at {last} (ratio "
        f"{loss[last] / loss[0]:.4f}); {label} step {rps:.0f} rays/s "
        f"({cfg.num_random_rays} rays, {cfg.num_samples}+{cfg.num_fine_samples} samples, "
        f"{cfg.compute_dtype})")
    check_resume(torch, dev, tmp, cfg, family, loss)
    scene = load_scene(cfg, device=dev)
    profile_step(torch, state, scene.pool, render_settings_from_config(cfg), cfg, "gemm",
                 label)
    del state, scene
    torch.cuda.empty_cache()

    ckpt = os.path.join(cfg.save_path, f"{family}_model_{BAKE_ITERS:06d}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = RenderService.from_checkpoint(cfg, ckpt, bake=BAKE_R, device=dev, log=say)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    cache = svc.params[0] if family == "fastnerf" else svc.params[0].model
    if svc.params[1] is not None or any(isinstance(m, torch.nn.Linear)
                                        for m in cache.modules()):
        fail(f"{label} --bake {BAKE_R}: the served params hold a network")
    say(f"serve: {label} --bake {BAKE_R}: service built in {bake_s:.2f} s wall "
        f"(checkpoint load and the {BAKE_R}^3 bake)")
    if family == "plenoctree":
        # cells whose raw density nerf_tpu's float32 expm1 turns to inf (the
        # port stores softplus^-1(sigma) = sigma there, models/plenoctree.py)
        big = int((cache.grid[..., 0] > 88.7).sum())
        say(f"serve: {label} --bake {BAKE_R}: {big} of {cache.grid[..., 0].numel()} cells of "
            f"density above 88.7 (raw stored as sigma, not nerf_tpu's inf)")

    def reference(params):
        # the unfused render of the same cache: the module, float32
        # interpolation (row 17's float32 mode), no fused grid render
        if family == "fastnerf":
            from nerf_tpu_torch.models.fastnerf import BakedFastNeRF

            return BakedFastNeRF(params.pos_grid, params.beta_grid, params.num_factors,
                                 use_grid_kernel=False, domain=params.domain)
        ref = copy.copy(params.model)
        ref.interp_dtype = "float32"
        return ref

    launches = serve(torch, dev, tmp, "lego.txt", fused_cls, "grid_render_kernel", family,
                     svc=svc, reference=reference)
    found = matmul_kernels(torch, lambda: svc.render_pose(svc.orbit_pose(3), key_idx=3))
    say(f"serve: {label} --bake {BAKE_R}: matrix-product kernels in one request: "
        + ("not measured (no device events)" if found is None else f"{found}"))
    if found:
        fail(f"{label} --bake {BAKE_R}: a request ran matrix products {found}")
    del svc, cache
    torch.cuda.empty_cache()
    return {"launches": launches, "step_rps": rps, "bake_s": bake_s}


# ---------------------------------------------------------------- phase 30


def write_eval_config(tmp: str, base: str, name: str, **overrides) -> str:
    """configs/``base`` with the synthetic scene and ``overrides`` appended
    (a later key wins), written as ``name`` in ``tmp``; returns its path."""
    with open(os.path.join(ROOT, "configs", base)) as f:
        text = f.read()
    keys = {"dataset_path": os.path.join(tmp, "scene"), **overrides}
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text + "\n" + "".join(f"{k} = {v}\n" for k, v in keys.items()))
    return path


def run_eval_cli(argv: list, counters: dict, label: str) -> dict:
    """``nerf_tpu_torch.cli.eval_cli.main(argv)`` in-process on the card
    (its default device). Every line it logs is printed; at each frame or
    view line the launch counts of ``counters`` (name -> wrapper class) are
    read. Returns the lines, the per-frame launches of each counter (from
    the counts before the call, the bake's launches included in the first)
    and the per-frame wall ms it printed."""
    import re

    from nerf_tpu_torch.cli.eval_cli import main as eval_main

    lines, at = [], []
    start = {k: c.launches for k, c in counters.items()}

    def log(line):
        line = str(line)
        lines.append(line)
        say(f"eval {label}: {line}")
        if re.match(r"(frame|view) \d+/\d+: ", line):
            at.append({k: c.launches for k, c in counters.items()})

    eval_main(argv, log=log)
    per = {k: [b[k] - a[k] for a, b in zip([start] + at[:-1], at)] for k in counters}
    ms = [float(m.group(1)) for m in (re.search(r"\(([0-9.]+) ms\)$", x) for x in lines
                                      if re.match(r"(frame|view) \d+/\d+: ", x)) if m]
    return {"lines": lines, "per_frame": per, "ms": ms}


def psnr_bounds(pred_u8, gt) -> tuple:
    """The PSNR interval of a float image in [0, 1] whose 8-bit PNG
    (``(x * 255).astype(uint8)``) is ``pred_u8``, against ``gt``: each
    value lies in [u, u + 1] / 255 (widened by 1e-3 of a step for the
    float32 product), so its squared error lies between the interval's
    least and largest."""
    u = pred_u8.astype(np.float64)
    lo, hi = (u - 1e-3) / 255.0, (u + 1.0 + 1e-3) / 255.0
    g = np.asarray(gt, np.float64)
    near = np.where(g < lo, lo - g, np.where(g > hi, g - hi, 0.0))
    far = np.maximum(np.abs(lo - g), np.abs(hi - g))
    mse_lo, mse_hi = float(np.mean(near ** 2)), float(np.mean(far ** 2))
    psnr = lambda m: math.inf if m <= 0 else -10.0 * math.log10(m)   # noqa: E731
    return psnr(mse_hi * (1 + 1e-5)), psnr(mse_lo * (1 - 1e-5))


def eval_cli(torch, dev, tmp: str, card: str) -> dict:
    """Phase 30: the eval CLI (``python -m nerf_tpu_torch.cli.eval_cli``)
    on the card, in-process through ``main``, from the checkpoints of
    earlier phases. (a) lego.txt (phase 5's checkpoint), 4 orbit frames at
    400 x 400 with --video: 40 NeRF forward launches a frame, each frame
    within mean abs 1e-2 of the unfused render of the same pose and key
    (RenderService with use_pallas = false), the GIF read back by
    utils/gif.py as 4 frames equal to the PNGs as quantised; (b)
    lego_siren.txt (phase 9's) with --metrics over the test split: 157
    SIREN forward launches a view, metrics.json finite with nerf_tpu's
    keys, each view's PSNR inside the interval its pred_*.png allows; (c)
    FastNeRF (phase 28's) with --bake 128: 40 factor-form launches a frame;
    (d) lego_siren.txt with --occupancy 64, one frame: the bake's 4 SIREN
    field launches and 157 render launches. Prints each part's wall ms a
    frame beside the card; returns the launches of each kernel."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.blender import load_blender
    from nerf_tpu_torch.data.poses import spherical_orbit
    from nerf_tpu_torch.ops.cuda.fused_grid_render import FusedFactorRender
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
    from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
    from nerf_tpu_torch.serve import RenderService
    from nerf_tpu_torch.utils.gif import quantize, read_gif
    from nerf_tpu_torch.utils.png import read_png

    per_image = {"lego": 2 * math.ceil(HW * HW / 8192), "siren": math.ceil(HW * HW / 1024)}
    ckpt = {"nerf": os.path.join(tmp, "train_models_nerf", "nerf_model_000200"),
            "siren": os.path.join(tmp, "train_models_siren", "siren_model_000200"),
            "fastnerf": os.path.join(tmp, "train_models_fastnerf",
                                     f"fastnerf_model_{BAKE_ITERS:06d}")}
    walls, launched = {}, {}

    def expect(label, per_frame: dict, want: dict) -> None:
        for k, w in want.items():
            if per_frame[k] != w:
                fail(f"eval {label}: {k} launches a frame {per_frame[k]}, want {w}")

    # (a) lego.txt orbit with --video
    cfg_path = write_eval_config(tmp, "lego.txt", "eval_lego.txt", num_render_poses=4)
    out = os.path.join(tmp, "eval_orbit")
    gif = os.path.join(out, "orbit.gif")
    res = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt["nerf"], "--output", out,
                        "--video", gif], {"nerf": FusedNerfRender}, "(a) lego.txt orbit")
    expect("(a)", res["per_frame"], {"nerf": [per_image["lego"]] * 4})
    launched["fused_render_fwd"] = sum(res["per_frame"]["nerf"])
    walls["a"] = res["ms"]
    ref = RenderService.from_checkpoint(
        dataclasses.replace(parse_config_file(cfg_path), use_pallas=False), ckpt["nerf"],
        device=dev, log=lambda *a: None)
    poses = spherical_orbit(4)
    frames = []
    for i in range(4):
        frame = read_png(os.path.join(out, f"frame_{i:04d}.png"))
        if frame.shape != (HW, HW, 3):
            fail(f"eval (a): frame {i} shape {frame.shape}")
        want = ref.render_pose(poses[i], key_idx=i)
        diff = np.abs(frame.astype(np.float32) / 255.0 - want)
        say(f"eval (a) frame {i} vs the unfused render: mean abs {diff.mean():.3e} "
            f"(tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}")
        if not diff.mean() <= SERVE_TOL_MEAN:
            fail(f"eval (a): frame {i} disagrees with the unfused render")
        frames.append(frame)
    del ref
    shown = read_gif(gif)
    same = [np.array_equal(s, pal[idx]) for s, (idx, pal) in
            zip(shown, (quantize(f) for f in frames))]
    say(f"eval (a) {os.path.basename(gif)}: {len(shown)} frames read back, equal to the "
        f"quantised PNGs: {same}")
    if len(shown) != 4 or not all(same):
        fail("eval (a): the GIF does not hold the orbit's frames")

    # (b) lego_siren.txt --metrics over the test split
    cfg_path = write_eval_config(tmp, "lego_siren.txt", "eval_siren.txt")
    out = os.path.join(tmp, "eval_metrics")
    res = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt["siren"], "--output", out,
                        "--metrics"], {"siren": FusedSirenRender}, "(b) lego_siren.txt --metrics")
    cfg = parse_config_file(cfg_path)
    gt, _, _ = load_blender(cfg.dataset_path, mode="test",
                            white_background=cfg.white_background, half_res=cfg.half_res)
    expect("(b)", res["per_frame"], {"siren": [per_image["siren"]] * len(gt)})
    launched["fused_render_siren_fwd"] = sum(res["per_frame"]["siren"])
    walls["b"] = res["ms"]
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    if (set(m) != {"num_views", "mean_psnr", "mean_ssim", "views"}
            or m["num_views"] != len(gt) or len(m["views"]) != len(gt) or not len(gt)):
        fail(f"eval (b): metrics.json {sorted(m)} with {m.get('num_views')} views")
    for v in m["views"]:
        vals = [v["mse"], v["psnr"], v["ssim"], m["mean_psnr"], m["mean_ssim"]]
        if not all(math.isfinite(x) for x in vals):
            fail(f"eval (b): metrics.json holds non-finite values {v}")
        pred = read_png(os.path.join(out, f"pred_{v['view']:03d}.png"))
        lo, hi = psnr_bounds(pred, gt[v["view"]])
        png_psnr = -10.0 * math.log10(float(np.mean((pred / 255.0 - gt[v["view"]]) ** 2)))
        say(f"eval (b) view {v['view']}: PSNR {v['psnr']:.4f} (from pred_*.png "
            f"{png_psnr:.4f}, the PNG allows [{lo:.4f}, {hi:.4f}]), SSIM {v['ssim']:.4f}")
        if not lo <= v["psnr"] <= hi:
            fail(f"eval (b): view {v['view']}'s PSNR is not its pred_*.png's")

    # (c) FastNeRF --bake 128
    cfg_path = write_eval_config(tmp, "lego.txt", "eval_fastnerf.txt", model_type="fastnerf",
                                 num_render_poses=2)
    res = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt["fastnerf"], "--output",
                        os.path.join(tmp, "eval_bake"), "--bake", str(BAKE_R)],
                       {"factor": FusedFactorRender}, f"(c) fastnerf --bake {BAKE_R}")
    expect("(c)", res["per_frame"], {"factor": [per_image["lego"]] * 2})
    launched["grid_render_factors"] = sum(res["per_frame"]["factor"])
    walls["c"] = res["ms"]

    # (d) lego_siren.txt --occupancy 64, one frame
    cfg_path = write_eval_config(tmp, "lego_siren.txt", "eval_occ.txt", num_render_poses=1)
    res = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt["siren"], "--output",
                        os.path.join(tmp, "eval_occ"), "--occupancy", "64"],
                       {"siren": FusedSirenRender, "field": SirenField},
                       "(d) lego_siren.txt --occupancy 64")
    expect("(d)", res["per_frame"], {"siren": [per_image["siren"]], "field": [4]})
    launched["fused_render_siren_fwd"] += sum(res["per_frame"]["siren"])
    launched["fused_siren_fwd"] = sum(res["per_frame"]["field"])
    walls["d"] = res["ms"]
    for part, ms in walls.items():
        say(f"eval ({part}): {statistics.median(ms):.1f} ms a frame wall (median of "
            f"{len(ms)}: {', '.join(f'{x:.1f}' for x in ms)}; render, host copy and PNG "
            f"write), {card}")
    return launched


# ---------------------------------------------------------------- phase 31

# fern's shapes (configs/fern.txt, llff_factor 8): 20 views, images_8/ PNGs
# of 504 x 378, and a poses_bounds.npy whose hwf is the full 3024 x 4032
# capture (focal 3260.526 px)
FERN_VIEWS, FERN_HW, FERN_FULL = 20, (378, 504), (3024, 4032, 3260.526)
FERN_ITERS = 200


def fern_views(hw: tuple, hwf: tuple, seed: int = 31):
    """The views of a synthetic forward-facing LLFF scene, rendered at
    ``hw`` with the focal of the capture ``hwf`` (h, w, focal) scaled to
    that width: cameras near (0, 0, 4) looking down -z with seeded lateral
    offsets, a shaded sphere of radius 1 at the origin before a striped
    wall at z = -3. Yields (uint8 image, poses_bounds row: [down, right,
    back, t | hwf], depth bounds 2.5 / 7.5)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    focal = hwf[2] * w / hwf[1]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
                       indexing="xy")
    d = np.stack([u - 0.5 * w, -(v - 0.5 * h), -np.full_like(u, focal)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for _ in range(FERN_VIEWS):
        o = np.array([*rng.uniform(-0.5, 0.5, 2), 4.0], np.float32)
        b = 2.0 * d @ o
        disc = b * b - 4.0 * (o @ o - 1.0)
        ts = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
        hit = (disc > 0) & (ts > 0)
        tw = (-3.0 - o[2]) / d[:, 2]
        pw = o + tw[:, None] * d
        img = np.stack([0.5 + 0.35 * np.sin(2.0 * pw[:, 0]), 0.5 + 0.35 * np.cos(3.0 * pw[:, 1]),
                        np.full(len(d), 0.6)], -1)
        p = o + ts[:, None] * d
        shade = 0.5 + 0.5 * np.clip(p @ np.array([0.3, 0.5, 0.8]), -1, 1)
        img[hit] = np.array([0.9, 0.3, 0.2]) * shade[hit, None]
        m = np.stack([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], o], axis=1)
        col = np.array([[hwf[0]], [hwf[1]], [hwf[2]]])
        yield ((np.clip(img, 0, 1).reshape(h, w, 3) * 255).astype(np.uint8),
               np.concatenate([np.concatenate([m, col], 1).reshape(-1), [2.5, 7.5]]))


def write_fern_scene(root: str, seed: int = 31) -> str:
    """``fern_views`` at fern's shapes, written as images_8/img_*.png (the
    port's PNG writer) and poses_bounds.npy."""
    from nerf_tpu_torch.utils.png import write_png

    os.makedirs(os.path.join(root, "images_8"), exist_ok=True)
    rows = []
    for i, (img, row) in enumerate(fern_views(FERN_HW, FERN_FULL, seed)):
        write_png(os.path.join(root, "images_8", f"img_{i:03d}.png"), img)
        rows.append(row)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return root


def fern_config(tmp: str, **overrides):
    """configs/fern.txt on the synthetic scene (``tmp``/fern), saving and
    logging under ``tmp``."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file

    cfg = parse_config_file(os.path.join(ROOT, "configs", "fern.txt"))
    return dataclasses.replace(cfg, dataset_path=os.path.join(tmp, "fern"),
                               save_path=os.path.join(tmp, "fern_models"),
                               log_dir=os.path.join(tmp, "fern_logs"), **overrides)


def ndc_batch(torch, pool, num_rays: int, s: int, seed: int) -> tuple:
    """(rays_o, rays_d, viewdirs, t, target) of ``num_rays`` rays of an NDC
    pool drawn with a seeded generator: NDC rays, their world directions,
    stratified jittered t in [0, 1] (every 4th ray's last sample at exactly
    t = 1, the far plane), the pixels as targets."""
    g = torch.Generator(device=pool.rays_o.device).manual_seed(seed)
    b = pool.sample(g, num_rays)
    edges = torch.linspace(0.0, 1.0, s + 1, device=b.rays_o.device)
    t = edges[:-1] + torch.rand(num_rays, s, generator=g, device=b.rays_o.device) / s
    t[::4, -1] = 1.0
    return b.rays_o, b.rays_d, b.viewdirs, t, b.rgb


def check_ndc_kernels(torch, dev, tmp: str):
    """Phase 31 (a): rows 3 and 5 in fern.txt's mode against their plain versions (TF32
    off), float32 and bfloat16, at 1024 x 128 and 8192 x 64: normalize off
    (the rays are NDC, the positions in [-1, 1]^3 as they are), the world
    view directions of the pool (not the NDC directions), t in [0, 1]; the
    train pass with a black and a white background. Each cell under the
    unchanged TOL / GRAD_TOL, timed in turns against its plain version and
    its bound. Writes the synthetic fern scene into ``tmp``/fern for phase
    31."""
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_render import (
        FusedNerfRender, fused_render_plain, fused_train_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    write_fern_scene(os.path.join(tmp, "fern"))
    pool = load_scene(fern_config(tmp), device=dev).pool
    say(f"kernel ndc: the synthetic fern scene written and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({pool.size} NDC train rays)")
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = NeRFModel(compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(31)).to(dev)
        fr = FusedNerfRender(model, 0.0, 1.0, normalize=False)
        with torch.no_grad():
            packed = fr.pack(model)
        weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                        + packed.vec.numel() * 4)
        grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4
        for r, s in ((1024, 128), (8192, 64)):
            ro, rd, vd, t, tgt = ndc_batch(torch, pool, r, s, 3100 + s)
            o_aff, d_aff = fr.affine(ro, rd)
            if not (o_aff is ro and d_aff is rd):
                fail("kernel ndc: normalize=False changed the rays")
            pts = ro[:, None] + t[..., None] * rd[:, None]
            lo, hi = pts.reshape(-1, 3).amin(0).tolist(), pts.reshape(-1, 3).amax(0).tolist()
            say(f"kernel ndc R={r} S={s}: NDC points x in [{lo[0]:.3f}, {hi[0]:.3f}], y in "
                f"[{lo[1]:.3f}, {hi[1]:.3f}], z in [{lo[2]:.6f}, {hi[2]:.6f}]; t in "
                f"[{float(t.min()):.6f}, {float(t.max()):.6f}]")
            if (lo[2] < -1.0 - 1e-5 or hi[2] > 1.0 + 1e-5
                    or torch.allclose(vd, rd / rd.norm(dim=-1, keepdim=True))):
                fail("kernel ndc: the cell's depths leave [-1, 1] or its view "
                     "directions are the NDC directions")
            fns = {
                ("fused_render_fwd", None): (
                    lambda: fused_render_plain(packed, ro, rd, vd, t, 10, 4),
                    lambda: fr(packed, ro, rd, vd, t))}
            for wb in (False, True):
                fns[("fused_render_train", wb)] = (
                    lambda wb=wb: fused_train_plain(packed, ro, rd, vd, t, tgt, wb, 10, 4),
                    lambda wb=wb: fr._train(packed, ro, rd, vd, t, tgt, wb))
            for (name, wb), (plain, kern) in fns.items():
                label = (f"kernel {name} ndc {cdt} R={r} S={s}"
                         + ("" if wb is None else f" white_bg={int(wb)}"))
                with torch.no_grad():
                    ref, got = plain(), kern()
                    torch.cuda.synchronize()
                    if name == "fused_render_fwd":
                        keys = ("rgb", "acc", "depth", "weights")
                        errs = {k: float((got[k] - ref[i]).abs().max())
                                for i, k in enumerate(keys)}
                        finite = all(bool(torch.isfinite(got[k]).all()) for k in keys)
                        bad = {k: v for k, v in errs.items() if not v <= TOL[cdt][k]}
                    else:
                        errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
                        for i, k in ((1, "rgb"), (2, "acc"), (3, "weights")):
                            errs[k] = float((got[i] - ref[i]).abs().max())
                        gerr = grad_errors(torch, got[4], ref[4])
                        finite = all(bool(torch.isfinite(x).all()) for x in got[1:4])
                        bad = {k: v for k, v in errs.items() if not v <= TOL[cdt]["rgb"]}
                        bad.update({k: v for k, v in gerr.items() if not v <= GRAD_TOL[cdt]})
                        errs["grad_worst"] = max(gerr.values())
                    del ref, got
                    torch.cuda.empty_cache()
                    plain(); kern()                        # warm-up
                    times = {"plain": [], "kernel": []}
                    for which in ("plain", "kernel", "kernel", "plain"):
                        times[which] += time_calls(torch, plain if which == "plain" else kern, 2)
                    torch.cuda.empty_cache()
                ms = statistics.median(times["kernel"])
                plain_ms = statistics.median(times["plain"])
                if name == "fused_render_fwd":
                    bms, by = bound_ms(r, s, cdt, weight_bytes, mlp_macs(256, 63, 27))
                else:
                    bms, by = bound_ms(r, s, cdt, weight_bytes,
                                       3 * mlp_macs(256, 63, 27) - SKIPPED_MACS,
                                       grad_bytes=grad_bytes, train=True)
                say(f"{label}: max_abs_err " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                    + f" (tol {TOL[cdt]['rgb']:.0e}, depth {TOL[cdt]['depth']:.0e}, gradients "
                    f"{GRAD_TOL[cdt]:.0e} of max) | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"bound {bms:.3f} ms ({by}), share of bound {bms / ms:.4f}")
                if bad or not finite:
                    fail(f"{label} disagrees with its plain version: {bad} (finite {finite})")
                results[(name, cdt, r, s, wb)] = dict(
                    err=max(v for k, v in errs.items() if k != "loss"), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return results


def serve_spiral_pose(torch, dev, cfg, ckpt: str, label: str, card: str) -> tuple:
    """An LLFF checkpoint served over HTTP on loopback: a first request
    (/pose/1, untimed), then /pose/0 (the spiral's first pose), timed: a
    PNG of the scene's size in 2 x ceil(h w / 8192) forward launches, within
    mean abs ``SERVE_TOL_MEAN`` of the unfused render of the same NDC rays.
    Returns (ms of the timed request, the launches of both, the unfused
    service)."""
    import dataclasses

    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.serve import RenderService, make_http_server
    from nerf_tpu_torch.utils.png import decode_png

    svc = RenderService.from_checkpoint(cfg, ckpt, device=dev, log=say)
    ref = RenderService.from_checkpoint(dataclasses.replace(cfg, use_pallas=False), ckpt,
                                        device=dev, log=lambda *a: None)
    h, w = svc.hw
    per_frame = 2 * math.ceil(h * w / 8192)
    if not svc.ndc or svc.render_poses is None:
        fail(f"{label}: service hw {svc.hw}, ndc {svc.ndc}")
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        first = FusedNerfRender.launches
        get(base + "/pose/1")                    # a first request, untimed
        before = FusedNerfRender.launches
        t0 = time.perf_counter()
        code, ctype, body = get(base + "/pose/0")
        req_ms = (time.perf_counter() - t0) * 1e3
        n = FusedNerfRender.launches - before
        served = FusedNerfRender.launches - first
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    img = decode_png(body)
    if code != 200 or ctype != "image/png" or img.shape != (h, w, 3) or n != per_frame:
        fail(f"{label} /pose/0: {code} {ctype} {img.shape}, {n} launches (want {per_frame})")
    want = ref.render_pose(svc.orbit_pose(0), key_idx=0)
    diff = np.abs(img.astype(np.float32) / 255.0 - want)
    say(f"serve {label} /pose/0 (the spiral's first pose): 200 image/png {w}x{h}, {n} "
        f"kernel launches, {req_ms:.1f} ms, {h * w / req_ms * 1e3:.0f} rays/s; vs the "
        f"unfused render of the same NDC rays: mean abs {diff.mean():.3e} (tol "
        f"{SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}; {card}")
    if not diff.mean() <= SERVE_TOL_MEAN:
        fail(f"{label}: the served image disagrees with the unfused render")
    return req_ms, served, ref


def fern(torch, dev, tmp: str, card: str) -> dict:
    """Phase 31 (b)-(d): configs/fern.txt (LLFF, NDC rays, black background,
    NeRF hidden 256 in bf16, 64 + 64 samples) on the synthetic fern scene
    that (a), ``check_ndc_kernels``, wrote. (b) fit() 200 iterations, logs every 10, validation
    and saves every 100: 2 train launches a step (S = 64 and 128), 48
    forward launches for the 504 x 378 validation frame, the mse at 190
    under half of that at 0; then a resume from the step-100 checkpoint to
    220 that repeats the first run's mse bit for bit. (b) One spiral-pose
    request over HTTP: a 504 x 378 PNG, 48 forward launches, within mean
    abs 1e-2 of the unfused render of the same NDC rays. (c) The eval CLI:
    4 spiral frames (48 launches each, each within mean abs 1e-2 of the
    unfused render) and --metrics over the 3 test views. Returns the
    launches of rows 3 and 5 and the walls."""
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.utils.png import read_png

    h, w = FERN_HW
    per_frame = 2 * math.ceil(h * w / 8192)
    cfg = fern_config(tmp, num_iters=FERN_ITERS, log_interval=10, val_interval=100,
                      save_interval=100)
    lines: list = []
    FusedNerfRender.launches = FusedNerfRender.train_launches = 0
    FusedNerfRender.bwd_launches = 0          # the main path's counts start here
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (FusedNerfRender.train_launches, FusedNerfRender.launches,
              FusedNerfRender.bwd_launches)
    say(f"fern: fit fern.txt {FERN_ITERS} iterations in {wall:.1f} s; launches: train "
        f"{counts[0]} ({counts[0] / FERN_ITERS:.0f} a step), forward {counts[1]} (the "
        f"validation frame), backward {counts[2]}")
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Loaded scene" in line:
            say(f"  {line}")
    if counts != (2 * FERN_ITERS, per_frame, 0):
        fail(f"fern: fit launched (train, forward, backward) {counts}, want "
             f"{(2 * FERN_ITERS, per_frame, 0)}")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    last = FERN_ITERS - 10                     # the last logged iteration
    if not all(math.isfinite(v) for v in loss.values()) or not loss[last] < 0.5 * loss[0]:
        fail(f"fern: mse at {last} ({loss[last]}) is not under half of that at 0 "
             f"({loss[0]})")
    step_rps = scal["rays_per_sec"][last]
    say(f"fern: mse {loss[0]:.6f} at 0 -> {loss[last]:.6f} at {last} (ratio "
        f"{loss[last] / loss[0]:.4f}); fern.txt step {step_rps:.0f} rays/s (1024 rays, "
        f"64+64 samples, bfloat16), {card}")
    check_resume(torch, dev, tmp, cfg, "nerf", loss, tag="fern", until=220)
    ckpt = os.path.join(cfg.save_path, f"nerf_model_{FERN_ITERS:06d}")
    train_launches = 2 * FERN_ITERS

    # (c) one spiral-pose request over HTTP
    req_ms, served, ref = serve_spiral_pose(torch, dev, cfg, ckpt, "fern.txt", card)
    fwd_launches = counts[1] + served        # the validation frame, two requests

    # (d) the eval CLI: 4 spiral frames, then --metrics over the test views
    cfg_path = os.path.join(tmp, "eval_fern.txt")
    with open(os.path.join(ROOT, "configs", "fern.txt")) as f, open(cfg_path, "w") as g:
        g.write(f.read() + f"\ndataset_path = {cfg.dataset_path}\nnum_render_poses = 4\n")
    out = os.path.join(tmp, "eval_fern")
    res = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt, "--output", out],
                       {"nerf": FusedNerfRender}, "(31d) fern.txt spiral")
    if res["per_frame"]["nerf"] != [per_frame] * 4:
        fail(f"fern eval: launches a frame {res['per_frame']['nerf']}, want {per_frame}")
    for i in range(4):
        frame = read_png(os.path.join(out, f"frame_{i:04d}.png"))
        want = ref.render_pose(ref.orbit_pose(i), key_idx=i)
        diff = np.abs(frame.astype(np.float32) / 255.0 - want)
        say(f"eval (31d) frame {i} vs the unfused render of the same NDC rays: mean abs "
            f"{diff.mean():.3e} (tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}")
        if frame.shape != (h, w, 3) or not diff.mean() <= SERVE_TOL_MEAN:
            fail(f"fern eval: frame {i} disagrees with the unfused render")
    frame_ms = res["ms"]
    out = os.path.join(tmp, "eval_fern_metrics")
    res_m = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt, "--output", out,
                          "--metrics"], {"nerf": FusedNerfRender}, "(31d) fern.txt --metrics")
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    if (m["num_views"] != 3 or res_m["per_frame"]["nerf"] != [per_frame] * 3
            or not all(math.isfinite(v["psnr"]) for v in m["views"])):
        fail(f"fern --metrics: {m['num_views']} views, launches {res_m['per_frame']}")
    fwd_launches += sum(res["per_frame"]["nerf"]) + sum(res_m["per_frame"]["nerf"])
    say(f"eval (31d): {statistics.median(frame_ms):.1f} ms a 504x378 spiral frame wall "
        f"(median of 4: {', '.join(f'{x:.1f}' for x in frame_ms)}), "
        f"{statistics.median(res_m['ms']):.1f} ms a --metrics view; test-split PSNR "
        f"{m['mean_psnr']:.4f}, SSIM {m['mean_ssim']:.4f}; {card}")
    return {"train_launches": train_launches, "fwd_launches": fwd_launches,
            "step_rps": step_rps, "request_ms": req_ms, "frame_ms": frame_ms}


# ---------------------------------------------------------------- phase 32

NGP_ITERS = 200


def ngp(torch, dev, tmp: str, card: str) -> dict:
    """Phase 32: configs/ngp_synthetic.txt (Instant NGP: 16 levels of 2^19 x 2
    hash tables, the config's hidden 256, 64 samples, float32, lr 1e-2) on
    the synthetic 400 x 400 Blender scene. The hash rows of 65,536 points on
    the card equal to the CPU's. fit() 200 iterations with its occupancy
    prior (32^3, rebaked every 100 optimizer steps, so once mid-run), logs
    every 10, validation and saves every 100: finite losses, the mse at 190
    under that at 0, one scatter-add launch a step (row 19: the tables'
    gradient, C = 2); a resume from the step-100 checkpoint (a rebake) to
    120 that repeats the first run's mse bit for bit; then one request over
    HTTP and one eval frame, 400 x 400, finite; torch.profiler traces of a
    step and a request. Returns the scatter-add launches and the walls."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.models.ngp import NGPModel
    from nerf_tpu_torch.ops.cuda.scatter_add import ScatterKernel
    from nerf_tpu_torch.serve import RenderService, make_http_server
    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.utils.png import decode_png, read_png

    scene = os.path.join(tmp, "scene")
    if not os.path.isdir(scene):
        write_sphere_scene(scene, HW)
    probe = NGPModel(log2_table=19)
    pts = (torch.rand(65536, 3, generator=torch.Generator().manual_seed(32)) * 2.2 - 1.1)
    cpu_rows = torch.stack([r for r, _ in probe._cells(pts)])
    dev_rows = torch.stack([r for r, _ in probe._cells(pts.to(dev))]).cpu()
    hashed = sum((int(r) + 1) ** 3 > (1 << 19) for r in probe.level_resolutions())
    say(f"ngp: hash rows of 65,536 points x 16 levels x 8 corners ({hashed} levels hashed) "
        f"on the card equal to the CPU's: {torch.equal(cpu_rows, dev_rows)}")
    if not torch.equal(cpu_rows, dev_rows):
        fail("ngp: the card's hash rows differ from the CPU's")

    cfg = dataclasses.replace(
        parse_config_file(os.path.join(ROOT, "configs", "ngp_synthetic.txt")),
        dataset_path=scene, num_iters=NGP_ITERS, occupancy_interval=100, log_interval=10,
        val_interval=100, save_interval=100, save_path=os.path.join(tmp, "ngp_models"),
        log_dir=os.path.join(tmp, "ngp_logs"))
    lines: list = []
    ScatterKernel.launches = 0                  # the main path's count starts here
    t0 = time.perf_counter()
    state = fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scatters = ScatterKernel.launches
    say(f"ngp: fit ngp_synthetic.txt {NGP_ITERS} iterations in {wall:.1f} s; scatter-add "
        f"launches {scatters} ({scatters / NGP_ITERS:.0f} a step)")
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Loaded scene" in line:
            say(f"  {line}")
    if scatters != NGP_ITERS:
        fail(f"ngp: {scatters} scatter-add launches in {NGP_ITERS} steps, want one a step")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    last = NGP_ITERS - 10
    if not all(math.isfinite(v) for v in loss.values()) or not loss[last] < loss[0]:
        fail(f"ngp: mse at {last} ({loss[last]}) is not under that at 0 ({loss[0]})")
    step_rps = scal["rays_per_sec"][last]
    say(f"ngp: mse {loss[0]:.6f} at 0 -> {loss[last]:.6f} at {last} (ratio "
        f"{loss[last] / loss[0]:.4f}); ngp_synthetic.txt step {step_rps:.0f} rays/s "
        f"({cfg.num_random_rays} rays, {cfg.num_samples} samples, hidden "
        f"{cfg.hidden_dim}, {cfg.compute_dtype}, occupancy {cfg.occupancy_res}^3), {card}")
    check_resume(torch, dev, tmp, cfg, "ngp", loss)
    # one step under the profiler (without the prior: the step's other work)
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.train.loop import render_settings_from_config

    profile_step(torch, state, load_scene(cfg, device=dev).pool,
                 render_settings_from_config(cfg), cfg, "scatter", "ngp_synthetic.txt")
    del state
    ckpt = os.path.join(cfg.save_path, f"ngp_model_{NGP_ITERS:06d}")

    svc = RenderService.from_checkpoint(cfg, ckpt, device=dev, log=say)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        get(base + "/pose/1")                    # a first request, untimed
        t0 = time.perf_counter()
        code, ctype, body = get(base + "/pose/0")
        req_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    img = decode_png(body)
    if code != 200 or ctype != "image/png" or img.shape != (HW, HW, 3):
        fail(f"ngp /pose/0: {code} {ctype} {img.shape}")
    say(f"serve ngp_synthetic.txt /pose/0: 200 image/png {HW}x{HW}, {req_ms:.1f} ms, "
        f"{HW * HW / req_ms * 1e3:.0f} rays/s (the module, no kernel), mean "
        f"{img.mean() / 255:.4f}; {card}")
    raw = svc.render_pose(svc.orbit_pose(2), key_idx=2)
    if not np.isfinite(raw).all():
        fail("ngp: a rendered frame is not finite")
    profile_device(torch, lambda: svc.render_pose(svc.orbit_pose(2), key_idx=2),
                   "index", "one ngp_synthetic.txt request")
    del svc

    cfg_path = write_eval_config(tmp, "ngp_synthetic.txt", "eval_ngp.txt", num_render_poses=1)
    out = os.path.join(tmp, "eval_ngp")
    res = run_eval_cli(["--config", cfg_path, "--checkpoint", ckpt, "--output", out],
                       {}, "(32) ngp_synthetic.txt")
    frame = read_png(os.path.join(out, "frame_0000.png"))
    if frame.shape != (HW, HW, 3):
        fail(f"ngp eval: frame shape {frame.shape}")
    say(f"eval (32): {res['ms'][0]:.1f} ms a 400x400 NGP frame wall, mean "
        f"{frame.mean() / 255:.4f}; {card}")
    return {"scatter_launches": scatters, "step_rps": step_rps, "request_ms": req_ms,
            "frame_ms": res["ms"][0]}


# ---------------------------------------------------------------- phase 33

MS_SCENES = 4          # (b): configs/lego.txt over four synthetic scenes
MS_ITERS = 200
MS_SAVE = 20           # (b) saves every 20 (the resume starts at 100; (d) reads 20)
MS_RESUME = (100, 120)  # (b)'s resume: from this saved step to that one
DIST_ITERS = 20        # (c)-(d): fit() steps with and without a process group
# (d)'s two gloo ranks (data:2, each rank half of every step's batch) take
# the one-process batches and samples, and sum the loss and the gradients in
# another grouping. In float32 (lego.txt with the f32 train kernel) that is
# held on each logged loss, relative, at 1e-5. In bfloat16 (lego.txt as it
# is) it is held at 1e-5 on the first DP_BF16_STEPS losses only: there the
# drift stays under 2.3e-6 on an H100 (700 W); then a rounding flip that
# the other grouping causes in one activation is carried through the later
# steps (1.1e-3 at step 13), which measures the format's chaos, not the
# collective, so those steps are printed, not held. A wrong row slice or
# wrong draws show at step 0.
DIST_DTYPES = ("bfloat16", "float32")
DP_TOL = 1e-5
DP_BF16_STEPS = 10


def ms_shades(n: int) -> list:
    """A seeded sphere colour per multi-scene scene."""
    rng = np.random.default_rng(33)
    return [tuple(float(c) for c in rng.uniform(0.15, 0.95, 3)) for _ in range(n)]


def interchange(torch, dev, tmp: str, card: str, ckpt: str) -> int:
    """Phase 33 (a): phase 5's lego.txt checkpoint exported to the
    reference's .pth (coarse, and --fine) and imported back: each model bit
    for bit, the step kept; the imported coarse checkpoint served on cuda
    over HTTP (a 400x400 PNG, 40 forward launches). Returns them."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.serve import RenderService, make_http_server
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint
    from nerf_tpu_torch.utils.png import decode_png
    from nerf_tpu_torch.utils.torch_export import export_torch_checkpoint
    from nerf_tpu_torch.utils.torch_import import import_torch_checkpoint

    cfg = dataclasses.replace(parse_config_file(os.path.join(ROOT, "configs", "lego.txt")),
                              dataset_path=os.path.join(tmp, "scene"))
    orig = load_checkpoint(ckpt)
    imported = {}
    for which in ("params", "fine_params"):
        t0 = time.perf_counter()
        pth = export_torch_checkpoint(ckpt, cfg, os.path.join(tmp, f"lego_{which}.pth"),
                                      use_fine=which == "fine_params")
        t1 = time.perf_counter()
        path = import_torch_checkpoint(pth, cfg, os.path.join(tmp, f"imported_{which}"))
        t2 = time.perf_counter()
        got = load_checkpoint(path)
        same = all(torch.equal(got[m][k], v) for m in ("params", "fine_params")
                   for k, v in orig[which].items())
        steps = (torch.load(pth, weights_only=True)["step"], got["train_step"])
        say(f"interchange: lego.txt {which} -> {os.path.basename(pth)} ({os.path.getsize(pth)} "
            f"bytes, {(t1 - t0) * 1e3:.1f} ms) -> port checkpoint ({(t2 - t1) * 1e3:.1f} ms): "
            f"bit for bit {same}, step {steps} (saved {orig['train_step']})")
        if not same or steps != (orig["train_step"],) * 2:
            fail(f"interchange: the {which} round trip is not bit for bit")
        imported[which] = path
    svc = RenderService.from_checkpoint(cfg, imported["params"], device=dev, log=say)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    FusedNerfRender.launches = 0                # the main path's count starts here
    try:
        t0 = time.perf_counter()
        code, ctype, body = get(f"http://127.0.0.1:{server.server_address[1]}/pose/0")
        req_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = FusedNerfRender.launches
    img = decode_png(body)
    say(f"interchange: the imported checkpoint served on {dev}: {code} {ctype} "
        f"{img.shape[1]}x{img.shape[0]}, {launches} forward launches, {req_ms:.1f} ms; {card}")
    if code != 200 or img.shape != (HW, HW, 3) or launches != 40:
        fail("interchange: the imported checkpoint did not serve a 400x400 PNG in 40 launches")
    return launches


def ms_config(tmp: str, scenes: list, name: str, **overrides) -> str:
    return write_eval_config(tmp, "lego.txt", name, dataset_path=scenes[0], **overrides)


def multiscene(torch, dev, tmp: str, card: str, single_rps: float) -> dict:
    """Phase 33 (b): ``python -m nerf_tpu_torch.cli.multiscene_cli`` (its
    main, in-process) on configs/lego.txt at full width over four synthetic
    400x400 scenes of seeded shades, 200 iterations: finite losses, each
    scene's mse at 190 under half of its mse at 0, exactly 4 x 2 x 200
    train launches and 4 x 40 forward launches a validation (one, at 100),
    the stacked checkpoints; a resume from 100 to 120 that repeats every
    scene's mse bit for bit; the aggregate rate beside phase 5's one-scene
    rate; a profiled 4-scene step."""
    import dataclasses

    from nerf_tpu_torch.cli import multiscene_cli
    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.parallel.mesh import create_mesh
    from nerf_tpu_torch.parallel.multiscene import make_multiscene_train_step, scene_seed
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.checkpoint import load_checkpoint, read_metadata, restore_scene

    scenes = []
    for i, shade in enumerate(ms_shades(MS_SCENES)):
        scenes.append(os.path.join(tmp, f"ms_scene{i}"))
        write_sphere_scene(scenes[-1], HW, shade)
    save, logs = os.path.join(tmp, "ms_models"), os.path.join(tmp, "ms_logs")
    cfg_path = ms_config(tmp, scenes, "multiscene.txt", num_iters=MS_ITERS, log_interval=10,
                         val_interval=100, save_interval=MS_SAVE, save_path=save,
                         log_dir=logs)
    FusedNerfRender.launches = FusedNerfRender.train_launches = 0
    FusedNerfRender.bwd_launches = 0            # the main path's counts start here
    lines: list = []
    t0 = time.perf_counter()
    multiscene_cli.main(["--config", cfg_path, "--scenes", *scenes, "--device", str(dev)],
                        log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (FusedNerfRender.train_launches, FusedNerfRender.launches,
              FusedNerfRender.bwd_launches)
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Mesh" in line or "Loaded" in line:
            say(f"  {line}")
    want = (MS_SCENES * 2 * MS_ITERS, MS_SCENES * 2 * math.ceil(HW * HW / 8192), 0)
    say(f"multiscene: {MS_SCENES} scenes x {MS_ITERS} iterations in {wall:.1f} s; launches: "
        f"train {counts[0]}, forward {counts[1]} (one validation), backward {counts[2]}")
    if counts != want:
        fail(f"multiscene launched (train, forward, backward) {counts}, want {want}")
    scal = read_scalars(logs)
    last = MS_ITERS - 10
    for i in range(MS_SCENES):
        mse = scal[f"scene{i}/mse"]
        if not all(math.isfinite(v) for v in mse.values()) or not mse[last] < 0.5 * mse[0]:
            fail(f"multiscene scene {i}: mse at {last} ({mse[last]}) not under half of "
                 f"that at 0 ({mse[0]})")
        say(f"multiscene: scene {i} mse {mse[0]:.6f} at 0 -> {mse[last]:.6f} at {last} "
            f"(ratio {mse[last] / mse[0]:.4f}); val psnr {min(scal[f'scene{i}/val_psnr'].items())[1]:.2f}")
    for step in (MS_RESUME[0], MS_ITERS):
        path = os.path.join(save, f"nerf_multiscene_model_{step:06d}")
        if not (os.path.exists(path) and read_metadata(path)["num_scenes"] == MS_SCENES):
            fail(f"multiscene: missing stacked checkpoint {path}")
    rps = scal["rays_per_sec"][last]
    say(f"multiscene: aggregate {rps:.0f} rays/s ({MS_SCENES} x 1024 rays a step), "
        f"{rps / MS_SCENES:.0f} a scene; lego.txt one scene (phase 5) {single_rps:.0f} "
        f"rays/s; ratio {rps / single_rps:.3f}; {card}")

    # the resume: every scene's mse repeats the first run's
    res_path = ms_config(tmp, scenes, "multiscene_resume.txt", num_iters=MS_RESUME[1],
                         log_interval=1,
                         val_interval=1000, save_interval=1000,
                         save_path=os.path.join(tmp, "ms_resume_models"),
                         log_dir=os.path.join(tmp, "ms_resume_logs"))
    ckpt100 = os.path.join(save, f"nerf_multiscene_model_{MS_RESUME[0]:06d}")
    FusedNerfRender.train_launches = 0
    multiscene_cli.main(["--config", res_path, "--scenes", *scenes, "--resume", ckpt100,
                         "--device", str(dev)], log=lambda *a: None)
    resumed_launches = FusedNerfRender.train_launches
    if resumed_launches != MS_SCENES * 2 * (MS_RESUME[1] - MS_RESUME[0]):
        fail(f"multiscene resume launched {resumed_launches} train passes, want "
             f"{MS_SCENES * 2 * (MS_RESUME[1] - MS_RESUME[0])}")
    again = read_scalars(os.path.join(tmp, "ms_resume_logs"))
    for i in range(MS_SCENES):
        first, second = scal[f"scene{i}/mse"], again[f"scene{i}/mse"]
        pairs = [(j, j + 1) for j in sorted(second) if j + 1 in first]
        if (len(pairs) != (MS_RESUME[1] - MS_RESUME[0]) // 10
                or any(second[j] != first[k] for j, k in pairs)):
            fail(f"multiscene resume: scene {i} does not repeat the first run bit for bit "
                 f"({[(second[j], first[k]) for j, k in pairs]})")
    say(f"multiscene: resumed {MS_RESUME[0]} -> {MS_RESUME[1]} ({resumed_launches} train "
        f"launches): every scene's mse at {pairs} repeats the first run bit for bit")

    # one 4-scene step under the profiler, from the final checkpoint
    cfg = parse_config_file(cfg_path)
    ckpt = load_checkpoint(os.path.join(save, f"nerf_multiscene_model_{MS_ITERS:06d}"))
    states = [restore_scene(create_train_state(cfg, seed=scene_seed(cfg.seed, i), device=dev),
                            ckpt, i) for i in range(MS_SCENES)]
    del ckpt
    pools = [load_scene(dataclasses.replace(cfg, dataset_path=s), device=dev).pool
             for s in scenes]
    step = make_multiscene_train_step([st.params for st in states],
                                      render_settings_from_config(cfg), cfg.num_random_rays,
                                      cfg.seed, create_mesh())
    FusedNerfRender.train_launches = 0
    step(states, pools)
    profile_device(torch, lambda: step(states, pools), "fused_render_train_tc",
                   f"one {MS_SCENES}-scene lego.txt train step")
    profiled = FusedNerfRender.train_launches
    if profiled != MS_SCENES * 2 * 2:
        fail(f"multiscene: two profiled steps launched {profiled} train passes, want "
             f"{MS_SCENES * 2 * 2}")
    return {"train_launches": counts[0] + resumed_launches + profiled,
            "fwd_launches": counts[1], "rps": rps, "scenes": scenes}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_config(tmp: str, name: str, cdt: str, **overrides):
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file

    return dataclasses.replace(
        parse_config_file(os.path.join(ROOT, "configs", "lego.txt")),
        dataset_path=os.path.join(tmp, "scene"), num_iters=DIST_ITERS, log_interval=1,
        val_interval=1000, save_interval=1000,
        save_path=os.path.join(tmp, f"{name}_{cdt}_models"),
        log_dir=os.path.join(tmp, f"{name}_{cdt}_logs"), compute_dtype=cdt, **overrides)


def flat_params(torch, state):
    return torch.cat([p.detach().reshape(-1) for m in state.models() for p in m.parameters()])


def allreduce_ms(torch, numel: int, dev, reps: int = 20) -> float:
    """Median ms of one all_reduce of ``numel`` float32 on ``dev`` in the
    current group: the host clock around ``reps`` calls and a synchronize
    (gloo's runs partly on the host), 3 runs."""
    import torch.distributed as dist

    buf = torch.ones(numel, device=dev)
    dist.all_reduce(buf)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def nccl_one_rank(torch, dev, tmp: str, card: str) -> dict:
    """Phase 33 (c): fit() on lego.txt for 20 iterations without a process
    group (bfloat16, and float32 for (d)), then with multihost = true in an
    NCCL group of one rank (bfloat16; each step's gradients, loss and mse
    through one all_reduce): the losses and the final parameters bit for
    bit; the all_reduce's time a step."""
    import torch.distributed as dist

    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.parallel.multihost import init_distributed
    from nerf_tpu_torch.train.loop import fit

    FusedNerfRender.train_launches = 0          # the main path's count starts here
    plain = {cdt: fit(dist_config(tmp, "plain", cdt), device=dev, log=lambda *a: None)
             for cdt in DIST_DTYPES}
    init_distributed(f"tcp://localhost:{free_port()}", world_size=1, rank=0, backend="nccl",
                     device="cuda")
    try:
        backend = dist.get_backend()
        t0 = time.perf_counter()
        nccl = fit(dist_config(tmp, "nccl", "bfloat16", multihost=True), device=dev,
                   log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        numel = flat_params(torch, nccl).numel() + 2
        ms = allreduce_ms(torch, numel, dev)
    finally:
        dist.destroy_process_group()
    launches = FusedNerfRender.train_launches
    losses = {cdt: read_scalars(os.path.join(tmp, f"plain_{cdt}_logs"))["loss"]
              for cdt in DIST_DTYPES}
    same = (losses["bfloat16"] == read_scalars(os.path.join(tmp, "nccl_bfloat16_logs"))["loss"]
            and torch.equal(flat_params(torch, plain["bfloat16"]), flat_params(torch, nccl)))
    say(f"nccl: fit lego.txt {DIST_ITERS} iterations, multihost = true in a {backend} group of "
        f"one rank ({wall:.1f} s) against no group: losses and parameters bit for bit {same}; "
        f"train launches {launches}; all_reduce of {numel} float32 ({numel * 4 / 1e6:.2f} MB) "
        f"{ms:.4f} ms a step; {card}")
    if backend != "nccl" or not same or launches != 2 * DIST_ITERS * (len(DIST_DTYPES) + 1):
        fail("nccl: the one-rank NCCL fit does not equal the undistributed fit bit for bit")
    return {"train_launches": launches, "allreduce_ms": ms, "losses": losses,
            "numel": numel}


def two_rank_worker(rank: int, tmp: str, port: int, scenes: list, device: str) -> None:
    """Phase 33 (d), one of two ranks on the one card over gloo (named, not a
    fallback: NCCL takes one rank a GPU): fit() on data:2, then
    fit_multiscene on scene:2,data:1 over (b)'s first two scenes; rank 0
    also times a gloo all_reduce of the step's buffer. Results to
    ``{tmp}/rank{rank}.json``."""
    sys.path.insert(0, ROOT)
    import dataclasses

    import torch

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.parallel.multihost import init_distributed
    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.train.multiscene_loop import fit_multiscene

    dev = torch.device(device)
    init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo",
                     device=dev)
    import torch.distributed as dist

    out = {"backend": dist.get_backend(), "rank": rank}
    quiet = lambda *a: None  # noqa: E731
    for cdt in DIST_DTYPES:
        t0 = time.perf_counter()
        state = fit(dist_config(tmp, "gloo", cdt, mesh_shape="data:2"), device=dev, log=quiet)
        torch.cuda.synchronize()
        out[f"fit_s_{cdt}"] = time.perf_counter() - t0
    out["numel"] = flat_params(torch, state).numel() + 2
    cfg = dataclasses.replace(
        parse_config_file(ms_config(tmp, scenes, f"ms_gloo_{rank}.txt",
                                    num_iters=MS_SAVE + 1, log_interval=10,
                                    val_interval=1000, save_interval=1000)),
        mesh_shape="scene:2,data:1", save_path=os.path.join(tmp, "gloo_ms_models"),
        log_dir=os.path.join(tmp, "gloo_ms_logs"))
    fit_multiscene(cfg, scenes[:2], device=dev, log=quiet)
    out["train_launches"] = FusedNerfRender.train_launches
    out["allreduce_ms"] = allreduce_ms(torch, out["numel"], dev)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def two_ranks(torch, dev, tmp: str, card: str, nccl: dict, ms_scenes: list) -> dict:
    """Phase 33 (d): two processes on the one card in a gloo group:
    data:2 within DP_TOL of (c)'s undistributed losses (every step in
    float32, the first DP_BF16_STEPS in bfloat16); scene:2,data:1 over
    21 steps gives each scene's state equal bit for bit to (b)'s save at
    iteration 20 (21 steps)."""
    import torch.multiprocessing as mp

    from nerf_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    mp.start_processes(two_rank_worker, args=(tmp, free_port(), ms_scenes, str(dev)),
                       nprocs=2, join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    say(f"gloo: two ranks on {dev} ({ranks[0]['backend']}, {wall:.1f} s with start-up); "
        f"all_reduce of {ranks[0]['numel']} float32 {ranks[0]['allreduce_ms']:.4f} ms; train "
        f"launches {[r['train_launches'] for r in ranks]}; {card}")
    rel = {}
    for cdt in DIST_DTYPES:
        got = read_scalars(os.path.join(tmp, f"gloo_{cdt}_logs"))["loss"]
        want = nccl["losses"][cdt]
        rels = [abs(got[i] - want[i]) / abs(want[i]) for i in sorted(want) if i in got]
        rel[cdt] = max(rels)
        held = len(rels) if cdt == "float32" else DP_BF16_STEPS
        say(f"gloo: fit lego.txt ({cdt}) data:2 {DIST_ITERS} iterations "
            f"({ranks[0][f'fit_s_{cdt}']:.1f} s): losses against one process max relative "
            f"{rel[cdt]:.3e}, over the first {held} steps {max(rels[:held]):.3e} (tol "
            f"{DP_TOL:.0e}{'; later steps printed, not held' if held < len(rels) else ''}); "
            f"by step {[f'{r:.1e}' for r in rels]}")
        if sorted(got) != sorted(want) or max(rels[:held]) > DP_TOL:
            fail(f"gloo: the {cdt} data:2 fit does not agree with the one-process fit over "
                 f"its first {held} steps")
    # (b)'s interval save at iteration 20 holds 21 steps, as the final save of
    # 21 iterations does
    mine = load_checkpoint(os.path.join(tmp, "gloo_ms_models",
                                        f"nerf_multiscene_model_{MS_SAVE + 1:06d}"))
    ref = load_checkpoint(os.path.join(tmp, "ms_models",
                                       f"nerf_multiscene_model_{MS_SAVE:06d}"))
    same = mine["train_step"] == ref["train_step"] == MS_SAVE + 1
    same &= all(torch.equal(mine[m][k][i], ref[m][k][i]) for m in ("params", "fine_params")
               for k in ref[m] for i in range(2))
    same &= all(torch.equal(a[i], b[i]) for a, b in zip(
        mine["optimizer"]["mu"] + mine["optimizer"]["nu"],
        ref["optimizer"]["mu"] + ref["optimizer"]["nu"]) for i in range(2))
    say(f"gloo: fit_multiscene scene:2,data:1 (a scene a rank), {MS_SAVE + 1} steps: scenes 0 "
        f"and 1 equal the 4-scene run's (b) save at {MS_SAVE} bit for bit: {same}")
    if not same:
        fail("gloo: the scene-split multi-scene states differ from the one-process run")
    return {"train_launches": sum(r["train_launches"] for r in ranks),
            "allreduce_ms": ranks[0]["allreduce_ms"], "rel": rel}


def parallel(torch, dev, tmp: str, card: str, lego_ckpt: str, single_rps: float) -> dict:
    """Phase 33: the interchange (a), multi-scene training (b), NCCL at one
    rank (c) and two gloo ranks on the card (d). Returns the launches of
    rows 3 and 5 and the measurements."""
    t0 = time.perf_counter()
    served = interchange(torch, dev, tmp, card, lego_ckpt)
    ms = multiscene(torch, dev, tmp, card, single_rps)
    nccl = nccl_one_rank(torch, dev, tmp, card)
    gloo = two_ranks(torch, dev, tmp, card, nccl, ms["scenes"])
    say(f"phase 33: {time.perf_counter() - t0:.1f} s")
    return {"fwd_launches": served + ms["fwd_launches"],
            "train_launches": ms["train_launches"] + nccl["train_launches"]
            + gloo["train_launches"]}


# ---------------------------------------------------------------- phase 34

JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")   # make_fixtures.py's output
JPEG_FULL_HW = (756, 1008)     # the JPEG capture's frames (llff/images/img_*.jpg)
JPEG_FACTOR = 2                # configs/fern.txt's llff_factor on it: 504 x 378
LOG_REPS = 20                  # timed logger calls (median)


def _crc32c_table() -> list:
    """CRC-32C (Castagnoli), written here apart from the port's."""
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 * (c & 1))
        table.append(c)
    return table


def masked_crc32c(data: bytes, table: list) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def pb_fields(buf: bytes) -> dict:
    """Protobuf wire format -> {field: [values]}: varints as ints,
    length-delimited fields as bytes, fixed64 / fixed32 as their raw bytes."""
    def varint(pos: int) -> tuple:
        n = shift = 0
        while True:
            b = buf[pos]
            n |= (b & 0x7F) << shift
            pos += 1
            shift += 7
            if not b & 0x80:
                return n, pos

    out: dict = {}
    pos = 0
    while pos < len(buf):
        key, pos = varint(pos)
        wire = key & 7
        if wire == 0:
            v, pos = varint(pos)
        elif wire == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = varint(pos)
            v, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        else:
            fail(f"events: wire type {wire} in a message")
        out.setdefault(key >> 3, []).append(v)
    return out


def read_events(path: str) -> list:
    """A TensorBoard event file: each record's framing (uint64 length, its
    masked CRC32C, the data, the data's masked CRC32C) checked, each Event
    parsed (wall_time 1, step 2, file_version 3, summary 5; Summary.Value:
    tag 1, simple_value 2, image 4, tensor 8, metadata 9). Returns a dict an
    event: ``step``, ``file_version`` and ``values``, a list of (tag, kind,
    payload) with kind ``scalar`` (the float32), ``image`` (height, width,
    colorspace, png) or ``tensor`` (dtype, shape, strings, plugin)."""
    import struct

    table = _crc32c_table()
    with open(path, "rb") as f:
        buf = f.read()
    events, pos = [], 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            fail(f"events: {path} ends inside a record header at byte {pos}")
        header = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        data = buf[pos + 12:pos + 12 + n]
        tail = buf[pos + 12 + n:pos + 16 + n]
        if len(data) != n or len(tail) != 4:
            fail(f"events: {path} ends inside a record at byte {pos}")
        if hcrc != masked_crc32c(header, table) or struct.unpack("<I", tail)[0] != \
                masked_crc32c(data, table):
            fail(f"events: a bad CRC in the record at byte {pos} of {path}")
        pos += 16 + n
        ev = pb_fields(data)
        if 1 not in ev:
            fail("events: an event without wall_time")
        e = {"step": ev.get(2, [0])[0], "file_version": ev.get(3, [None])[0], "values": []}
        for summary in ev.get(5, []):
            for raw in pb_fields(summary).get(1, []):
                v = pb_fields(raw)
                tag = v[1][0].decode()
                if 2 in v:
                    e["values"].append((tag, "scalar", struct.unpack("<f", v[2][0])[0]))
                elif 4 in v:
                    img = pb_fields(v[4][0])
                    e["values"].append((tag, "image", {
                        "height": img.get(1, [0])[0], "width": img.get(2, [0])[0],
                        "colorspace": img.get(3, [0])[0], "png": img[4][0]}))
                elif 8 in v:
                    t = pb_fields(v[8][0])
                    md = pb_fields(v[9][0]) if 9 in v else {}
                    plugin = pb_fields(md[1][0])[1][0] if 1 in md else None
                    dims = pb_fields(t[2][0]).get(2, []) if 2 in t else []
                    e["values"].append((tag, "tensor", {
                        "dtype": t.get(1, [0])[0], "strings": t.get(8, []), "plugin": plugin,
                        "shape": [pb_fields(d).get(1, [0])[0] for d in dims]}))
        events.append(e)
    return events


def run_events(log_dir: str) -> tuple:
    """(run directory, its events) of the one run under ``log_dir``."""
    (run,) = os.listdir(log_dir)
    run_dir = os.path.join(log_dir, run)
    names = [f for f in os.listdir(run_dir) if f.startswith("events.out.tfevents.")]
    if len(names) != 1:
        fail(f"events: {run_dir} holds {len(names)} event files, want 1")
    events = read_events(os.path.join(run_dir, names[0]))
    if not events or events[0]["file_version"] != b"brain.Event:2":
        fail(f"events: the first record of {names[0]} is not brain.Event:2")
    return run_dir, events


def check_events(torch, tmp: str, card: str) -> dict:
    """Phase 34 (a): the event files of phase 5's lego.txt fit and of
    phase 33 (b)'s multi-scene run, read by ``read_events``: each
    ``scalar`` line of train.log has one scalar event of its tag and step
    with ``simple_value == float32(value)`` (and no other scalar event);
    each validation step's ``val/render`` a 400 x 400 RGB PNG within one
    level of that step's val PNG (the event truncates, the PNG rounds); the
    config text equal to config.txt; ``scene{i}/val_render`` of every scene
    at the multi-scene validation. Then ``MetricLogger.log_train`` and
    ``log_validation`` (a 400 x 400 render) timed on the host, median of
    ``LOG_REPS``, with events and without."""
    from nerf_tpu_torch.utils.logging import MetricLogger
    from nerf_tpu_torch.utils.png import decode_png, read_png

    run_dir, events = run_events(os.path.join(tmp, "train_logs_nerf"))
    by_kind: dict = {"scalar": {}, "image": {}, "tensor": {}}
    for e in events[1:]:
        for tag, kind, payload in e["values"]:
            by_kind[kind].setdefault((tag, e["step"]), []).append(payload)
    lines = []
    with open(os.path.join(run_dir, "train.log")) as f:
        for line in f:
            if line.startswith("scalar "):
                _, tag, step, value = line.split()
                lines.append((tag, int(step), float(value)))
    for tag, step, value in lines:
        got = by_kind["scalar"].get((tag, step), [])
        if got != [float(np.float32(value))]:
            fail(f"events: scalar {tag} at {step}: events {got}, train.log {value!r}")
    n_scalar = sum(len(v) for v in by_kind["scalar"].values())
    if n_scalar != len(lines):
        fail(f"events: {n_scalar} scalar events, {len(lines)} scalar lines in train.log")
    val_steps = sorted(int(f[4:11]) for f in os.listdir(run_dir) if f.startswith("val_"))
    if not val_steps or sorted(s for t, s in by_kind["image"] if t == "val/render") != val_steps:
        fail(f"events: val/render at {sorted(by_kind['image'])}, val PNGs at {val_steps}")
    worst = 0
    for step in val_steps:
        (img,) = by_kind["image"][("val/render", step)]
        px = decode_png(img["png"])
        want = read_png(os.path.join(run_dir, f"val_{step:07d}.png"))
        if (img["height"], img["width"], img["colorspace"]) != (HW, HW, 3) or px.shape != want.shape:
            fail(f"events: val/render at {step} is {img['height']}x{img['width']}x"
                 f"{img['colorspace']}, its PNG {px.shape}")
        worst = max(worst, int(np.abs(px.astype(np.int32) - want).max()))
    if worst > 1:
        fail(f"events: val/render differs from its val PNG by {worst} levels")
    with open(os.path.join(run_dir, "config.txt"), "rb") as f:
        config = f.read()
    text = by_kind["tensor"].get(("config/text_summary", 0), [])
    if text != [{"dtype": 7, "strings": [config], "plugin": b"text", "shape": [1]}]:
        fail("events: the config text event is not config.txt as a DT_STRING [1] of the "
             "text plugin")
    size = sum(os.path.getsize(os.path.join(run_dir, f)) for f in os.listdir(run_dir)
               if f.startswith("events.out"))
    say(f"events (34a): lego.txt fit: {len(events)} records ({size} bytes), every record's "
        f"CRCs good; {n_scalar} scalar events = the {len(lines)} scalar lines of train.log "
        f"(float32); val/render at {val_steps}, {HW}x{HW}, within {worst} level of the val "
        f"PNGs; the config text = config.txt")

    ms_dir, ms_events = run_events(os.path.join(tmp, "ms_logs"))
    ms_images = {(tag, e["step"]): p for e in ms_events for tag, kind, p in e["values"]
                 if kind == "image"}
    want = {(f"scene{i}/val_render", 100) for i in range(MS_SCENES)}
    if set(ms_images) != want or any((p["height"], p["width"]) != (HW, HW)
                                     for p in ms_images.values()):
        fail(f"events: the multi-scene run's images {sorted(ms_images)}, want {sorted(want)}")
    say(f"events (34a): the multi-scene run (33b): {len(ms_events)} records, "
        f"scene0..{MS_SCENES - 1}/val_render at 100, each {HW}x{HW}")

    image = read_png(os.path.join(run_dir, f"val_{val_steps[0]:07d}.png")).astype(
        np.float32) / 255.0
    timed = {}
    for events_on in (True, False):
        lg = MetricLogger(log_dir=os.path.join(tmp, f"logger_timing_{events_on}"),
                          config_text=config.decode(), enable_tensorboard=events_on,
                          echo=lambda *a: None)
        train_ms, val_ms = [], []
        for i in range(LOG_REPS):
            t0 = time.perf_counter()
            lg.log_train(i, 5e-4, 0.01 + i * 1e-4)
            train_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(LOG_REPS):
            t0 = time.perf_counter()
            lg.log_validation(i, 20.0 + i, image)
            val_ms.append((time.perf_counter() - t0) * 1e3)
        lg.close()
        timed[events_on] = (statistics.median(train_ms), statistics.median(val_ms))
    png_bytes = len(by_kind["image"][("val/render", val_steps[0])][0]["png"])
    say(f"events (34a): MetricLogger on the host, median of {LOG_REPS}: log_train "
        f"{timed[True][0]:.3f} ms with events ({timed[False][0]:.3f} without), "
        f"log_validation of a {HW}x{HW} render {timed[True][1]:.2f} ms with events "
        f"({timed[False][1]:.2f} without; its event's PNG {png_bytes} bytes); {card}")
    return {"log_train_ms": timed[True][0], "log_validation_ms": timed[True][1]}


def jpeg_scene(torch, dev, tmp: str, card: str) -> dict:
    """Phase 34 (b): the committed JPEG fixtures decoded on the card's host
    to their committed pixel hashes; one 1008 x 756 4:2:0 frame of the JPEG
    capture timed; configs/fern.txt at full width on that capture
    (``images/`` only) with ``llff_factor = 2``, which downsamples the
    frames to 504 x 378 on load: ``load_scene`` timed, fit() 200 iterations
    (2 row-5 launches a step, the mse at 190 under half of that at 0, 48
    row-3 launches for the validation frame) and one spiral request over
    HTTP (48 row-3 launches, within mean abs 1e-2 of the unfused render).
    Returns the launches of rows 3 and 5 and the times."""
    import dataclasses
    import hashlib

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.train.loop import fit
    from nerf_tpu_torch.utils.jpeg import read_jpeg

    with open(os.path.join(JPEG_DIR, "sha256.json")) as f:
        hashes = json.load(f)
    for name, want in sorted(hashes.items()):
        px = read_jpeg(os.path.join(JPEG_DIR, name))
        if (list(px.shape) != want["shape"]
                or hashlib.sha256(px.tobytes()).hexdigest() != want["sha256"]):
            fail(f"jpeg: {name} does not decode to its committed hash")
    say(f"jpeg (34b): {len(hashes)} fixtures decode to their committed hashes "
        f"({', '.join(sorted(hashes))})")
    scene_dir = os.path.join(JPEG_DIR, "llff")
    frame = os.path.join(scene_dir, "images", "img_000.jpg")
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        px = read_jpeg(frame)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    if px.shape != JPEG_FULL_HW + (3,):
        fail(f"jpeg: {frame} decoded to {px.shape}")
    say(f"jpeg (34b): one {JPEG_FULL_HW[1]}x{JPEG_FULL_HW[0]} 4:2:0 frame "
        f"({os.path.getsize(frame)} bytes) decoded in {statistics.median(frame_ms):.1f} ms "
        f"(median of 3: {', '.join(f'{x:.1f}' for x in frame_ms)}) on the host; {card}")

    cfg = parse_config_file(os.path.join(ROOT, "configs", "fern.txt"))
    cfg = dataclasses.replace(cfg, dataset_path=scene_dir, llff_factor=JPEG_FACTOR,
                              num_iters=FERN_ITERS, log_interval=10, val_interval=100,
                              save_interval=100, save_path=os.path.join(tmp, "jpeg_models"),
                              log_dir=os.path.join(tmp, "jpeg_logs"))
    t0 = time.perf_counter()
    scene = load_scene(cfg, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    n_views = len(os.listdir(os.path.join(scene_dir, "images")))
    if scene.hw != FERN_HW or not scene.ndc:
        fail(f"jpeg: load_scene gave hw {scene.hw}, ndc {scene.ndc}; want {FERN_HW}, NDC")
    say(f"jpeg (34b): load_scene(fern.txt, llff_factor {JPEG_FACTOR}) on {n_views} JPEG "
        f"frames of {JPEG_FULL_HW[1]}x{JPEG_FULL_HW[0]} (images/ only, downsampled to "
        f"{FERN_HW[1]}x{FERN_HW[0]}): {load_ms:.0f} ms; {card}")
    del scene

    h, w = FERN_HW
    per_frame = 2 * math.ceil(h * w / 8192)
    lines: list = []
    FusedNerfRender.launches = FusedNerfRender.train_launches = 0
    FusedNerfRender.bwd_launches = 0          # the main path's counts start here
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (FusedNerfRender.train_launches, FusedNerfRender.launches,
              FusedNerfRender.bwd_launches)
    for line in lines:
        if "[Iter" in line or "Validation" in line or "Loaded scene" in line:
            say(f"  {line}")
    if counts != (2 * FERN_ITERS, per_frame, 0):
        fail(f"jpeg: fit launched (train, forward, backward) {counts}, want "
             f"{(2 * FERN_ITERS, per_frame, 0)}")
    loss = read_scalars(cfg.log_dir)["loss"]
    last = FERN_ITERS - 10
    if not all(math.isfinite(v) for v in loss.values()) or not loss[last] < 0.5 * loss[0]:
        fail(f"jpeg: mse at {last} ({loss[last]}) is not under half of that at 0 ({loss[0]})")
    step_rps = read_scalars(cfg.log_dir)["rays_per_sec"][last]
    say(f"jpeg (34b): fit fern.txt on the JPEG capture {FERN_ITERS} iterations in "
        f"{wall:.1f} s (the scene's load included); launches: train {counts[0]} "
        f"({counts[0] // FERN_ITERS} a step), forward {counts[1]}; mse {loss[0]:.6f} at 0 -> "
        f"{loss[last]:.6f} at {last} (ratio {loss[last] / loss[0]:.4f}); step {step_rps:.0f} "
        f"rays/s; {card}")
    ckpt = os.path.join(cfg.save_path, f"nerf_model_{FERN_ITERS:06d}")
    req_ms, served, _ = serve_spiral_pose(torch, dev, cfg, ckpt, "fern.txt (JPEG capture)",
                                          card)
    return {"train_launches": counts[0], "fwd_launches": counts[1] + served,
            "frame_ms": statistics.median(frame_ms), "load_ms": load_ms,
            "request_ms": req_ms}


def phase34(torch, dev, tmp: str, card: str) -> dict:
    """Phase 34: the event files (a), JPEG frames (b)."""
    t0 = time.perf_counter()
    out = dict(check_events(torch, tmp, card), **jpeg_scene(torch, dev, tmp, card))
    say(f"phase 34: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase 35

# The NeRF family's five kernels (rows 1-5) at three of the wider shapes
# nerf_tpu's take: hidden 1024 at lego.txt's encodings (L = 10 / 4: p_pad
# 64, d_pad 32; the shape of (b)'s path) and hidden 512 and 1024 with wider
# ones (L = 12 / 6: p_pad 128, d_pad 64; h1024p128d64 is the largest
# shared-memory plan). Each shape's libraries are built from the checkout
# with its plan's -D flags (nerf_tpu_torch/ops/cuda/nerf_plan.py), in the
# background while phases 3-34 run (build_wide); hidden 512 at L = 10 / 4
# and 768 are held against the plain versions in
# tests/test_torch_port_cuda.py only (kept out of the smoke for its time).
WIDE_CASES = ((1024, 10, 4), (512, 12, 6), (1024, 12, 6))
# Row 3 at the serving chunk (8192 rays) x 64 samples: at 192 the plain
# version's activations at hidden 1024 (every layer of 1.6M samples in
# float32 kept for the comparison) would hold about 70 GB. Rows 4 and 5 at
# the training batch (1024 rays) x 64 and 192 samples (256 cut likewise),
# rows 1 and 2 at 65,536, 16,384 and 37 points (1,000 cut for time).
WIDE_FWD = (8192, 64)
WIDE_TRAIN_S = (64, 192)
WIDE_FIELD_N = (65536, 16384, 37)
WIDE_REPS = 2          # timed calls a turn (plain, kernel, kernel, plain)
# The bfloat16 field backward at hidden 512-1024 (row 2) against its plain
# version: weight gradients within 1e-1 of their max (GRAD_TOL's 5e-2 at
# 256) and the point and direction cotangents within 5e-2 at the 99.9th
# percentile with at most 5% of the points (and at least 4) beyond
# FIELD_PT_TOL's 5e-3 (0.1% and 5e-3 at 256). Wider layers put more
# bf16-rounded values on each point's path, so a float32 sum in another
# order flips more roundings, and a flip moves that point's cotangent by a
# few percent of the max: the plain version itself departs from the same
# arithmetic with float64 sums (and the same bf16 roundings) by 2.4e-3 /
# 1.2e-2 / 2.0e-2 / 2.3e-2 at the 99.9th percentile at hidden 256 / 512 /
# 768 / 1024, 0.09% / 0.31% / 0.79% / 1.32% of 16,384 points beyond 5e-3
# (plain_rounding_spread on an NVIDIA H100 80GB HBM3 at 700 W), and the
# kernel departs from the plain version by as much: 2.0e-2 / 2.6e-2 /
# 2.4e-2 on those points at 512 / 768 / 1024, up to 3.9% of 65,536 lattice
# points beyond 5e-3 and 3 of 37 points at 1024, weight gradients up to
# 8.0e-2 (b8 over 37 points at 1024; the same card).
WIDE_FIELD_TOL = {"float32": (GRAD_TOL["float32"], FIELD_PT_TOL["float32"], 0.001, 0),
                  "bfloat16": (1e-1, 5e-2, 0.05, 4)}
# The float32 field backward's weight gradients at hidden 1024: within 1e-2
# of their max (GRAD_TOL's 5e-3 at 256-768). On the 65,536 lattice points
# the plain version itself departs from the same arithmetic in float64 by
# up to 4.2e-3 (w9, L = 10 / 4) and 4.7e-3 (w6p, L = 12 / 6) of the max, and
# the kernel by 5.3e-3 (b9, L = 12 / 6; NVIDIA H100 80GB HBM3 at 700 W): a
# 1024-long float32 sum in another order moves a layer's pre-activations
# near zero across it, and a bias gradient sums its masked column over
# every point. Each run prints the plain version's distance at 1024.
WIDE_F32_GRAD_TOL = {1024: 1e-2}


def plain_rounding_spread(torch, packed, pts, dirs, cot, lp: int, ld: int) -> tuple:
    """The bf16 field backward's plain version against itself with float64
    sums (``nerf_field_bwd_plain(..., sums=torch.float64)``: the same
    encodings and rounding points): the 99.9th percentile of each point's
    cotangent error (max abs over its point and direction coordinates, each
    over its max |g|) and the share of points beyond 5e-3."""
    from nerf_tpu_torch.ops.cuda.fused_nerf import nerf_field_bwd_plain

    with torch.no_grad():
        ref = nerf_field_bwd_plain(packed, pts, dirs, cot, lp, ld)
        exact = nerf_field_bwd_plain(packed, pts, dirs, cot, lp, ld, sums=torch.float64)
    e = torch.maximum(*((ref[i] - exact[i]).abs().max(dim=1).values / exact[i].abs().max()
                        for i in (2, 3)))
    return float(torch.quantile(e, 0.999)), float((e > 5e-3).float().mean())


def wide_shapes():
    """(hidden, L, L_d, plan) of every phase-35 case."""
    from nerf_tpu_torch.ops.cuda.nerf_plan import enc_pads, plan

    return [(h, lp, ld, plan(h, *enc_pads(lp, ld))) for h, lp, ld in WIDE_CASES]


def wide_jobs(phases: tuple) -> list:
    """``build.build_shaped``'s jobs of ``phases``: phase 35's eight NeRF
    libraries, phase 36's eight SIREN libraries and phase 37's eight
    GaborNet libraries at each case's shape."""
    shapes = ((wide_shapes() if 35 in phases else [])
              + (siren_wide_shapes() if 36 in phases else [])
              + (gabor_wide_shapes() if 37 in phases else []))
    return [job for *_, pl in shapes for job in pl.builds]


def say_wide_builds(wide: list, infos) -> None:
    for (name, tag, _), info in zip(wide, infos):
        spills = [ln.strip() for ln in info.log.splitlines()
                  if "registers" in ln or "spill" in ln]
        say(f"build: {name} {tag}; " + " | ".join(spills))


def build_wide(torch, phases: tuple = (35, 36, 37), background: bool = False) -> tuple:
    """Every library at the default shape (phase 2's) and those of
    ``phases`` (``wide_jobs``), one nvcc each, all started together.
    Returns the default ones' BuildInfo. With ``background`` (the whole
    run) the wide ones run at niceness 19 and are not waited for: phase 2's
    libraries take the CPU first, and the wide ones build while phases
    3-34 run on the card (``wait_wide`` waits for them)."""
    from nerf_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    wide = wide_jobs(phases)
    if background:
        build.start_shaped(wide, nice=19)
        infos = build.build()
        say(f"build: {len(infos)} default libraries in {time.perf_counter() - t0:.1f} s, "
            f"phases {phases}' {len(wide)} NeRF, SIREN and GaborNet libraries at their "
            "wider shapes started with them at niceness 19 (one nvcc each)")
        return infos
    infos = build.build_shaped([(name, "", ()) for name in build.LIBS] + wide)
    say(f"build: phases {phases}' {len(wide)} NeRF, SIREN and GaborNet libraries at their "
        f"wider shapes in {time.perf_counter() - t0:.1f} s (with the default ones, one nvcc "
        "each, in parallel)")
    say_wide_builds(wide, infos[len(build.LIBS):])
    return infos[:len(build.LIBS)]


def wait_wide(phases: tuple = (35, 36, 37)) -> None:
    """Wait for the libraries ``build_wide(..., background=True)`` started."""
    from nerf_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    wide = wide_jobs(phases)
    infos = build.build_shaped(wide)
    say(f"build: phases {phases}' {len(wide)} libraries waited for {time.perf_counter() - t0:.1f}"
        f" s, {time.perf_counter() - T_START:.1f} s into the run")
    say_wide_builds(wide, infos)


def timed_turns(torch, fns: dict, reps: int = WIDE_REPS) -> dict:
    """Median ms of each of ``fns`` ((name, "plain" | "kernel") -> callable),
    after one warm-up call each, timed in turns plain, kernel, kernel,
    plain."""
    times = {k: [] for k in fns}
    for f in fns.values():
        f()
    for name in {k[0] for k in fns}:
        for which in ("plain", "kernel", "kernel", "plain"):
            times[(name, which)] += time_calls(torch, fns[(name, which)], reps)
    torch.cuda.empty_cache()
    return {k: statistics.median(v) for k, v in times.items()}


@dataclass
class WideFamily:
    """One family's phase (a) at its wider shapes, for check_wide_family:
    the phase, the family's word in the printed lines ("" for the NeRF),
    its rows by role ("fwd", "train", optionally "bwd", "field_fwd",
    "field_bwd"), its cases ((label, plan, setup(cdt) -> a WideCase)), the
    forward render's shapes ((R, S), the first timed and kept), the train
    pass's shapes, the field's point
    sets ((torch, dev) -> {label: (points, dirs)}) and those timed, the
    cotangent's seed a set, whether sigma is held over max(1, max |sigma|),
    and an optional prelude ((torch, dev, sets) -> None)."""

    phase: int
    word: str
    rows: dict
    cases: list
    fwd_shapes: tuple
    train_shapes: tuple
    field_sets: object
    timed_n: tuple
    cot_seed: object
    sigma_rel: bool
    prelude: object = None

    def train_key(self, name, case, cdt, s) -> tuple:
        """A train or backward row's key in the results: its S too where
        the family takes several."""
        return (name, case, cdt) + ((s,) if len(self.train_shapes) > 1 else ())


@dataclass
class WideCase:
    """One case of a WideFamily in one dtype, as its setup builds it: the
    wrappers (``fr``, ``field``), whether both take the shape, the batch of
    a row (``batch(kind, r, s)``, kind "fwd" or "train"), the rows' calls
    with ``plain`` True for the plain version (``fwd(batch)`` -> (rgb, acc,
    depth, weights); ``train(batch)`` -> (loss, rgb, acc, weights, grads,
    ...); ``bwd(batch, g_ray)`` or None; ``field_fwd(pts, dirs)``;
    ``field_bwd(pts, dirs, cot)`` -> (*grads, dpts, ddirs)), the gradient
    errors (``gerrs(got, ref)``: grad_errors over the family's layout),
    further train labels (``train_extra(got, ref)`` -> [(label, errors)]),
    the bounds (``fwd_bound(r, s)``, ``train_bound(r, s, train)``,
    ``field_bound(n, key)``) and the field's tolerances (``field_tol(n,
    label, pts, dirs, cot, ref_g)`` -> (output, gradient, point tol, the
    count's threshold, its text, points allowed beyond, printed suffix))."""

    fr: object
    field: object
    supported: bool
    batch: object
    fwd: object
    train: object
    bwd: object
    field_fwd: object
    field_bwd: object
    gerrs: object
    train_extra: object
    fwd_bound: object
    train_bound: object
    field_bound: object
    field_tol: object


def check_wide_family(torch, dev, card: str, fam: WideFamily) -> dict:
    """Phase (a) of ``fam``: its rows against their plain versions at every
    case, float32 and bfloat16, TF32 off: the forward render, the train pass
    (and the render backward where the family has one, with the two
    backward routes against each other), the field forward and backward on
    the family's point sets; every kernel launched twice for identical
    bits. Each case's ms (median of turns), its plain version's and its
    bound are printed beside the card. Returns them by (row, case, dtype)
    (the train rows also by S where there are several; the field rows by
    point count) with each row's worst error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    P, word, rows = fam.phase, fam.word, fam.rows
    results = {}
    sets = fam.field_sets(torch, dev)
    if fam.prelude is not None:
        fam.prelude(torch, dev, sets)
    for case, pl, setup in fam.cases:
        for cdt in ("float32", "bfloat16"):
            c = setup(cdt)
            if not c.supported:
                fail(f"phase {P} {case}: the kernels do not take the shape")
            tol, gtol = TOL[cdt], GRAD_TOL[cdt]

            # ---- the forward render
            name = rows["fwd"]
            for r, s in fam.fwd_shapes:
                batch = c.batch("fwd", r, s)
                timed = (r, s) == fam.fwd_shapes[0]
                with torch.no_grad():
                    ref = c.fwd(batch, plain=True)
                    out = c.fwd(batch)
                    again = c.fwd(batch)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(out, again)):
                        fail(f"phase {P} {name} {case} {cdt}: two launches differ")
                    if not all(torch.isfinite(x).all() for x in out):
                        fail(f"phase {P} {name} {case} {cdt}: non-finite output")
                    errs = {k: float((out[i] - ref[i]).abs().max())
                            for i, k in enumerate(("rgb", "acc", "depth", "weights"))}
                    del ref, out, again
                    torch.cuda.empty_cache()
                    if timed:
                        tm = timed_turns(torch, {
                            ("fwd", "plain"): lambda: c.fwd(batch, plain=True),
                            ("fwd", "kernel"): lambda: c.fwd(batch)})
                line = (f"phase {P} kernel {name} {case} {cdt} R={r} S={s} "
                        f"({c.fr.fwd_library()} {pl.tag}): max_abs_err "
                        + " ".join(f"{k}={v:.3e}(tol {tol[k]:.0e})" for k, v in errs.items()))
                if timed:
                    bms, by = c.fwd_bound(r, s)
                    line += (f" | kernel {tm['fwd', 'kernel']:.3f} ms, two launches "
                             f"bit-identical, plain {tm['fwd', 'plain']:.3f} ms, bound "
                             f"{bms:.3f} ms ({by}), share {bms / tm['fwd', 'kernel']:.4f}; "
                             f"{card}")
                    results[(name, case, cdt)] = dict(
                        err=0.0, ms=tm["fwd", "kernel"], plain_ms=tm["fwd", "plain"],
                        bound_ms=bms, bound_by=by)
                else:
                    line += ", two launches bit-identical"
                say(line)
                if any(v > tol[k] for k, v in errs.items()):
                    fail(f"phase {P} {name} {case} {cdt} disagrees: {errs}")
                entry = results[(name, case, cdt)]
                entry["err"] = max(entry["err"], *errs.values())

            # ---- the train pass (and the render backward)
            for r, s in fam.train_shapes:
                batch = c.batch("train", r, s)
                with torch.no_grad():
                    ref = c.train(batch, plain=True)
                    got = c.train(batch)
                    again = c.train(batch)
                    torch.cuda.synchronize()
                    flat = [x for x in got[:4] + tuple(got[4]) + tuple(got[5:])]
                    flat2 = [x for x in again[:4] + tuple(again[4]) + tuple(again[5:])]
                    if not all(torch.equal(x, y) for x, y in zip(flat, flat2)):
                        fail(f"phase {P} train {case} {cdt} S={s}: two launches differ")
                    del again, flat, flat2
                    errs = {"loss": float(abs(got[0] - ref[0]) / abs(ref[0]))}
                    for i, k in ((1, "rgb"), (2, "acc"), (3, "weights")):
                        if not torch.isfinite(got[i]).all():
                            fail(f"phase {P} train {case} {cdt} S={s}: non-finite {k}")
                        errs[k] = float((got[i] - ref[i]).abs().max())
                    labels = [("train", c.gerrs(got[4], ref[4]))] + c.train_extra(got, ref)
                    fns = {("train", "plain"): lambda: c.train(batch, plain=True),
                           ("train", "kernel"): lambda: c.train(batch)}
                    if c.bwd is not None:
                        g_ray = torch.zeros(r, 8, device=dev)
                        g_ray[:, :3] = 2.0 / (3.0 * r) * (ref[1] + (1.0 - ref[2])[:, None]
                                                          - batch[3])
                        g_ray[:, 3] = -g_ray[:, :3].sum(-1)
                        ref_b = c.bwd(batch, g_ray, plain=True)
                        got_b = c.bwd(batch, g_ray)
                        again_b = c.bwd(batch, g_ray)
                        torch.cuda.synchronize()
                        if not all(torch.equal(x, y) for x, y in zip(got_b, again_b)):
                            fail(f"phase {P} render backward {case} {cdt} S={s}: two "
                                 "launches differ")
                        labels += [("bwd", c.gerrs(got_b, ref_b)),
                                   ("bwd vs train", c.gerrs(got_b, got[4]))]
                        del ref_b, got_b, again_b
                        fns.update({("bwd", "plain"): lambda: c.bwd(batch, g_ray, plain=True),
                                    ("bwd", "kernel"): lambda: c.bwd(batch, g_ray)})
                    del ref, got
                    torch.cuda.empty_cache()
                    tm = timed_turns(torch, fns)
                bad = {k: v for k, v in errs.items() if v > tol["rgb"]}
                for label, e in labels:
                    worst = max(e, key=e.get)
                    say(f"phase {P} kernel {word}{label} {case} {cdt} R={r} S={s}: gradient "
                        f"error worst {worst}={e[worst]:.3e} (tol {gtol:.0e}), median "
                        f"{statistics.median(e.values()):.3e}")
                    bad.update({f"{label}:{k}": v for k, v in e.items() if v > gtol})
                say(f"phase {P} kernel {word}train {case} {cdt} R={r} S={s}: "
                    + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                    + f" (tol {tol['rgb']:.0e}); two launches of each bit-identical")
                worst = {"train": max([v for lab, e in labels
                                        if lab not in ("bwd", "bwd vs train")
                                        for v in e.values()] + list(errs.values())),
                         "bwd": max(dict(labels).get("bwd", {0: 0.0}).values())}
                for key in ("train", "bwd"):
                    if key not in rows:
                        continue
                    name = rows[key]
                    bms, by = c.train_bound(r, s, key == "train")
                    ms, plain_ms = tm[key, "kernel"], tm[key, "plain"]
                    say(f"phase {P} kernel {name} {case} {cdt} R={r} S={s} "
                        f"({c.fr.grad_library(key == 'train')} {pl.tag}): kernel {ms:.3f} ms, "
                        f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), share "
                        f"{bms / ms:.4f}; {card}")
                    results[fam.train_key(name, case, cdt, s)] = dict(
                        err=worst[key], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
                if bad:
                    fail(f"phase {P} train/backward {case} {cdt} S={s} disagree: {bad}")

            # ---- the field forward and backward
            for label, (pts, dirs) in sets.items():
                n = pts.shape[0]
                cot = torch.randn(n, 4, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(
                                      fam.cot_seed(n)))
                with torch.no_grad():
                    ref = c.field_fwd(pts, dirs, plain=True)
                    out = c.field_fwd(pts, dirs)
                    again = c.field_fwd(pts, dirs)
                    ref_g = c.field_bwd(pts, dirs, cot, plain=True)
                    got_g = c.field_bwd(pts, dirs, cot)
                    again_g = c.field_bwd(pts, dirs, cot)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(tuple(out) + tuple(got_g),
                                                                 tuple(again) + tuple(again_g))):
                        fail(f"phase {P} {word}field {case} {cdt} {label}: two launches differ")
                    del again, again_g
                for x in tuple(out) + tuple(got_g):
                    if not torch.isfinite(x).all():
                        fail(f"phase {P} {word}field {case} {cdt} {label}: non-finite output")
                smax = max(float(ref[1].abs().max()), 1.0) if fam.sigma_rel else 1.0
                errs = {"rgb": float((out[0] - ref[0]).abs().max()),
                        "sigma": float((out[1] - ref[1]).abs().max()) / smax}
                gerr = c.gerrs(got_g[:-2], ref_g[:-2])
                w = max(gerr, key=gerr.get)
                tol_out, ftol, ptol, beyond, beyond_text, allowed, suffix = c.field_tol(
                    n, label, pts, dirs, cot, ref_g)
                pt, bad_pts = {}, 0
                for k, g_got, g_ref in (("points", got_g[-2], ref_g[-2]),
                                        ("dirs", got_g[-1], ref_g[-1])):
                    e = (g_got - g_ref).abs().max(dim=1).values / g_ref.abs().max()
                    pt[k] = float(torch.quantile(e, 0.999))
                    bad_pts = max(bad_pts, int((e > beyond).sum()))
                sigma_text = (f"sigma={errs['sigma']:.3e} (over max(1, max sigma) = "
                              f"{smax:.3g}; tol {tol_out:.0e})" if fam.sigma_rel else
                              f"sigma={errs['sigma']:.3e} (tol {tol_out:.0e})")
                say(f"phase {P} kernel {word or 'nerf '}field {case} {cdt} {label}: forward "
                    f"rgb={errs['rgb']:.3e} {sigma_text}; weight gradient worst "
                    f"{w}={gerr[w]:.3e} (tol {ftol:.0e}); point / direction cotangent 99.9% "
                    f"{pt['points']:.3e} / {pt['dirs']:.3e} (tol {ptol:.0e}), {bad_pts} points "
                    f"beyond {beyond_text} (at most {allowed:.0f}); two launches of each "
                    f"bit-identical{suffix}")
                if (max(errs.values()) > tol_out or gerr[w] > ftol
                        or max(pt.values()) > ptol or bad_pts > allowed):
                    fail(f"phase {P} {word or 'nerf '}field {case} {cdt} {label} disagrees with "
                         "its plain versions")
                for name, e in ((rows["field_fwd"], max(errs.values())),
                                (rows["field_bwd"], max(gerr[w], *pt.values()))):
                    entry = results.setdefault((name, case, cdt), {"err": 0.0})
                    entry["err"] = max(entry["err"], e)
                del ref, out, ref_g, got_g
                torch.cuda.empty_cache()
                if n not in fam.timed_n:
                    continue
                with torch.no_grad():
                    tm = timed_turns(torch, {
                        ("fwd", "plain"): lambda: c.field_fwd(pts, dirs, plain=True),
                        ("fwd", "kernel"): lambda: c.field_fwd(pts, dirs),
                        ("bwd", "plain"): lambda: c.field_bwd(pts, dirs, cot, plain=True),
                        ("bwd", "kernel"): lambda: c.field_bwd(pts, dirs, cot)})
                for name, key in ((rows["field_fwd"], "fwd"), (rows["field_bwd"], "bwd")):
                    bms, by = c.field_bound(n, key)
                    ms, plain_ms = tm[key, "kernel"], tm[key, "plain"]
                    say(f"phase {P} kernel {name} {case} {cdt} {label} "
                        f"({getattr(c.field, key + '_library')()} {pl.tag}): kernel {ms:.3f} "
                        f"ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), share "
                        f"{bms / ms:.4f}; {card}")
                    results[(name, case, cdt)][n] = dict(ms=ms, plain_ms=plain_ms,
                                                         bound_ms=bms, bound_by=by)
            del c
            torch.cuda.empty_cache()
    say(f"phase {P} (a): {time.perf_counter() - t_phase:.1f} s")
    return results


def family_wide_rows(fam: WideFamily, wide: dict, launched: dict) -> dict:
    """A family's rows at its phase-(a) shapes, by row: each case's time,
    plain time, bound and error (bfloat16 and float32; the train rows at
    the family's last train shape, the fields at their largest timed point
    set) and its launches on the phase's main path (``launched``, by (row,
    plan tag, dtype), as the wrappers counted them)."""
    out = {}
    s = fam.train_shapes[-1][1]
    n = max(fam.timed_n)
    for case, pl, _ in fam.cases:
        for role, name in fam.rows.items():
            for cdt in ("bfloat16", "float32"):
                if role.startswith("field"):
                    c = dict(wide[(name, case, cdt)][n], err=wide[(name, case, cdt)]["err"])
                else:
                    c = wide[fam.train_key(name, case, cdt, s) if role in ("train", "bwd")
                             else (name, case, cdt)]
                out.setdefault(name, {})[f"{pl.tag} {cdt}"] = {
                    "launches": launched.get((name, pl.tag, cdt), 0),
                    "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"]}
    return out


def nerf_wide_family(torch, dev) -> WideFamily:
    """Phase 35 (a): rows 1-5 at every WIDE_CASES shape under the
    tolerances of phases 3 and 17 (TOL, GRAD_TOL, FIELD_PT_TOL; the bf16
    field backward under WIDE_FIELD_TOL, beside the plain version's own
    spread from float64 sums): the forward render (8192 x 64), the train
    pass and the render backward (1024 x 64 and 192), the field forward and
    backward (65,536, 16,384 and 37 points); bounds from mlp_macs at the
    case's widths."""
    from nerf_tpu_torch.models.nerf import NeRFModel
    from nerf_tpu_torch.ops.cuda.fused_nerf import (
        NerfField, nerf_field_bwd_plain, nerf_field_plain)
    from nerf_tpu_torch.ops.cuda.fused_render import (
        FusedNerfRender, fused_render_bwd_plain, fused_render_plain, fused_train_plain,
        pack_f32)

    def sets(torch, dev):
        return {k: v for k, v in field_point_sets(torch, dev).items()
                if v[0].shape[0] in WIDE_FIELD_N}

    def prelude(torch, dev, sets):
        if "uniform 16384" not in sets:
            return
        # the bf16 field backward's own rounding spread at hidden 256, beside
        # the wider widths' (WIDE_FIELD_TOL)
        pts, dirs = sets["uniform 16384"]
        model = NeRFModel(compute_dtype="bfloat16",
                          generator=torch.Generator().manual_seed(35)).to(dev)
        with torch.no_grad():
            fpacked = NerfField(model).cast(*pack_f32(model))
        cot = torch.randn(16384, 4, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(16384))
        q, frac = plain_rounding_spread(torch, fpacked, pts, dirs, cot, 10, 4)
        say(f"phase 35 nerf field h256 L10/4 bfloat16 uniform 16384: the plain version "
            f"against its float64 sums: 99.9% {q:.3e}, {frac:.4f} of the points beyond 5e-3")

    def setup(h, lp, ld):
        real_p, real_d = 3 * (1 + 2 * lp), 3 * (1 + 2 * ld)
        macs = mlp_macs(h, real_p, real_d)
        skipped = 2 * h * real_p + (h // 2) * real_d

        def make(cdt):
            model = NeRFModel(hidden_dim=h, pos_encoding_dim=lp, dir_encoding_dim=ld,
                              compute_dtype=cdt,
                              generator=torch.Generator().manual_seed(35)).to(dev)
            fr = FusedNerfRender(model, 2.0, 6.0, normalize=True)
            field = NerfField(model)
            with torch.no_grad():
                packed = fr.pack(model)
                fpacked = field.cast(*pack_f32(model))
            weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                            + packed.vec.numel() * 4)
            grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4

            def batch(kind, r, s):
                cam, rd, t, tgt = camera_batch(torch, dev, r, s,
                                               (3500 if kind == "fwd" else 3600) + s)
                return (cam, rd, t, tgt, *fr.affine(cam, rd))

            def fwd(b, plain=False):
                cam, rd, t, _, o_aff, d_aff = b
                if plain:
                    return fused_render_plain(packed, o_aff, d_aff, rd, t, lp, ld)
                return tuple(fr(packed, cam, rd, rd, t).values())

            def train(b, plain=False):
                _, rd, t, tgt, o_aff, d_aff = b
                if plain:
                    return fused_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, lp, ld)
                return fr._train(packed, o_aff, d_aff, rd, t, tgt, True)

            def bwd(b, g_ray, plain=False):
                _, rd, t, _, o_aff, d_aff = b
                if plain:
                    return fused_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, lp, ld)
                return fr._backward(packed, o_aff, d_aff, rd, t, g_ray)

            def gerrs(got, ref):
                return grad_errors(torch, got, ref, hidden=h, pads=fr.pads)

            def field_tol(n, label, pts, dirs, cot, ref_g):
                ftol, ptol, share, least = WIDE_FIELD_TOL[cdt]
                own = spread = ""
                if cdt == "float32" and h in WIDE_F32_GRAD_TOL:
                    ftol = WIDE_F32_GRAD_TOL[h]
                    if n == 65536:
                        with torch.no_grad():
                            exact = nerf_field_bwd_plain(fpacked, pts, dirs, cot, lp, ld,
                                                         sums=torch.float64)
                        e_own = gerrs(ref_g[:2], exact[:2])
                        w_own = max(e_own, key=e_own.get)
                        own = (f"; the plain version's weight gradients against their "
                               f"float64 sums: worst {w_own}={e_own[w_own]:.3e}")
                if cdt == "bfloat16" and n == 16384:
                    q, frac = plain_rounding_spread(torch, fpacked, pts, dirs, cot, lp, ld)
                    spread = (f"; the plain version against its float64 sums: 99.9% {q:.3e}, "
                              f"{frac:.4f} of the points beyond 5e-3")
                return (TOL[cdt]["rgb"], ftol, ptol, FIELD_PT_TOL[cdt],
                        f"{FIELD_PT_TOL[cdt]:.0e}", max(share * n, least), spread + own)

            return WideCase(
                fr=fr, field=field, supported=fr.supported() and field.supported(),
                batch=batch, fwd=fwd, train=train, bwd=bwd,
                field_fwd=lambda pts, dirs, plain=False: (
                    nerf_field_plain(fpacked, pts, dirs, lp, ld) if plain
                    else field._forward(fpacked, pts, dirs)),
                field_bwd=lambda pts, dirs, cot, plain=False: (
                    nerf_field_bwd_plain(fpacked, pts, dirs, cot, lp, ld) if plain
                    else field._backward(fpacked, pts, dirs, cot)),
                gerrs=gerrs, train_extra=lambda got, ref: [],
                fwd_bound=lambda r, s: bound_ms(r, s, cdt, weight_bytes, macs),
                train_bound=lambda r, s, train: bound_ms(
                    r, s, cdt, weight_bytes, 3 * macs - skipped, grad_bytes=grad_bytes,
                    train=train),
                field_bound=lambda n, key: field_bound_ms(
                    n, cdt, weight_bytes, grad_bytes if key == "bwd" else None, macs=macs),
                field_tol=field_tol)

        return make

    return WideFamily(
        phase=35, word="", rows=dict(fwd="fused_render_fwd", train="fused_render_train",
                                     bwd="fused_render_bwd", field_fwd="fused_nerf_fwd",
                                     field_bwd="fused_nerf_bwd"),
        cases=[(f"h{h} L{lp}/{ld}", pl, setup(h, lp, ld)) for h, lp, ld, pl in wide_shapes()],
        fwd_shapes=(WIDE_FWD,), train_shapes=tuple((R_TRAIN, s) for s in WIDE_TRAIN_S),
        field_sets=sets, timed_n=(65536, 16384), cot_seed=lambda n: n, sigma_rel=False,
        prelude=prelude)


WIDE_LEGO_H = 1024     # (b): lego.txt at hidden 1024 (mip-NeRF 360's NeRF MLP width)
WIDE_ITERS = 40        # (b): fit() iterations
WIDE_SAVE = 20         # (b): the checkpoint a resume starts from (to WIDE_SAVE + 10)
WIDE_DISTILL = 20      # (c): distillation steps of 16,384 points
WIDE_TUNE = 10         # (c): photometric iterations after them
# the wrappers' counters (FusedNerfRender's, NerfField's) by row
WIDE_COUNTERS = {"FusedNerfRender": {"launches": "fused_render_fwd",
                                     "train_launches": "fused_render_train",
                                     "bwd_launches": "fused_render_bwd"},
                 "NerfField": {"launches": "fused_nerf_fwd", "bwd_launches": "fused_nerf_bwd"}}


def wide_lego(torch, dev, tmp: str, card: str) -> dict:
    """Phase 35 (b): configs/lego.txt at hidden_dim = 1024 (bfloat16, 64 +
    128 samples, 1024 rays), written as the phase's own config, on the
    synthetic 400 x 400 scene: fit() WIDE_ITERS iterations (two train-pass
    launches a step; the mse falls), a resume from WIDE_SAVE bit for bit,
    two steps of the render route (the forward render and its backward
    kernel), the checkpoint served with --occupancy 64 (the bake's four
    field launches at 1024; the request within mean abs 1e-2 of the unfused
    render) and one eval CLI frame (within mean abs 1e-2 of the unfused
    render); then (c) fit() with distill_from = that checkpoint: nerf_tpu's
    load_teacher builds the teacher over the student's config, so teacher
    and student are both at 1024 (WIDE_DISTILL distillation steps: the
    teacher's field forward, the student's forward and backward; the loss
    falls), then WIDE_TUNE photometric iterations. Returns the launches of
    rows 1-5 by (row, plan tag, dtype) as the wrappers counted them
    (``shape_launches``), every one at hidden 1024 in bfloat16."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.data.poses import spherical_orbit
    from nerf_tpu_torch.ops.cuda.fused_nerf import NerfField
    from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
    from nerf_tpu_torch.ops.cuda.nerf_plan import enc_pads, plan
    from nerf_tpu_torch.render.renderer import render_rays
    from nerf_tpu_torch.serve import RenderService
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    scene = os.path.join(tmp, "scene")
    if not os.path.isdir(scene):
        write_sphere_scene(scene, HW)
    label = f"lego.txt at hidden {WIDE_LEGO_H}"
    path = write_eval_config(
        tmp, "lego.txt", f"lego_h{WIDE_LEGO_H}.txt", hidden_dim=WIDE_LEGO_H,
        num_iters=WIDE_ITERS, log_interval=10, val_interval=10 * WIDE_ITERS,
        save_interval=WIDE_SAVE, save_path=os.path.join(tmp, "wide_models"),
        log_dir=os.path.join(tmp, "wide_logs"), num_render_poses=1)
    cfg = parse_config_file(path)
    if (cfg.hidden_dim, cfg.compute_dtype, cfg.num_samples, cfg.num_fine_samples,
            cfg.num_random_rays) != (WIDE_LEGO_H, "bfloat16", 64, 128, 1024):
        fail(f"phase 35 config: {cfg}")
    lines: list = []
    FusedNerfRender.launches = FusedNerfRender.train_launches = 0
    FusedNerfRender.bwd_launches = 0           # the main path's counts start here
    FusedNerfRender.shape_launches.clear()
    NerfField.shape_launches.clear()
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (FusedNerfRender.train_launches, FusedNerfRender.launches,
              FusedNerfRender.bwd_launches)
    for line in lines:
        if "[Iter" in line:
            say(f"  {line}")
    if counts != (2 * WIDE_ITERS, 0, 0):
        fail(f"phase 35 fit {label} launched (train, forward, backward) {counts}")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    last = max(loss)
    if not all(math.isfinite(v) for v in loss.values()) or not loss[last] < loss[0]:
        fail(f"phase 35 {label}: the mse does not fall ({loss})")
    say(f"phase 35 train: fit {label} {WIDE_ITERS} iterations in {wall:.1f} s, "
        f"{counts[0]} train-pass launches; mse {loss[0]:.6f} at 0 -> {loss[last]:.6f} at "
        f"{last} (ratio {loss[last] / loss[0]:.4f}); step {scal['rays_per_sec'][last]:.0f} "
        f"rays/s; {card}")
    check_resume(torch, dev, tmp, cfg, "nerf", loss, tag="wide", at=WIDE_SAVE,
                 until=WIDE_SAVE + 10)

    # the render route: the forward render and its backward kernel at 1024
    ckpt = os.path.join(cfg.save_path, f"nerf_model_{WIDE_ITERS:06d}")
    state = create_train_state(cfg, device=dev)
    data = load_scene(cfg, device=dev)
    settings = render_settings_from_config(cfg)
    fr = FusedNerfRender(state.params, cfg.near, cfg.far)
    FusedNerfRender.launches = FusedNerfRender.bwd_launches = 0
    mses = []
    for i in range(2):
        g = torch.Generator(device=dev).manual_seed(cfg.seed + i)
        batch = data.pool.sample(g, cfg.num_random_rays)
        for m in state.models():
            m.zero_grad(set_to_none=True)
        out = render_rays(state.params, batch.rays_o, batch.rays_d, settings, generator=g,
                          fine_params=state.fine_params, viewdirs=batch.viewdirs,
                          fused_render=fr)
        mse = torch.mean((out.rgb - batch.rgb) ** 2)
        (mse + torch.mean((out.rgb_coarse - batch.rgb) ** 2)).backward()
        state.optimizer.step()
        mses.append(float(mse.detach()))
    counts = (FusedNerfRender.launches, FusedNerfRender.bwd_launches)
    say(f"phase 35 train: {label} render route 2 steps, mse {mses}; launches forward "
        f"{counts[0]}, backward {counts[1]}")
    if counts != (4, 4) or not all(math.isfinite(v) for v in mses):
        fail(f"phase 35 {label} render route launched {counts}, want (4, 4)")
    del state, data, out
    torch.cuda.empty_cache()

    # served with --occupancy 64: the bake through row 1 at 1024
    NerfField.launches = 0
    svc = RenderService.from_checkpoint(cfg, ckpt, occupancy=64, device=dev, log=say)
    if NerfField.launches != 4:
        fail(f"phase 35 --occupancy 64 bake: {NerfField.launches} field launches, want 4")
    serve(torch, dev, tmp, label, FusedNerfRender, "fused_render_fwd", svc=svc,
          compare=("/pose/1",), routes=("/pose/1",))
    del svc
    torch.cuda.empty_cache()

    # one eval CLI frame
    out_dir = os.path.join(tmp, "wide_eval")
    res = run_eval_cli(["--config", path, "--checkpoint", ckpt, "--output", out_dir],
                       {"nerf": FusedNerfRender}, f"phase 35 {label}")
    per_image = 2 * math.ceil(HW * HW / cfg.chunk_size)
    if res["per_frame"]["nerf"] != [per_image]:
        fail(f"phase 35 eval: launches a frame {res['per_frame']['nerf']}, want [{per_image}]")
    ref = RenderService.from_checkpoint(dataclasses.replace(cfg, use_pallas=False), ckpt,
                                        device=dev, log=lambda *a: None)
    frame = read_png(os.path.join(out_dir, "frame_0000.png"))
    diff = np.abs(frame.astype(np.float32) / 255.0
                  - ref.render_pose(spherical_orbit(1)[0], key_idx=0))
    say(f"phase 35 eval {label} frame 0 vs the unfused render: mean abs {diff.mean():.3e} "
        f"(tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}; {res['ms'][0]:.1f} ms")
    if not diff.mean() <= SERVE_TOL_MEAN:
        fail("phase 35 eval: the frame disagrees with the unfused render")
    del ref
    torch.cuda.empty_cache()

    # (c) fit() distilling that checkpoint into a seeded student first
    dcfg = dataclasses.replace(
        cfg, num_iters=WIDE_TUNE, distill_from=ckpt, distill_steps=WIDE_DISTILL,
        distill_batch=16384, save_path=os.path.join(tmp, "wide_distill_models"),
        log_dir=os.path.join(tmp, "wide_distill_logs"))
    lines = []
    NerfField.launches = NerfField.bwd_launches = 0
    FusedNerfRender.launches = FusedNerfRender.train_launches = 0
    FusedNerfRender.bwd_launches = 0
    t0 = time.perf_counter()
    fit(dcfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (NerfField.launches, NerfField.bwd_launches)
    render = (FusedNerfRender.train_launches, FusedNerfRender.launches,
              FusedNerfRender.bwd_launches)
    for line in lines:
        if "Distill" in line:
            say(f"  {line}")
    dl = read_scalars(dcfg.log_dir).get("distill_loss", {})
    say(f"phase 35 distill: fit {label} with distill_from the hidden-{WIDE_LEGO_H} "
        f"checkpoint, {WIDE_DISTILL} steps of 16384 points, then {WIDE_TUNE} iterations, in "
        f"{wall:.1f} s; loss {dl.get(0)} at 0 -> {dl.get(WIDE_DISTILL - 1)} at "
        f"{WIDE_DISTILL - 1}; field launches forward {counts[0]} (teacher and student), "
        f"backward {counts[1]}; render train {render[0]}")
    if counts != (2 * WIDE_DISTILL, WIDE_DISTILL) or render != (2 * WIDE_TUNE, 0, 0):
        fail(f"phase 35 distillation: field launches {counts}, want ({2 * WIDE_DISTILL}, "
             f"{WIDE_DISTILL}); render (train, forward, backward) {render}")
    if sorted(dl) != list(range(WIDE_DISTILL)) or not dl[WIDE_DISTILL - 1] < dl[0]:
        fail(f"phase 35 distillation: the loss does not fall ({dl})")

    # rows 1-5 by shape, as the wrappers counted them through (b) and (c)
    launched = {(WIDE_COUNTERS[cls.__name__][counter], tag, cdt): n
                for cls in (FusedNerfRender, NerfField)
                for (counter, tag, cdt), n in cls.shape_launches.items()}
    say(f"phase 35 (b)-(c) launches by shape: "
        + ", ".join(f"{k[0]} {k[1]} {k[2]} {n}" for k, n in sorted(launched.items())))
    tag = plan(WIDE_LEGO_H, *enc_pads(cfg.pos_encoding_dim, cfg.dir_encoding_dim)).tag
    rows = [r for by_counter in WIDE_COUNTERS.values() for r in by_counter.values()]
    if (set(launched) != {(r, tag, "bfloat16") for r in rows}
            or min(launched.values()) < 1):
        fail(f"phase 35 (b)-(c): want every one of rows 1-5 at {tag} bfloat16 and no other "
             f"shape, launched {launched}")
    say(f"phase 35 (b)-(c): {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------- phase 36

# The SIREN family's five kernels (rows 6-10) at two of the wider shapes
# nerf_tpu's take: hidden 1024 at lego_siren.txt's direction encoding (L_d
# = 4: d_pad 32) and hidden 512 with L_d = 6 (d_pad 64). Each shape's
# libraries are built from the checkout with its plan's -D flags
# (nerf_tpu_torch/ops/cuda/siren_plan.py); tests/test_torch_port_cuda.py
# holds every shape the kernels take (512 at L_d = 4 and 768 too) against
# the plain versions. Row 6 at lego_siren.txt's serving chunk and rows 7-8 at its
# training batch (1024 rays x 256 samples), rows 9-10 at a bake's 65,536
# lattice points; the tolerances of phases 7 and 20 (TOL, GRAD_TOL; SG_TOL
# for the bf16 field, FIELD_PT_TOL for the f32 one's cotangents).
SIREN_WIDE_CASES = ((1024, 4), (512, 6))
SIREN_WIDE_FIELD = "lattice 65536"
SIREN_WIDE_H = 1024      # (b): lego_siren.txt at hidden 1024
SIREN_WIDE_ITERS = 40    # (b): fit() iterations (a step ~0.15 s at 1024)
SIREN_WIDE_SAVE = 20     # (b): the checkpoint a resume starts from (to SAVE + 10)
SIREN_WIDE_DISTILL = 20  # (c): distillation steps of 16,384 points
SIREN_WIDE_TUNE = 10     # (c): photometric iterations after them
# the wrappers' counters (FusedSirenRender's, SirenField's) by row
SIREN_WIDE_COUNTERS = {"FusedSirenRender": {"launches": "fused_render_siren_fwd",
                                            "train_launches": "fused_render_siren_train",
                                            "bwd_launches": "fused_render_siren_bwd"},
                       "SirenField": {"launches": "fused_siren_fwd",
                                      "bwd_launches": "fused_siren_bwd"}}
SIREN_WIDE_ROW_ROLES = dict(fwd="fused_render_siren_fwd", train="fused_render_siren_train",
                            bwd="fused_render_siren_bwd", field_fwd="fused_siren_fwd",
                            field_bwd="fused_siren_bwd")


def siren_wide_shapes():
    """(hidden, L_d, plan) of every phase-36 case."""
    from nerf_tpu_torch.ops.cuda.siren_plan import d_pad, plan

    return [(h, ld, plan(h, d_pad(ld))) for h, ld in SIREN_WIDE_CASES]


def siren_wide_family(torch, dev) -> WideFamily:
    """Phase 36 (a): rows 6-10 at every SIREN_WIDE_CASES shape under the
    tolerances of phases 7 and 20: the forward render, the train pass and
    the render backward at 1024 x 256, the field forward and backward at
    65,536 lattice points; bounds from siren_macs at the case's widths."""
    from nerf_tpu_torch.models.siren import SirenModel
    from nerf_tpu_torch.ops.cuda.fused_render_siren import (
        FusedSirenRender, fused_siren_render_bwd_plain, fused_siren_render_plain,
        fused_siren_train_plain, grad_views)
    from nerf_tpu_torch.ops.cuda.fused_siren import (
        SirenField, siren_field_bwd_plain, siren_field_plain)

    def setup(h, ld, pl):
        real_d = 3 * (1 + 2 * ld)
        macs, trig = siren_macs(h, real_d), siren_trig(h)

        def make(cdt):
            model = SirenModel(hidden_dim=h, dir_encoding_dim=ld, compute_dtype=cdt,
                               generator=torch.Generator().manual_seed(36)).to(dev)
            fr = FusedSirenRender(model, 2.0, 6.0, normalize=True)
            field = SirenField(model).pack()
            pk, k = field.packed, fr.consts
            with torch.no_grad():
                packed = fr.pack(model)
            weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                            + packed.vec.numel() * 4)
            grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4

            def batch(kind, r, s):
                cam, rd, t, tgt = camera_batch(torch, dev, r, s, 3600 + h + ld)
                return (cam, rd, t, tgt, *fr.affine(cam, rd))

            def fwd(b, plain=False):
                _, rd, t, _, o_aff, d_aff = b
                if plain:
                    return fused_siren_render_plain(packed, o_aff, d_aff, rd, t, k)
                return fr._forward(packed, o_aff, d_aff, rd, t)

            def train(b, plain=False):
                _, rd, t, tgt, o_aff, d_aff = b
                if plain:
                    return fused_siren_train_plain(packed, o_aff, d_aff, rd, t, tgt, True, k)
                return fr._train(packed, o_aff, d_aff, rd, t, tgt, True)

            def bwd(b, g_ray, plain=False):
                _, rd, t, _, o_aff, d_aff = b
                if plain:
                    return fused_siren_render_bwd_plain(packed, o_aff, d_aff, rd, t, g_ray, k)
                return fr._backward(packed, o_aff, d_aff, rd, t, g_ray)

            def field_tol(n, *_):
                tol_out, tol_grad, tol_pt = SG_TOL.get(
                    ("siren", cdt), (TOL[cdt]["rgb"], GRAD_TOL[cdt], FIELD_PT_TOL[cdt]))
                return tol_out, tol_grad, tol_pt, tol_pt, "it", 0.001 * n, ""

            return WideCase(
                fr=fr, field=field,
                supported=fr.supported() and field.supported() and fr.plan == pl,
                batch=batch, fwd=fwd, train=train, bwd=bwd,
                field_fwd=lambda pts, dirs, plain=False: (
                    siren_field_plain(pk, pts, dirs, k) if plain
                    else field._forward(pk, pts, dirs)),
                field_bwd=lambda pts, dirs, cot, plain=False: (
                    siren_field_bwd_plain(pk, pts, dirs, cot, k) if plain
                    else field._backward(pk, pts, dirs, cot)),
                gerrs=lambda got, ref: grad_errors(torch, got, ref, grad_views, hidden=h,
                                                   pads=(fr.d_pad,)),
                train_extra=lambda got, ref: [],
                fwd_bound=lambda r, s: bound_ms(r, s, cdt, weight_bytes, macs, trig),
                train_bound=lambda r, s, train: bound_ms(
                    r, s, cdt, weight_bytes, 3 * macs - siren_skipped(h, real_d), 2 * trig,
                    grad_bytes, train),
                field_bound=lambda n, key: field_bound_ms(
                    n, cdt, weight_bytes, grad_bytes if key == "bwd" else None, "siren",
                    cost=siren_field_cost(h, real_d)),
                field_tol=field_tol)

        return make

    return WideFamily(
        phase=36, word="siren ", rows=SIREN_WIDE_ROW_ROLES,
        cases=[(f"h{h} L_d{ld}", pl, setup(h, ld, pl)) for h, ld, pl in siren_wide_shapes()],
        fwd_shapes=((R_SIREN, S_SIREN),), train_shapes=((R_TRAIN, S_SIREN),),
        field_sets=lambda torch, dev: {
            SIREN_WIDE_FIELD: field_point_sets(torch, dev)[SIREN_WIDE_FIELD]},
        timed_n=(65536,), cot_seed=lambda n: 36, sigma_rel=True)


def gabor_wide_family(torch, dev) -> WideFamily:
    """Phase 37 (a): rows 11-14 at every GABOR_WIDE_CASES shape under the
    tolerances of phases 10 and 20 (TOL, GRAD_TOL, FIELD_PT_TOL; dA..dR as
    phase 10 holds them): the forward render and the train pass at
    lego_siren.txt's 1024 x 256 and at 1024 x 37 (rays that span a chunk),
    the field forward and backward at 65,536 lattice points and 37 points;
    bounds from gabor_macs at the case's widths and depth, the per-ray
    coefficients read (and their cotangents written) beside the weights; the
    render rows' plain versions over GABOR_PLAIN_RAYS rays a call."""
    from nerf_tpu_torch.models.gabor import GaborModel
    from nerf_tpu_torch.ops.cuda.fused_gabor import (
        GaborField, gabor_field_bwd_plain, gabor_field_plain)
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import (
        FusedGaborRender, fused_gabor_render_plain, fused_gabor_train_plain, gabor_coeffs,
        grad_views)

    def setup(h, ld, n, pl):
        real_d = 3 * (1 + 2 * ld)
        macs, trig, coef = gabor_macs(h, n, real_d), gabor_trig(h, n), gabor_coef_bytes(h, n)

        def make(cdt):
            model = GaborModel(hidden_dim=h, dir_encoding_dim=ld, num_layers=n,
                               compute_dtype=cdt,
                               generator=torch.Generator().manual_seed(37)).to(dev)
            fr = FusedGaborRender(model, 2.0, 6.0, normalize=True)
            field = GaborField(model).pack()
            pk, k = field.packed, fr.consts
            gpack = fr.pack(model)
            packed = gpack.packed
            weight_bytes = (packed.wmat.numel() * packed.wmat.element_size()
                            + packed.vec.numel() * 4)
            grad_bytes = (packed.wmat.numel() + packed.vec.numel()) * 4

            def batch(kind, r, s):
                cam, rd, t, tgt = camera_batch(torch, dev, r, s, 3700 + h + ld + n + s)
                with torch.no_grad():
                    coeffs = gabor_coeffs(*gpack.filters, *fr.affine(cam, rd))
                return cam, rd, t, tgt, coeffs

            def fwd(b, plain=False):
                _, rd, t, _, coeffs = b
                if plain:
                    return chunked_gabor_plain(torch, fused_gabor_render_plain, rd.shape[0],
                                               packed, coeffs, rd, t, k)
                return fr._forward(packed, coeffs, rd, t)

            def train(b, plain=False):
                _, rd, t, tgt, coeffs = b
                if plain:
                    return chunked_gabor_plain(torch, fused_gabor_train_plain, rd.shape[0],
                                               packed, coeffs, rd, t, tgt, True, k)
                return fr._train(packed, coeffs, rd, t, tgt, True)

            def gerrs(got, ref):
                e = grad_errors(torch, got[:2], ref[:2], grad_views, hidden=h,
                                pads=(n, fr.d_pad))
                if len(got) == 3:       # the field's: the filter banks' too
                    bg, br = bank_grads(torch, model, got[2]), bank_grads(torch, model, ref[2])
                    floor = 1e-2 * max(float(v.abs().max()) for v in br.values())
                    for name in br:
                        e[name] = float((bg[name] - br[name]).abs().max()) / max(
                            float(br[name].abs().max()), floor)
                return e

            def train_extra(got, ref):
                if not torch.isfinite(got[5]).all():
                    fail(f"phase 37 gabor train {pl.tag} {cdt}: non-finite dA..dR")
                return [("dA..dR", {f"d{c}": float((got[5][j] - ref[5][j]).abs().max()
                                                   / ref[5][j].abs().max())
                                    for j, c in enumerate("ABPQR")})]

            def field_tol(npts, *_):
                tol_pt = FIELD_PT_TOL[cdt]
                return TOL[cdt]["rgb"], GRAD_TOL[cdt], tol_pt, tol_pt, "it", 0.001 * npts, ""

            return WideCase(
                fr=fr, field=field,
                supported=fr.supported() and field.supported() and fr.plan == pl,
                batch=batch, fwd=fwd, train=train, bwd=None,
                field_fwd=lambda pts, dirs, plain=False: (
                    gabor_field_plain(pk, pts, dirs, k) if plain
                    else field._forward(pk, pts, dirs)),
                field_bwd=lambda pts, dirs, cot, plain=False: (
                    gabor_field_bwd_plain(pk, pts, dirs, cot, k) if plain
                    else field._backward(pk, pts, dirs, cot)),
                gerrs=gerrs, train_extra=train_extra,
                fwd_bound=lambda r, s: bound_ms(r, s, cdt, weight_bytes + r * coef, macs, trig),
                train_bound=lambda r, s, train: bound_ms(
                    r, s, cdt, weight_bytes + r * coef, 3 * macs - (h // 2) * real_d,
                    2 * trig, grad_bytes + r * coef, True),
                field_bound=lambda npts, key: field_bound_ms(
                    npts, cdt, weight_bytes + n * 9 * h * 4,
                    grad_bytes + n * 9 * h * 4 if key == "bwd" else None, "gabor",
                    cost=gabor_field_cost(h, n, real_d)),
                field_tol=field_tol)

        return make

    return WideFamily(
        phase=37, word="gabor ", rows=GABOR_WIDE_ROW_ROLES,
        cases=[(f"h{h} L_d{ld} n{n}", pl, setup(h, ld, n, pl))
               for h, ld, n, pl in gabor_wide_shapes()],
        fwd_shapes=((R_SIREN, S_SIREN), (R_SIREN, 37)),
        train_shapes=((R_TRAIN, 37), (R_TRAIN, S_SIREN)),
        field_sets=lambda torch, dev: {k: v for k, v in field_point_sets(torch, dev).items()
                                       if k in GABOR_WIDE_FIELD},
        timed_n=(65536,), cot_seed=lambda n: 37 + n, sigma_rel=True)


@dataclass(frozen=True)
class SGWide:
    """Phase 36 / 37 (b)-(c) of the SIREN or GaborNet family (wide_sg): the
    phase, the family (lego_siren.txt's model_type), the label's words
    after the config's name, the hidden width, fit()'s iterations, the
    checkpoint a resume starts from, the distillation steps and the
    photometric iterations after them, the wrappers (render, field) and
    their counters by row, the rows' numbers as printed, whether the
    forward render has a backward kernel, and the plan tag of a config."""

    phase: int
    family: str
    label: str
    h: int
    iters: int
    save: int
    distill: int
    tune: int
    render: object
    field: object
    counters: dict
    rows: str
    render_backward: bool
    tag: object


def siren_sg() -> SGWide:
    from nerf_tpu_torch.ops.cuda.fused_render_siren import FusedSirenRender
    from nerf_tpu_torch.ops.cuda.fused_siren import SirenField
    from nerf_tpu_torch.ops.cuda.siren_plan import d_pad, plan

    return SGWide(36, "siren", "", SIREN_WIDE_H, SIREN_WIDE_ITERS, SIREN_WIDE_SAVE,
                  SIREN_WIDE_DISTILL, SIREN_WIDE_TUNE, FusedSirenRender, SirenField,
                  SIREN_WIDE_COUNTERS, "6-10", True,
                  lambda cfg: plan(cfg.hidden_dim, d_pad(cfg.dir_encoding_dim)).tag)


def gabor_sg() -> SGWide:
    from nerf_tpu_torch.ops.cuda.fused_gabor import GaborField
    from nerf_tpu_torch.ops.cuda.fused_render_gabor import FusedGaborRender
    from nerf_tpu_torch.ops.cuda.gabor_plan import DEFAULT_LAYERS, d_pad, plan

    return SGWide(37, "gabor", " with model_type = gabor", GABOR_WIDE_H, GABOR_WIDE_ITERS,
                  GABOR_WIDE_SAVE, GABOR_WIDE_DISTILL, GABOR_WIDE_TUNE, FusedGaborRender,
                  GaborField, GABOR_WIDE_COUNTERS, "11-14", False,
                  lambda cfg: plan(cfg.hidden_dim, d_pad(cfg.dir_encoding_dim),
                                   DEFAULT_LAYERS).tag)


# ---------------------------------------------------------------- phase 37

# The GaborNet family's four kernels (rows 11-14) at the wider shapes and
# depths nerf_tpu's take: hidden 512 and 1024 at lego_siren.txt's direction
# encoding (L_d = 4: d_pad 32; h1024d32n8 is the shape of (b)'s path),
# hidden 512 with L_d = 6 (d_pad 64), and 4 stages at hidden 256. Each
# shape's libraries are built from the checkout with its plan's -D flags
# (nerf_tpu_torch/ops/cuda/gabor_plan.py); tests/test_torch_port_cuda.py
# holds more (768, 1, 3 and 4 stages) against the plain versions. Rows 11
# and 12 at lego_siren.txt's serving chunk and training batch (1024 rays x
# 256 samples) and at 37 samples (rays that span a chunk), their plain
# versions over GABOR_PLAIN_RAYS rays a call (at hidden 1024 the plain
# train pass keeps about 40 float32 activations of every sample, some 43 GB
# at 1024 x 256 in one call; the loss and gradients of the calls are summed
# with their rays' weights); rows 13 and 14 at a bake's 65,536 lattice
# points and at 37 points; the tolerances of phases 10 and 20 (TOL,
# GRAD_TOL, FIELD_PT_TOL; dA..dR as phase 10 holds them).
GABOR_WIDE_CASES = ((512, 4, 8), (1024, 4, 8), (512, 6, 8), (256, 4, 4))
GABOR_WIDE_FIELD = ("lattice 65536", "uniform 37")
GABOR_PLAIN_RAYS = 256
GABOR_WIDE_H = 1024      # (b): lego_siren.txt with model_type = gabor at hidden 1024
GABOR_WIDE_ITERS = 40    # (b): fit() iterations
GABOR_WIDE_SAVE = 20     # (b): the checkpoint a resume starts from (to SAVE + 10)
GABOR_WIDE_DISTILL = 20  # (c): distillation steps of 16,384 points
GABOR_WIDE_TUNE = 10     # (c): photometric iterations after them
# the wrappers' counters (FusedGaborRender's, GaborField's) by row; the
# rows by role in phase 37 (a)
GABOR_WIDE_COUNTERS = {"FusedGaborRender": {"launches": "fused_render_gabor_fwd",
                                            "train_launches": "fused_render_gabor_train"},
                       "GaborField": {"launches": "fused_gabor_fwd",
                                      "bwd_launches": "fused_gabor_bwd"}}
GABOR_WIDE_ROW_ROLES = dict(fwd="fused_render_gabor_fwd", train="fused_render_gabor_train",
                            field_fwd="fused_gabor_fwd", field_bwd="fused_gabor_bwd")


def gabor_wide_shapes():
    """(hidden, L_d, stages, plan) of every phase-37 case."""
    from nerf_tpu_torch.ops.cuda.gabor_plan import d_pad, plan

    return [(h, ld, n, plan(h, d_pad(ld), n)) for h, ld, n in GABOR_WIDE_CASES]


def chunked_gabor_plain(torch, fn, num_rays: int, *args):
    """A GaborNet render's plain version (``fn``: the forward render's or
    the train pass's, ``args`` its ray-major inputs after the packing, the
    coefficients (5, R, n h) first) over GABOR_PLAIN_RAYS rays a call: the
    forward's outputs concatenated; the train pass's loss, weight gradients
    and coefficient cotangents of each call weighted by its share of the
    rays (each call's loss is its rays' mean), the rest concatenated."""
    packed, coeffs, *rest, k = args
    parts, shares = [], []
    for i in range(0, num_rays, GABOR_PLAIN_RAYS):
        j = min(i + GABOR_PLAIN_RAYS, num_rays)
        parts.append(fn(packed, coeffs[:, i:j], *(x[i:j] if torch.is_tensor(x) else x
                                                   for x in rest), k))
        shares.append((j - i) / num_rays)
    if len(parts[0]) == 4:           # the forward render
        return tuple(torch.cat(x) for x in zip(*parts))
    return (sum(p[0] * w for p, w in zip(parts, shares)),
            *(torch.cat([p[i] for p in parts]) for i in (1, 2, 3)),
            tuple(sum(p[4][i] * w for p, w in zip(parts, shares)) for i in (0, 1)),
            torch.cat([p[5] * w for p, w in zip(parts, shares)], dim=1))


def wide_sg(torch, dev, tmp: str, card: str, sg: "SGWide") -> dict:
    """Phase 36 / 37 (b): configs/lego_siren.txt with the family's
    model_type at hidden_dim = 1024 (bfloat16, 256 samples, 1024 rays),
    written as the phase's own config, on the synthetic 400 x 400 scene:
    fit() sg.iters iterations (one train-pass launch a step; the mse falls),
    a resume from sg.save bit for bit, two steps of the render route (a
    SIREN's forward render and its backward kernel; a GaborNet's forward
    render refuses autograd as nerf_tpu's does, and its two steps take the
    train pass outside fit), the checkpoint served with --occupancy 64 (the
    bake's four field launches at 1024; the request within mean abs 1e-2 of
    the unfused render) and one eval CLI frame (within mean abs 1e-2 of the
    unfused render); then (c) fit() with distill_from = that checkpoint:
    nerf_tpu's load_teacher builds the teacher over the student's config,
    so teacher and student are both at 1024 (sg.distill distillation steps:
    the teacher's field forward, the student's forward and backward; the
    loss falls), then sg.tune photometric iterations. Returns the launches
    of the family's rows by (row, plan tag, dtype) as the wrappers counted
    them (``shape_launches``), every one at hidden 1024 in bfloat16."""
    import dataclasses

    from nerf_tpu_torch.config import parse_config_file
    from nerf_tpu_torch.data.pipeline import load_scene
    from nerf_tpu_torch.data.poses import spherical_orbit
    from nerf_tpu_torch.render.renderer import render_rays, render_rays_train
    from nerf_tpu_torch.serve import RenderService
    from nerf_tpu_torch.train.loop import fit, render_settings_from_config
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.png import read_png

    P, fam, H = sg.phase, sg.family, sg.h
    Render, Field = sg.render, sg.field
    t_phase = time.perf_counter()
    scene = os.path.join(tmp, "scene")
    if not os.path.isdir(scene):
        write_sphere_scene(scene, HW)
    label = f"lego_siren.txt{sg.label} at hidden {H}"
    path = write_eval_config(
        tmp, "lego_siren.txt", f"lego_{fam}_h{H}.txt", model_type=fam, hidden_dim=H,
        num_iters=sg.iters, log_interval=10, val_interval=10 * sg.iters,
        save_interval=sg.save, save_path=os.path.join(tmp, f"wide_{fam}_models"),
        log_dir=os.path.join(tmp, f"wide_{fam}_logs"), num_render_poses=1)
    cfg = parse_config_file(path)
    if (cfg.model_type, cfg.hidden_dim, cfg.compute_dtype, cfg.num_samples,
            cfg.num_fine_samples, cfg.num_random_rays) != (
                fam, H, "bfloat16", 256, 0, 1024):
        fail(f"phase {P} config: {cfg}")
    lines: list = []
    Render.launches = Render.train_launches = 0
    Render.bwd_launches = 0                     # the main path's counts start here
    Render.shape_launches.clear()
    Field.shape_launches.clear()
    t0 = time.perf_counter()
    fit(cfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (Render.train_launches, Render.launches, Render.bwd_launches)
    for line in lines:
        if "[Iter" in line:
            say(f"  {line}")
    if counts != (sg.iters, 0, 0):
        fail(f"phase {P} fit {label} launched (train, forward, backward) {counts}")
    scal = read_scalars(cfg.log_dir)
    loss = scal["loss"]
    last = max(loss)
    if not all(math.isfinite(v) for v in loss.values()) or not loss[last] < loss[0]:
        fail(f"phase {P} {label}: the mse does not fall ({loss})")
    say(f"phase {P} train: fit {label} {sg.iters} iterations in {wall:.1f} s, "
        f"{counts[0]} train-pass launches; mse {loss[0]:.6f} at 0 -> {loss[last]:.6f} at "
        f"{last} (ratio {loss[last] / loss[0]:.4f}); step {scal['rays_per_sec'][last]:.0f} "
        f"rays/s; {card}")
    check_resume(torch, dev, tmp, cfg, fam, loss, tag=f"wide_{fam}", at=sg.save,
                 until=sg.save + 10)

    # the render route at 1024: a SIREN's forward render and its backward
    # kernel; a GaborNet's forward render has no VJP (nerf_tpu's raises), so
    # its steps take the train pass outside fit
    ckpt = os.path.join(cfg.save_path, f"{fam}_model_{sg.iters:06d}")
    state = create_train_state(cfg, device=dev)
    data = load_scene(cfg, device=dev)
    settings = render_settings_from_config(cfg)
    fr = Render(state.params, cfg.near, cfg.far)
    Render.launches = Render.train_launches = Render.bwd_launches = 0
    mses = []
    for i in range(2):
        g = torch.Generator(device=dev).manual_seed(cfg.seed + i)
        batch = data.pool.sample(g, cfg.num_random_rays)
        for m in state.models():
            m.zero_grad(set_to_none=True)
        if sg.render_backward:
            out = render_rays(state.params, batch.rays_o, batch.rays_d, settings, generator=g,
                              viewdirs=batch.viewdirs, fused_render=fr)
            mse = torch.mean((out.rgb - batch.rgb) ** 2)
        else:
            try:
                render_rays(state.params, batch.rays_o, batch.rays_d, settings, generator=g,
                            viewdirs=batch.viewdirs, fused_render=fr)
                fail(f"phase {P} {label}: the forward render took autograd")
            except NotImplementedError:
                pass
            out = None          # coarse only: the loss is the mse
            mse = render_rays_train(fr, state.params, batch.rays_o, batch.rays_d, settings,
                                    batch.rgb, generator=g, viewdirs=batch.viewdirs)[0]
        mse.backward()
        state.optimizer.step()
        mses.append(float(mse.detach()))
    counts = ((Render.launches, Render.bwd_launches) if sg.render_backward
              else (Render.train_launches,))
    want = (2, 2) if sg.render_backward else (2,)
    say(f"phase {P} train: {label} render route 2 steps, mse {mses}; launches "
        + (f"forward {counts[0]}, backward {counts[1]}" if sg.render_backward else
           f"train {counts[0]} (the forward render refused autograd, as nerf_tpu's)"))
    if counts != want or not all(math.isfinite(v) for v in mses):
        fail(f"phase {P} {label} render route launched {counts}, want {want}")
    del state, data, out
    torch.cuda.empty_cache()

    # served with --occupancy 64: the bake through the field forward at 1024
    Field.launches = 0
    svc = RenderService.from_checkpoint(cfg, ckpt, occupancy=64, device=dev, log=say)
    if Field.launches != 4:
        fail(f"phase {P} --occupancy 64 bake: {Field.launches} field launches, want 4")
    serve(torch, dev, tmp, label, Render, f"fused_{fam}_fwd", svc=svc,
          compare=("/pose/1",), routes=("/pose/1",))
    del svc
    torch.cuda.empty_cache()

    # one eval CLI frame
    out_dir = os.path.join(tmp, f"wide_{fam}_eval")
    res = run_eval_cli(["--config", path, "--checkpoint", ckpt, "--output", out_dir],
                       {fam: Render}, f"phase {P} {label}")
    per_image = math.ceil(HW * HW / cfg.chunk_size)
    if res["per_frame"][fam] != [per_image]:
        fail(f"phase {P} eval: launches a frame {res['per_frame'][fam]}, want "
             f"[{per_image}]")
    ref = RenderService.from_checkpoint(dataclasses.replace(cfg, use_pallas=False), ckpt,
                                        device=dev, log=lambda *a: None)
    frame = read_png(os.path.join(out_dir, "frame_0000.png"))
    diff = np.abs(frame.astype(np.float32) / 255.0
                  - ref.render_pose(spherical_orbit(1)[0], key_idx=0))
    say(f"phase {P} eval {label} frame 0 vs the unfused render: mean abs {diff.mean():.3e} "
        f"(tol {SERVE_TOL_MEAN:.0e}), max abs {diff.max():.3e}; {res['ms'][0]:.1f} ms")
    if not diff.mean() <= SERVE_TOL_MEAN:
        fail(f"phase {P} eval: the frame disagrees with the unfused render")
    del ref
    torch.cuda.empty_cache()

    # (c) fit() distilling that checkpoint into a seeded student first
    dcfg = dataclasses.replace(
        cfg, num_iters=sg.tune, distill_from=ckpt, distill_steps=sg.distill,
        distill_batch=16384, save_path=os.path.join(tmp, f"wide_{fam}_distill_models"),
        log_dir=os.path.join(tmp, f"wide_{fam}_distill_logs"))
    lines = []
    Field.launches = Field.bwd_launches = 0
    Render.launches = Render.train_launches = Render.bwd_launches = 0
    t0 = time.perf_counter()
    fit(dcfg, device=dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (Field.launches, Field.bwd_launches)
    render = (Render.train_launches, Render.launches, Render.bwd_launches)
    for line in lines:
        if "Distill" in line:
            say(f"  {line}")
    dl = read_scalars(dcfg.log_dir).get("distill_loss", {})
    say(f"phase {P} distill: fit {label} with distill_from the hidden-{H} "
        f"checkpoint, {sg.distill} steps of 16384 points, then {sg.tune} "
        f"iterations, in {wall:.1f} s; loss {dl.get(0)} at 0 -> "
        f"{dl.get(sg.distill - 1)} at {sg.distill - 1}; field launches "
        f"forward {counts[0]} (teacher and student), backward {counts[1]}; render train "
        f"{render[0]}")
    if counts != (2 * sg.distill, sg.distill) or render != (sg.tune, 0, 0):
        fail(f"phase {P} distillation: field launches {counts}, want "
             f"({2 * sg.distill}, {sg.distill}); render (train, forward, "
             f"backward) {render}")
    if sorted(dl) != list(range(sg.distill)) or not dl[sg.distill - 1] < dl[0]:
        fail(f"phase {P} distillation: the loss does not fall ({dl})")

    # the family's rows by shape, as the wrappers counted them through (b) and (c)
    launched = {(sg.counters[cls.__name__][counter], tag, cdt): count
                for cls in (Render, Field)
                for (counter, tag, cdt), count in cls.shape_launches.items()}
    say(f"phase {P} (b)-(c) launches by shape: "
        + ", ".join(f"{k[0]} {k[1]} {k[2]} {count}" for k, count in sorted(launched.items())))
    tag = sg.tag(cfg)
    rows = tuple(r for by in sg.counters.values() for r in by.values())
    if set(launched) != {(r, tag, "bfloat16") for r in rows} or min(launched.values()) < 1:
        fail(f"phase {P} (b)-(c): want every one of rows {sg.rows} at {tag} bfloat16 and no "
             f"other shape, launched {launched}")
    say(f"phase {P} (b)-(c): {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------- phase 6


def bench_train(torch, dev, model, steps: int, warmup: int, label: str,
                num_samples: int = 256, occupancy: tuple | None = None,
                profile_kernel=None) -> float:
    """bench.py's train protocol for ``model`` (bf16): 1024 rays x
    ``num_samples`` samples per ray (per-ray jitter), white background, a
    1<<20 synthetic pool made on the card, ``warmup`` steps, then ``steps``
    chained steps timed to a scalar fetched on the host; ``occupancy`` =
    (grid, options) samples the coarse pass from that prior. With
    ``profile_kernel``, one more step under torch.profiler."""
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
    if profile_kernel is not None:
        profile_device(torch, lambda: step(state, pool, occ_grid), profile_kernel,
                       f"one {label.split(' (')[0]} step")
    return rps


def bench_headline(torch, dev) -> float:
    """bench.py's headline: flat NeRF, bf16, 5 warm-up steps, 30 timed."""
    from nerf_tpu_torch.models.nerf import NeRFModel

    model = NeRFModel(compute_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(0)).to(dev)
    return bench_train(torch, dev, model, 30, 5, "bench headline (bench.py "
                       "protocol, flat NeRF bf16 1024x256)",
                       profile_kernel="fused_render_train_tc")


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


def wide_phase(torch, dev, tmp: str, card: str, phase: int) -> dict:
    """Phase 35, 36 or 37: (a) the family's rows at its wider shapes
    (check_wide_family), then (b)-(c) its config at hidden 1024 (lego.txt's
    wide_lego; lego_siren.txt's, SIREN or GaborNet, wide_sg); returns the
    rows' numbers by row and shape (family_wide_rows)."""
    fam = {35: nerf_wide_family, 36: siren_wide_family, 37: gabor_wide_family}[phase](torch, dev)
    wide = check_wide_family(torch, dev, card, fam)
    lap(f"{phase}a")
    if phase == 35:
        launched = wide_lego(torch, dev, tmp, card)
    else:
        launched = wide_sg(torch, dev, tmp, card, siren_sg() if phase == 36 else gabor_sg())
    lap(f"{phase}bc")
    return family_wide_rows(fam, wide, launched)


def phase_only(torch, dev, card: str, phase: int) -> int:
    """``chip_smoke.py --phase 35``, ``36`` or ``37``: the build (the
    default libraries and the phase's) and that phase alone, then its rows'
    numbers and the last line."""
    build_wide(torch, (phase,))
    with tempfile.TemporaryDirectory() as tmp:
        rows = wide_phase(torch, dev, tmp, card, phase)
    say(json.dumps({f"phase{phase}": rows}))
    say(f"chip_smoke: wall {time.perf_counter() - T_START:.1f} s")
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--phase", "35"], ["--phase", "36"], ["--phase", "37"]):
        print("usage: chip_smoke.py [--phase 35 | --phase 36 | --phase 37]", file=sys.stderr)
        return 2
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
    if argv:
        return phase_only(torch, dev, card, int(argv[1]))

    lap("1")
    infos = build_wide(torch, background=True)
    for info in infos:
        say(f"build: {info.name} {info.seconds:.1f} s -> "
            f"{os.path.relpath(info.path, ROOT)}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas: {line.strip()}")
    paths = {i.name: str(i.path) for i in infos}
    with ThreadPoolExecutor(len(TC_LIBS)) as pool:   # one cuobjdump a library, together
        counts = list(pool.map(tensor_core_instructions, [paths[n] for n in TC_LIBS]))
    for name, mma in zip(TC_LIBS, counts):
        if mma is None:
            say(f"build: {name} SASS not read (no cuobjdump): tensor-core "
                "instructions not measured")
            continue
        say(f"build: {name} SASS holds {mma[0]} HMMA and {mma[1]} HGMMA instructions")
        if sum(mma) == 0:
            fail(f"{name}, a bf16 kernel on the tensor cores, holds no tensor-core "
                 "instruction")
    lap("2")
    checks = check_kernel(torch, dev)
    lap("3")
    grad_checks = check_grad_kernels(torch, dev)
    lap("3b")
    siren_checks = check_siren_kernels(torch, dev)
    lap("7")
    gabor_checks = check_gabor_kernels(torch, dev)
    lap("10")
    kilo_checks = check_kilonerf_kernels(torch, dev)
    lap("13")
    field_checks = check_nerf_field_kernels(torch, dev)
    lap("17")
    sg_checks = check_siren_gabor_field_kernels(torch, dev)
    lap("20")
    interp_checks = check_grid_interp_kernel(torch, dev)
    lap("23 interp")
    scatter_checks = check_scatter_kernel(torch, dev)
    lap("23 scatter")
    render_checks = check_grid_render_kernel(torch, dev)
    lap("23 render")
    factor_checks = check_factor_render_kernel(torch, dev)
    lap("27")
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve(torch, dev, tmp, "lego.txt", FusedNerfRender,
                         "fused_render_fwd")
        lap("4")
        trained = train(torch, dev, tmp, "lego.txt", FusedNerfRender,
                        "fused_render_train_tc", 0.5)
        lap("5")
        siren_launches = serve(torch, dev, tmp, "lego_siren.txt", FusedSirenRender,
                               "fused_siren_fwd")
        lap("8")
        siren_trained = train(torch, dev, tmp, "lego_siren.txt", FusedSirenRender,
                              "fused_siren_grad", 1.0)
        lap("9")
        gabor_launches = serve(torch, dev, tmp, "lego_siren.txt", FusedGaborRender,
                               "fused_gabor_fwd", "gabor")
        lap("11")
        gabor_trained = train(torch, dev, tmp, "lego_siren.txt", FusedGaborRender,
                              "fused_gabor_train", 1.0, "gabor")
        lap("12")
        kilo_launches = serve(torch, dev, tmp, "lego_siren.txt", KiloNeRFField,
                              "fused_kilonerf_fwd", "kilonerf", KILO_OVERRIDES)
        lap("14")
        kilo_trained = train_kilonerf(torch, dev, tmp)
        lap("15")
        lego_ckpt = os.path.join(tmp, "train_models_nerf", "nerf_model_000200")
        occ_served = serve_occupancy(torch, dev, tmp, lego_ckpt)
        lap("18")
        distilled = train_distill_occupancy(torch, dev, tmp, lego_ckpt)
        lap("19")
        sg_ckpt = {f: os.path.join(tmp, f"train_models_{f}", f"{f}_model_000200")
                   for f in ("siren", "gabor")}
        sg_served = {f: serve_occupancy_sg(torch, dev, tmp, f, sg_ckpt[f])
                     for f in ("siren", "gabor")}
        lap("21")
        sg_distilled = {f: train_distill_cross(torch, dev, tmp, f,
                                               sg_ckpt["gabor" if f == "siren" else "siren"])
                        for f in ("gabor", "siren")}
        lap("22")
        grid_served = serve_plenoxels(torch, dev, tmp)
        lap("24")
        grid_trained = train_plenoxels(torch, dev, tmp)
        lap("25")
        baked = {f: bake_and_serve(torch, dev, tmp, f) for f in ("fastnerf", "plenoctree")}
        lap("28-29")
        evaluated = eval_cli(torch, dev, tmp, card)
        lap("30")
        ndc_checks = check_ndc_kernels(torch, dev, tmp)
        lap("31 kernels")
        ferned = fern(torch, dev, tmp, card)
        lap("31")
        ngped = ngp(torch, dev, tmp, card)
        lap("32")
        par = parallel(torch, dev, tmp, card, lego_ckpt, trained["step_rps"])
        lap("33")
        jpeg = phase34(torch, dev, tmp, card)
        lap("34")
        wait_wide()
        gc.collect()
        torch.cuda.empty_cache()
        say(f"phase 35: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still held on the card "
            "after phases 3-34")
        lap("35-37 build")
        wide_rows = {}
        for phase in (35, 36, 37):
            wide_rows.update(wide_phase(torch, dev, tmp, card, phase))
            gc.collect()
            torch.cuda.empty_cache()
    bench_headline(torch, dev)
    bench_siren(torch, dev)
    bench_gabor(torch, dev)
    bench_kilonerf(torch, dev)
    bench_plenoxels(torch, dev)
    lap("benches 6/9/12/15/26")

    def row(name, source, line, launched, c, err):
        return {"name": name, "route": "cuda",
                "source": f"nerf_tpu_torch/csrc/{source}", "replaces": line,
                "launches": launched, "max_abs_err": err, "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None}

    nerf_tpu = "nerf_tpu/ops/pallas/"
    kernels = [row("fused_render_fwd", "fused_render_fwd_tc.cu",
                   f"{nerf_tpu}fused_render.py:222",
                   launches + evaluated["fused_render_fwd"] + ferned["fwd_launches"]
                   + par["fwd_launches"] + jpeg["fwd_launches"],
                   checks[("bfloat16", 192)],
                   max([c["err"] for c in checks.values()]
                       + [v["err"] for k, v in ndc_checks.items() if k[0] == "fused_render_fwd"]))]
    for name, source, line, launched in (
            ("fused_render_train", "fused_render_train_tc.cu", 315,
             trained["train_launches"] + ferned["train_launches"] + par["train_launches"]
             + jpeg["train_launches"]),
            ("fused_render_bwd", "fused_render_train_tc.cu", 242, trained["bwd_launches"])):
        kernels.append(row(name, source,
                           f"{nerf_tpu}fused_render.py:{line}", launched,
                           grad_checks[(name, "bfloat16", 192)],
                           max([v["err"] for k, v in grad_checks.items() if k[0] == name]
                               + [v["err"] for k, v in ndc_checks.items() if k[0] == name])))
    for name, source, line, launched in (
            ("fused_render_siren_fwd", "fused_render_siren_fwd_tc.cu", 60,
             siren_launches + evaluated["fused_render_siren_fwd"]),
            ("fused_render_siren_train", "fused_render_siren_train_tc.cu", 110,
             siren_trained["train_launches"]),
            ("fused_render_siren_bwd", "fused_render_siren_train_tc.cu", 82,
             siren_trained["bwd_launches"])):
        kernels.append(row(name, source, f"{nerf_tpu}fused_render_siren.py:{line}",
                           launched, siren_checks[(name, "bfloat16")],
                           max(siren_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched in (
            ("fused_render_gabor_fwd", 166, gabor_launches),
            ("fused_render_gabor_train", 186, gabor_trained["train_launches"])):
        kernels.append(row(name, f"{name}_tc.cu", f"{nerf_tpu}fused_render_gabor.py:{line}",
                           launched, gabor_checks[(name, "bfloat16")],
                           max(gabor_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, source, line, launched in (
            ("fused_kilonerf_fwd", "fused_kilonerf_fwd_tc.cu", 367,
             kilo_launches + kilo_trained["fwd_launches"]),
            ("fused_kilonerf_bwd", "fused_kilonerf_bwd_tc.cu", 394,
             kilo_trained["bwd_launches"])):
        kernels.append(row(name, source, f"{nerf_tpu}fused_kilonerf.py:{line}",
                           launched, kilo_checks[(name, "bfloat16")],
                           max(kilo_checks[(name, c)]["err"]
                               for c in ("float32", "bfloat16"))))
    for name, line, launched, n in (
            ("fused_nerf_fwd", 233,
             occ_served["bake_launches"] + distilled["fwd_launches"], 65536),
            ("fused_nerf_bwd", 333, distilled["bwd_launches"], 16384)):
        source = field_checks[(name, "bfloat16", n)]["library"] + ".cu"
        kernels.append(row(name, source, f"{nerf_tpu}fused_nerf.py:{line}",
                           launched, field_checks[(name, "bfloat16", n)],
                           max(field_checks[(name, c, n)]["err"]
                               for c in ("float32", "bfloat16"))))
    for family, other in (("siren", "gabor"), ("gabor", "siren")):
        fwd_launched = (sg_served[family]["bake_launches"] + sg_distilled[family]["fwd"]
                        + sg_distilled[other]["teacher_fwd"]
                        + evaluated.get(f"fused_{family}_fwd", 0))
        for name, line, launched, n in (
                (f"fused_{family}_fwd", {"siren": 103, "gabor": 96}[family],
                 fwd_launched, 65536),
                (f"fused_{family}_bwd", {"siren": 117, "gabor": 110}[family],
                 sg_distilled[family]["bwd"], 16384)):
            source = sg_checks[(name, "bfloat16", n)]["library"] + ".cu"
            kernels.append(row(name, source, f"{nerf_tpu}fused_{family}.py:{line}",
                               launched, sg_checks[(name, "bfloat16", n)],
                               max(sg_checks[(name, c, n)]["err"]
                                   for c in ("float32", "bfloat16"))))
    for name, source, line, launched, c, err in (
            ("grid_interp", "fused_grid.cu", "fused_grid.py:160", grid_trained["grid_interp"],
             interp_checks[("float32", "train", 256)],
             max(v["err"] for v in interp_checks.values())),
            ("grid_render", "fused_grid_render.cu", "fused_grid_render.py:76",
             grid_served + grid_trained["grid_render"] + baked["plenoctree"]["launches"],
             render_checks[("bfloat16", 1024, 256)],
             max(v["err"] for v in render_checks.values())),
            ("grid_render_factors", "fused_grid_render.cu", "fused_grid_render.py:76",
             baked["fastnerf"]["launches"] + evaluated["grid_render_factors"],
             factor_checks[("bfloat16", 1024, 256)],
             max(v["err"] for v in factor_checks.values())),
            ("scatter_add", "scatter_add.cu", "scatter_add.py:56",
             grid_trained["scatter_add"] + ngped["scatter_launches"],
             scatter_checks["step"], max(v["err"] for v in scatter_checks.values()))):
        kernels.append(dict(row(name, source, f"{nerf_tpu}{line}", launched, c, err),
                            library_ms=c["library_ms"]))
    for k, by_width in wide_rows.items():
        for entry in kernels:
            if entry["name"] == k:
                entry["widths"] = by_width
                entry["launches"] += sum(w["launches"] for w in by_width.values())
    say(json.dumps({"kernels": kernels}))
    say("chip_smoke: phases' wall s " + ", ".join(f"{k} {t:.1f}" for k, t in LAPS))
    say(f"chip_smoke: wall {time.perf_counter() - T_START:.1f} s (limit 1200)")
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
