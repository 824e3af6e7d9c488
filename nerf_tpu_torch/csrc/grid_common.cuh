// Trilinear interpolation of a dense voxel grid, one warp per point with the
// lanes over channels: the device code that the grid-interpolation kernel
// (fused_grid.cu) and the fused grid render (fused_grid_render.cu) share.
//
// The grid is a dense (R, R, R, C) array, row-major, C <= 32 channels a row
// (Plenoxels: 1 density + 3 x 9 SH coefficients = 28), float32 or its
// bfloat16 copy. A point's float cell coordinate g (one per axis, clamped to
// [0, R-1]) selects the cell x0 = clamp(floor(g), 0, R-2) and the fraction
// f = g - x0; the eight corners (dx, dy, dz) in {0, 1}^3, k = dx*4 + dy*2 +
// dz, carry the weight w_k = (wx * wy) * wz with wx = 1 - f or f. Every
// lane c < C sums w_k * grid[corner_k, c] over k in order, in float32.
//
// float32 mode reads float32 rows with float32 weights. bfloat16 mode is
// the TPU kernel's (nerf_tpu/ops/pallas/fused_grid.py::_interp_seg): the
// rows come from the bfloat16 copy, each weight is rounded to bfloat16
// after its product, and the eight products (exact in float32) are summed
// in float32. Products and sums are rounded one operation at a time
// (__fmul_rn / __fadd_rn, no fused multiply-add), as the plain PyTorch
// version rounds them.
//
// The TPU kernels' plan (8^3 sub-bricks, the 16^3 window, tent matmuls and
// the fits bit with its fallback) exists because Mosaic has no in-kernel
// gather; the H100 gathers, so each lane reads its channel of the eight
// corner rows directly (a row is 112 bytes in float32, 56 in bfloat16; a
// warp's reads of one row are one or two 128-byte lines) and the L2 cache
// takes the place of the window.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace grid {

constexpr int LANES = 32;          // channels a warp covers
constexpr unsigned FULL = 0xffffffffu;

// The cell coordinate of a position p in [-1, 1]: clamp((p + 1) * half, 0,
// R - 1) with half = 0.5 * (R - 1) (nerf_tpu/ops/interp.py::_tri_coords).
__device__ __forceinline__ float cell_of(float p, float half, float top) {
  return fminf(fmaxf(__fmul_rn(__fadd_rn(p, 1.0f), half), 0.0f), top);
}

// The stencil of cell coordinates (gx, gy, gz): the row of corner 0 and the
// eight weights, rounded to bfloat16 when BF16.
template <bool BF16>
__device__ __forceinline__ void stencil(float gx, float gy, float gz, int r,
                                        long long& base, float w[8]) {
  const float g[3] = {gx, gy, gz};
  int x0[3];
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x0[a] = min(max(static_cast<int>(floorf(g[a])), 0), r - 2);
    const float f = __fsub_rn(g[a], static_cast<float>(x0[a]));
    lo[a] = __fsub_rn(1.0f, f);
    hi[a] = f;
  }
  base = (static_cast<long long>(x0[0]) * r + x0[1]) * r + x0[2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wxy = __fmul_rn((k & 4) ? hi[0] : lo[0], (k & 2) ? hi[1] : lo[1]);
    float wk = __fmul_rn(wxy, (k & 1) ? hi[2] : lo[2]);
    if (BF16) wk = __bfloat162float(__float2bfloat16_rn(wk));
    w[k] = wk;
  }
}

template <bool BF16>
__device__ __forceinline__ float load_row(const void* g, long long row, int c, int lane) {
  if (BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[row * c + lane]);
  return static_cast<const float*>(g)[row * c + lane];
}

// Lane ``lane``'s channel of the interpolated row (0 for lane >= c).
template <bool BF16>
__device__ __forceinline__ float interp_lane(const void* g, int r, int c, long long base,
                                             const float w[8], int lane) {
  if (lane >= c) return 0.0f;
  const long long rr = static_cast<long long>(r) * r;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)     // eight independent loads in flight
    v[k] = load_row<BF16>(g, base + ((k & 4) ? rr : 0) + ((k & 2) ? r : 0) + (k & 1), c, lane);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k], v[k]));
  return acc;
}

}  // namespace grid
