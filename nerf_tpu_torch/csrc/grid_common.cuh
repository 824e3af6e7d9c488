// Trilinear interpolation of a dense voxel grid: the device code that the
// grid-interpolation kernel (fused_grid.cu) and the fused grid render
// (fused_grid_render.cu) share, both one thread per point with every
// channel in its registers (interp_row).
//
// The grid is a dense (R, R, R, C) array, row-major, C <= 32 channels a row
// (Plenoxels: 1 density + 3 x 9 SH coefficients = 28), float32 or its
// bfloat16 copy. A point's float cell coordinate g (one per axis, clamped to
// [0, R-1]) selects the cell x0 = clamp(floor(g), 0, R-2) and the fraction
// f = g - x0; the eight corners (dx, dy, dz) in {0, 1}^3, k = dx*4 + dy*2 +
// dz, carry the weight w_k = (wx * wy) * wz with wx = 1 - f or f. Every
// channel c < C sums w_k * grid[corner_k, c] over k in order, in float32.
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
// gather; the H100 gathers, so a thread reads the eight corner rows of its
// point directly as vectors (a row is 112 bytes in float32, 56 in
// bfloat16), and the L2 cache takes the place of the window.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace grid {

constexpr int MAX_C = 32;          // channels a grid row holds at most
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

// Row `row` of a grid of C channels into x[0..C-1] as float32, read as the
// widest vectors the row's byte stride keeps aligned (16 bytes for 28
// float32 channels, 8 for 28 bfloat16 ones; the grid itself 16-byte
// aligned). A bfloat16 value is the high half of its float32.
template <bool BF16, int C>
__device__ __forceinline__ void load_row_vec(const void* g, long long row, float (&x)[C]) {
  constexpr int ES = BF16 ? 2 : 4, RB = C * ES;
  constexpr int VB = RB % 16 == 0 ? 16 : (RB % 8 == 0 ? 8 : (RB % 4 == 0 ? 4 : 2));
  constexpr int NV = RB / VB, WORDS = VB >= 4 ? VB / 4 : 1;
  const char* p = static_cast<const char*>(g) + row * RB;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    unsigned u[WORDS];
    if constexpr (VB == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
    } else if constexpr (VB == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + i);
      u[0] = q.x; u[1] = q.y;
    } else if constexpr (VB == 4) {
      u[0] = __ldg(reinterpret_cast<const unsigned*>(p) + i);
    } else {
      u[0] = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      if constexpr (BF16) {
        x[i * (VB / 2) + 2 * j] = __uint_as_float(u[j] << 16);
        if constexpr (VB >= 4) x[i * (VB / 2) + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
      } else {
        x[i * (VB / 4) + j] = __uint_as_float(u[j]);
      }
    }
  }
}

// Every channel of the interpolated row at one point, for a thread that owns
// the point: the eight corner rows read as vectors (load_row_vec), and each
// channel summed over k in order from 0, one rounding an operation.
template <bool BF16, int C>
__device__ __forceinline__ void interp_row(const void* g, int r, long long base,
                                           const float w[8], float (&v)[C]) {
  const long long rr = static_cast<long long>(r) * r;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float x[C];
    load_row_vec<BF16, C>(g, base + ((k & 4) ? rr : 0) + ((k & 2) ? r : 0) + (k & 1), x);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = __fadd_rn(v[ch], __fmul_rn(w[k], x[ch]));
  }
}

}  // namespace grid
