// Shared pieces of the KiloNeRF field kernels for Hopper (sm_90a),
// fused_kilonerf_fwd.cu, fused_kilonerf_bwd.cu and (the run, the encoding,
// the widths and the partials' sum) the tensor-core kernels
// fused_kilonerf_fwd_tc.cu and fused_kilonerf_bwd_tc.cu:
//   * the per-network parameter block in shared memory (an aligned,
//     zero-padded float32 copy of the network's slice of the packed buffer)
//     and the map between the two layouts;
//   * the run of sorted points a CTA owns (one network's segment, cut into
//     pieces of fixed length);
//   * the frequency encoding of one column;
//   * one point's forward chain, optionally writing the activations the
//     backward needs into that point's row of shared memory;
//   * the sum of a backward's per-run gradient partials, network by network.
//
// The packed buffer (ops/cuda/fused_kilonerf.py::pack_f32) holds, per
// network, every parameter of nerf_tpu_torch/models/kilonerf.py in the JAX
// layout, one layer after the other: l1.w (P x H), l1.b (H), l2.w (H x H),
// l2.b (H), trunk.w (H x (H+1)), trunk.b (H+1), rgb1.w ((H+D) x H),
// rgb1.b (H), rgb2.w (H x 3), rgb2.b (3), with P and D the real widths of the
// position and direction encodings (63 and 27 at L = 10/4). In bfloat16 mode
// the whole buffer is bfloat16, biases and the density row included, as the
// TPU kernel casts its packed block (nerf_tpu/ops/pallas/fused_kilonerf.py,
// `fused`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kilo {

constexpr int H = 32;          // network width (the only one supported)
constexpr int PMAX = 64;       // position encoding rows in shared memory
constexpr int DMAX = 32;       // direction encoding rows in shared memory
constexpr float HALF_PI = 1.5707963267948966f;

// The network's block in shared memory (floats). Matrices are (in, out)
// row-major with 32 columns (rgb2: 4, the last zero); rows past the real
// encoding widths and the pads are zero.
constexpr int S_W1 = 0;                      // PMAX x H
constexpr int S_B1 = S_W1 + PMAX * H;        // H
constexpr int S_W2 = S_B1 + H;               // H x H
constexpr int S_B2 = S_W2 + H * H;           // H
constexpr int S_WTF = S_B2 + H;              // H x H   trunk features
constexpr int S_BTF = S_WTF + H * H;         // H
constexpr int S_WTS = S_BTF + H;             // H       trunk density column
constexpr int S_BTS = S_WTS + H;             // 1 (+3 pad)
constexpr int S_WR1F = S_BTS + 4;            // H x H   rgb1, feature rows
constexpr int S_WR1D = S_WR1F + H * H;       // DMAX x H rgb1, direction rows
constexpr int S_BR1 = S_WR1D + DMAX * H;     // H
constexpr int S_WR2 = S_BR1 + H;             // H x 4
constexpr int S_BR2 = S_WR2 + H * 4;         // 3 (+1 pad)
constexpr int NW = S_BR2 + 4;                // 6,440 floats

struct Dims {
  int P;   // real position-encoding width, <= PMAX
  int D;   // real direction-encoding width, <= DMAX
  int R;   // floats (or bf16 values) per network in the packed buffer
};

__host__ __device__ inline int packed_size(int P, int D) {
  return P * H + H + H * H + H + H * (H + 1) + (H + 1) + (H + D) * H + H + 3 * H + 3;
}

// The packed-buffer index of shared-memory slot s, or -1 for a pad.
__device__ __forceinline__ int packed_index(int s, int P, int D) {
  const int o_b1 = P * H, o_w2 = o_b1 + H, o_b2 = o_w2 + H * H;
  const int o_tw = o_b2 + H, o_tb = o_tw + H * (H + 1);
  const int o_r1w = o_tb + H + 1, o_r1b = o_r1w + (H + D) * H;
  const int o_r2w = o_r1b + H, o_r2b = o_r2w + 3 * H;
  if (s < S_B1) {
    const int r = s / H, c = s % H;
    return r < P ? r * H + c : -1;
  }
  if (s < S_W2) return o_b1 + (s - S_B1);
  if (s < S_B2) return o_w2 + (s - S_W2);
  if (s < S_WTF) return o_b2 + (s - S_B2);
  if (s < S_BTF) {
    const int r = (s - S_WTF) / H, c = (s - S_WTF) % H;
    return o_tw + r * (H + 1) + c;
  }
  if (s < S_WTS) return o_tb + (s - S_BTF);
  if (s < S_BTS) return o_tw + (s - S_WTS) * (H + 1) + H;
  if (s < S_WR1F) return s == S_BTS ? o_tb + H : -1;
  if (s < S_WR1D) return o_r1w + (s - S_WR1F);
  if (s < S_BR1) {
    const int r = (s - S_WR1D) / H, c = (s - S_WR1D) % H;
    return r < D ? o_r1w + (H + r) * H + c : -1;
  }
  if (s < S_WR2) return o_r1b + (s - S_BR1);
  if (s < S_BR2) {
    const int r = (s - S_WR2) / 4, m = (s - S_WR2) % 4;
    return m < 3 ? o_r2w + r * 3 + m : -1;
  }
  const int m = s - S_BR2;
  return m < 3 ? o_r2b + m : -1;
}

// Copy network g's float32 block into shared memory, pads zeroed. Every
// thread of the CTA takes part; the caller synchronises.
__device__ __forceinline__ void stage_weights(float* w, const float* __restrict__ src,
                                              const Dims& dims) {
  for (int s = threadIdx.x; s < NW; s += blockDim.x) {
    const int k = packed_index(s, dims.P, dims.D);
    w[s] = k >= 0 ? src[k] : 0.0f;
  }
}

// The run of sorted points CTA `b` owns: network g's segment
// [offsets[g], offsets[g+1]) cut into runs of `run` points; run_end[g] is
// the running total of runs over networks 0..g. False for a CTA past the
// last run (the grid is sized for the most runs any input can need).
__device__ __forceinline__ bool find_run(int b, const int* __restrict__ run_end,
                                         const int* __restrict__ offsets, int g3,
                                         int run, int& g, int& start, int& end) {
  if (b >= run_end[g3 - 1]) return false;
  int lo = 0, hi = g3 - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run_end[mid] > b) hi = mid; else lo = mid + 1;
  }
  g = lo;
  const int rank = b - (g > 0 ? run_end[g - 1] : 0);
  start = offsets[g] + rank * run;
  end = min(start + run, offsets[g + 1]);
  return true;
}

// Column c of the frequency encoding of (x0, x1, x2): the coordinate for
// c < 3, else sin(2^j x_d) or sin(2^j x_d + pi/2) (the cosine as the TPU
// kernel builds it, `_enc_consts`), j = (c-3)/6, in the layout [x, sin(2^0
// x), cos(2^0 x), sin(2^1 x), ...]. sinf with its full range reduction:
// voxel-local coordinates of points outside the domain reach ~30, so the
// arguments reach 2^9 * 30 at L = 10 (never __sinf, never fast math).
__device__ __forceinline__ float enc_value(float x0, float x1, float x2, int c) {
  if (c < 3) return c == 0 ? x0 : (c == 1 ? x1 : x2);
  const int k = c - 3, j = k / 6, r = k - 6 * j, d = r % 3;
  const float xd = d == 0 ? x0 : (d == 1 ? x1 : x2);
  float arg = __fmul_rn(xd, __int_as_float((127 + j) << 23));   // x * 2^j, exact
  if (r >= 3) arg = __fadd_rn(arg, HALF_PI);
  return sinf(arg);
}

// acc[0..31] += v * w[row, 0..31] for one 32-column row in shared memory.
__device__ __forceinline__ void axpy_row(float* acc, float v, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = r4[q];
    acc[4 * q + 0] = fmaf(v, w.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, w.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, w.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, w.w, acc[4 * q + 3]);
  }
}

// sum_j a[j] * row[j] over a 32-column row.
__device__ __forceinline__ float dot_row(const float* a, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = r4[q];
    s = fmaf(a[4 * q + 0], w.x, s);
    s = fmaf(a[4 * q + 1], w.y, s);
    s = fmaf(a[4 * q + 2], w.z, s);
    s = fmaf(a[4 * q + 3], w.w, s);
  }
  return s;
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store32(float* dst, const float* v) {
#pragma unroll
  for (int q = 0; q < H / 4; ++q) store4(dst + 4 * q, v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// One point's activations row in the CUDA-core backward's shared memory
// (floats): the matmul inputs as the products read them.
constexpr int A_PENC = 0;      // PMAX
constexpr int A_X1 = 64;       // H
constexpr int A_X2 = 96;       // H, unrounded
constexpr int A_FEAT = 128;    // H
constexpr int A_DENC = 160;    // DMAX
constexpr int A_Y = 192;       // H
constexpr int A_STRIDE = 228;  // 224 used; 57 float4s, so float4 rows of
                               // neighbouring points hit distinct banks

// The float32 forward chain of one point (nerf_tpu/ops/pallas/
// fused_kilonerf.py, `_forward_tile_multi` at one expert), the CUDA-core
// kernels' (bfloat16 runs on the tensor cores, fused_kilonerf_tc_common.cuh):
// float32 sums, the bias added after the sum; the density from x2 and the
// density row; rgb the sigmoid. Returns rgb, the density pre-activation
// and the ReLU masks of x1 and y (bit k: unit k active). With STORE the
// activations go to `arow` (A_* layout).
template <bool STORE>
__device__ __forceinline__ void point_forward(const float* __restrict__ w, const float* loc,
                                              const float* dir, const Dims& dims,
                                              float* arow, float* rgb, float& sigma_pre,
                                              unsigned& mask_x1, unsigned& mask_y) {
  float acc[H], x[H];
  // l1 on the position encoding, four columns at a time (the rows past P
  // of the staged matrix are zero)
#pragma unroll
  for (int j = 0; j < H; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < PMAX; c0 += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = c0 + u < dims.P ? enc_value(loc[0], loc[1], loc[2], c0 + u) : 0.0f;
    if (STORE) store4(arow + A_PENC + c0, v[0], v[1], v[2], v[3]);
#pragma unroll
    for (int u = 0; u < 4; ++u) axpy_row(acc, v[u], w + S_W1 + (c0 + u) * H);
  }
  mask_x1 = 0u;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    x[j] = fmaxf(acc[j] + w[S_B1 + j], 0.0f);
    if (x[j] > 0.0f) mask_x1 |= 1u << j;
  }
  // l2
#pragma unroll
  for (int j = 0; j < H; ++j) acc[j] = 0.0f;
  if (STORE) store32(arow + A_X1, x);
#pragma unroll
  for (int k = 0; k < H; ++k) axpy_row(acc, x[k], w + S_W2 + k * H);
#pragma unroll
  for (int j = 0; j < H; ++j) x[j] = fmaxf(acc[j] + w[S_B2 + j], 0.0f);
  if (STORE) store32(arow + A_X2, x);
  // density from x2
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) s = fmaf(x[k], w[S_WTS + k], s);
  sigma_pre = s + w[S_BTS];
  // trunk features
#pragma unroll
  for (int j = 0; j < H; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) axpy_row(acc, x[k], w + S_WTF + k * H);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    x[j] = acc[j] + w[S_BTF + j];
    acc[j] = 0.0f;
  }
  if (STORE) store32(arow + A_FEAT, x);
  // rgb1 on concat(features, direction encoding)
#pragma unroll
  for (int k = 0; k < H; ++k) axpy_row(acc, x[k], w + S_WR1F + k * H);
  for (int c0 = 0; c0 < DMAX; c0 += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = c0 + u < dims.D ? enc_value(dir[0], dir[1], dir[2], c0 + u) : 0.0f;
    if (STORE) store4(arow + A_DENC + c0, v[0], v[1], v[2], v[3]);
#pragma unroll
    for (int u = 0; u < 4; ++u) axpy_row(acc, v[u], w + S_WR1D + (c0 + u) * H);
  }
  mask_y = 0u;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    x[j] = fmaxf(acc[j] + w[S_BR1 + j], 0.0f);
    if (x[j] > 0.0f) mask_y |= 1u << j;
  }
  if (STORE) store32(arow + A_Y, x);
  // rgb2 and the sigmoid
  float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float4 wr = *reinterpret_cast<const float4*>(w + S_WR2 + 4 * k);
    z0 = fmaf(x[k], wr.x, z0);
    z1 = fmaf(x[k], wr.y, z1);
    z2 = fmaf(x[k], wr.z, z2);
  }
  rgb[0] = 1.0f / (1.0f + expf(-(z0 + w[S_BR2 + 0])));
  rgb[1] = 1.0f / (1.0f + expf(-(z1 + w[S_BR2 + 1])));
  rgb[2] = 1.0f / (1.0f + expf(-(z2 + w[S_BR2 + 2])));
}

// Each network's gradient: the sum of its pieces' partials (NW floats
// each, the shared-memory layout) in piece order (zero when it has no
// points), written in the packed layout. The second kernel of both
// backwards (fused_kilonerf_bwd.cu, fused_kilonerf_bwd_tc.cu).
__global__ void __launch_bounds__(256)
fused_kilonerf_reduce_kernel(const float* __restrict__ partial,
                             const int* __restrict__ run_end, Dims dims,
                             float* __restrict__ out) {
  const int g = blockIdx.x;
  const int p0 = g > 0 ? run_end[g - 1] : 0, p1 = run_end[g];
  float* dst = out + static_cast<size_t>(g) * dims.R;
  for (int s = threadIdx.x; s < NW; s += blockDim.x) {
    const int k = packed_index(s, dims.P, dims.D);
    if (k < 0) continue;
    float sum = 0.0f;
    for (int p = p0; p < p1; ++p) sum += partial[static_cast<size_t>(p) * NW + s];
    dst[k] = sum;
  }
}

}  // namespace kilo
