// Generic pieces of the fused render kernels for Hopper (sm_90a), shared by
// the NeRF family (fused_render_common.cuh, fused_render_{fwd,train}.cu) and
// the SIREN family (fused_render_siren_common.cuh,
// fused_render_siren_{fwd,train}.cu). Each family keeps its own packed
// weight layout and chunk forward; what is here does not depend on either:
//   * cp.async, bf16 rounding, weight loads, the degree-11 sine;
//   * the register-tiled gemm over a 64-point chunk (weights streamed
//     through a double-buffered shared-memory stage) and its epilogue;
//   * the frequency encoding of one coordinate;
//   * compositing: the forward scan of a chunk (thread 0), and the train
//     kernels' per-ray pass (transmittance, weights, ray sums, the MSE
//     cotangent, the compositing backward);
//   * the train kernels' backward building blocks (dz W^T over a CTA's
//     points, dW = A^T dz, column sums) and the in-order sum of the
//     per-CTA partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf {

constexpr int H = 256;        // hidden width (the only one supported)
constexpr int HR = H / 2;     // rgb-head width
constexpr int DP = 32;        // padded direction-encoding width
constexpr int P = 64;         // points per chunk
constexpr int LDA = P + 4;    // row stride (floats) of activation tiles
constexpr int KT = 16;        // weight rows per staged tile
constexpr int THREADS = 256;

// Shared memory (floats) of both families starts with two feature-major
// activation buffers; each family's plan follows them.
constexpr int SM_ACT0 = 0;
constexpr int SM_ACT1 = SM_ACT0 + H * LDA;

constexpr float HALF_PI = 1.5707963267948966f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive weights as float32.
__device__ __forceinline__ void load4(const float* p, float* w) {
  float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* w) {
  uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The degree-11 sine of nerf_tpu/ops/pallas/fused_nerf.py::_fast_sin, with
// every operation rounded as written (no FMA contraction), so that it
// matches the plain PyTorch version bit for bit.
__device__ __forceinline__ float fast_sin(float x) {
  const float two_pi = 6.283185307179586f;
  const float inv_two_pi = 0.15915494309189535f;
  float r = __fsub_rn(x, __fmul_rn(two_pi, rintf(__fmul_rn(x, inv_two_pi))));
  float r2 = __fmul_rn(r, r);
  float q = __fmul_rn(r2, -2.0534080101e-08f);
  q = __fmul_rn(r2, __fadd_rn(2.7040473315e-06f, q));
  q = __fmul_rn(r2, __fadd_rn(-1.9812572238e-04f, q));
  q = __fmul_rn(r2, __fadd_rn(8.3325579984e-03f, q));
  q = __fmul_rn(r2, __fadd_rn(-1.6666577198e-01f, q));
  return __fmul_rn(r, __fadd_rn(9.9999970696e-01f, q));
}

// Start the cp.async copies of weight rows [kt*KT, kt*KT+KT) into a stage.
template <int N, typename WT>
__device__ __forceinline__ void stage_tile(const WT* __restrict__ wg, WT* dst,
                                           int kt) {
  constexpr int TILE = KT * N;
  constexpr int VEC = 16 / sizeof(WT);
  constexpr int COPIES = TILE / VEC / THREADS;
  static_assert(COPIES * VEC * THREADS == TILE, "tile must split evenly");
  const WT* src = wg + static_cast<size_t>(kt) * TILE;
#pragma unroll
  for (int c = 0; c < COPIES; ++c) {
    int e = (c * THREADS + threadIdx.x) * VEC;
    cp_async16(dst + e, src + e);
  }
  cp_async_commit();
}

// acc[i][j] += sum_k in[k][ty*8+i] * W[k][col(j)] over K rows, where
// col(j) = (j/4)*128 + tx*4 + j%4. `in_s` is feature-major (stride LDA).
// Starts and ends with every thread past a barrier, so the caller may write
// any buffer the previous layer read.
template <int K, int NQ, typename WT>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][4 * NQ],
                                         const float* in_s,
                                         const WT* __restrict__ wg, WT* wst) {
  constexpr int N = 128 * NQ;
  constexpr int TILE = KT * N;
  constexpr int NT = K / KT;
  static_assert(NT * KT == K, "K must be a multiple of KT");
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  stage_tile<N>(wg, wst, 0);
  for (int kt = 0; kt < NT; ++kt) {
    if (kt + 1 < NT) {
      stage_tile<N>(wg, wst + ((kt + 1) & 1) * TILE, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const WT* ws = wst + (kt & 1) * TILE + tx * 4;
    const float* as = in_s + kt * KT * LDA + ty * 8;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      float4 a0 = *reinterpret_cast<const float4*>(as + k * LDA);
      float4 a1 = *reinterpret_cast<const float4*>(as + k * LDA + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[4 * NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) load4(ws + k * N + q * 128, w + 4 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

template <int NQ>
__device__ __forceinline__ void zero(float (&acc)[8][4 * NQ]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = 0.f;
  }
}

// out[col][ty*8+i] = act(acc[i][j] + bias[col]), rounded to bf16 when the
// value is next a matmul input in bf16 mode. With `stash`, the same values
// also go to a point-major copy in device memory: row l0+ty*8+i, stride ld.
template <int NQ, bool BF16>
__device__ __forceinline__ void epilogue(const float (&acc)[8][4 * NQ],
                                         const float* __restrict__ bias,
                                         bool relu, float* out_s,
                                         float* stash = nullptr, int ld = 0,
                                         size_t l0 = 0) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = q * 128 + tx * 4 + u;
      const float b = __ldg(bias + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = acc[i][q * 4 + u] + b;
        if (relu) x = fmaxf(x, 0.f);
        v[u][i] = BF16 ? round_bf16(x) : x;
      }
      float* dst = out_s + col * LDA + ty * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[u][4], v[u][5], v[u][6], v[u][7]);
    }
    if (stash != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* g = stash + (l0 + ty * 8 + i) * ld + q * 128 + tx * 4;
        *reinterpret_cast<float4*>(g) = make_float4(v[0][i], v[1][i], v[2][i], v[3][i]);
      }
    }
  }
}

// Frequency encoding of one coordinate, column c of [x, sin(2^j x),
// sin(2^j x + pi/2), ...] (the cos columns as a phase-shifted sine, as the
// TPU kernels build them).
template <bool FAST>
__device__ __forceinline__ float encode_col(float x, int c) {
  if (c < 3) return x;
  const int j = (c - 3) / 6;
  const float phase = (((c - 3) / 3) & 1) ? HALF_PI : 0.f;
  const float arg = __fadd_rn(__fmul_rn(x, static_cast<float>(1 << j)), phase);
  return FAST ? fast_sin(arg) : sinf(arg);
}

struct RayInputs {
  const float* o_aff;     // (R, 3) ray origins, [near,far] map folded in
  const float* d_aff;     // (R, 3) ray directions, map folded in
  const float* viewdirs;  // (R, 3) unit view directions
  const float* t;         // (R, S) sample depths
  const float* vec;       // packed float32 vector buffer
  int num_rays, S, real_p, real_d;   // real_p: 0 where positions are raw
};

// ---------------------------------------------------------------- compositing

// Thread 0's carry across a forward kernel's chunks: transmittance and the
// running sums of the ray in progress.
struct RaySums {
  float T = 1.f, r = 0.f, g = 0.f, b = 0.f, a = 0.f, d = 0.f;
};

// Compositing of one chunk in sample order (thread 0): weights of its
// points, and rgb/acc/depth of every ray that ends in it.
__device__ __forceinline__ void composite_chunk(
    RaySums& c, const float* t_s, const float* delta_s, const float* sig_s,
    const float* rgb_s, int chunk0, int nvalid, int S,
    float* __restrict__ rgb_out, float* __restrict__ acc_out,
    float* __restrict__ depth_out, float* __restrict__ weights_out) {
  for (int p = 0; p < nvalid; ++p) {
    const int g = chunk0 + p;
    const float one_m = expf(-sig_s[p] * delta_s[p]);
    const float w = c.T * (1.f - one_m);
    weights_out[g] = w;
    c.r = fmaf(w, rgb_s[p], c.r);
    c.g = fmaf(w, rgb_s[P + p], c.g);
    c.b = fmaf(w, rgb_s[2 * P + p], c.b);
    c.a += w;
    c.d = fmaf(w, t_s[p], c.d);
    c.T *= one_m;
    if (g % S == S - 1) {
      const int ray = g / S;
      rgb_out[ray * 3 + 0] = c.r;
      rgb_out[ray * 3 + 1] = c.g;
      rgb_out[ray * 3 + 2] = c.b;
      acc_out[ray] = c.a;
      depth_out[ray] = c.d;
      c = RaySums{};
    }
  }
}

// Per-point columns of the train kernels' stash (each `cap` floats long).
constexpr int C_SIGP = 0, C_RGB = 1, C_T = 4, C_ONEM = 5, C_W = 6,
              C_DZR1 = 7, C_DSIG = 10;

// The train kernels' compositing pass, one thread per ray of the CTA (rays
// ray0 .. ray0+nr, stash rows from 0): transmittance, weights and ray sums
// from the stashed density pre-activation (sigma = relu(sigma_pre) *
// sigma_mul) and rgb, then the per-ray cotangent (TRAIN: the MSE head of
// nerf_tpu/ops/pallas/fused_render.py::_mse_cotangent, with the per-ray
// squared errors in lossr; else the given (R, 8) [g_rgb, g_acc, g_depth]),
// then the compositing backward (_composite_bwd) in reverse sample order:
// the sigmoid input's cotangent dzr1 (times rgb_mul) and the density
// pre-activation's dsig (times sigma_mul, zero where relu is off). Rows
// npts..cap_c-1 get zero cotangents. Ends past a barrier.
template <bool TRAIN>
__device__ void composite_rays(const RayInputs& in, int ray0, int nr, int cap_c,
                               float* cols, size_t cz, float sigma_mul,
                               float rgb_mul, const float* __restrict__ given,
                               float white_bg, float scale,
                               float* __restrict__ rgb_out,
                               float* __restrict__ acc_out,
                               float* __restrict__ weights_out, float* lossr) {
  const int tid = threadIdx.x;
  const int S = in.S;
  for (int r = tid; r < nr; r += THREADS) {
    const int ray = ray0 + r;
    const size_t lb = static_cast<size_t>(r) * S;
    float T = 1.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sa = 0.f, sd = 0.f;
    for (int i = 0; i < S; ++i) {
      const size_t l = lb + i;
      const int g = ray * S + i;
      const float sigma = fmaxf(cols[C_SIGP * cz + l], 0.f) * sigma_mul;
      const float tv = in.t[g];
      const float delta = (i == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
      const float one_m = expf(-sigma * delta);
      const float w = T * (1.f - one_m);
      cols[C_T * cz + l] = T;
      cols[C_ONEM * cz + l] = one_m;
      cols[C_W * cz + l] = w;
      if (TRAIN) weights_out[g] = w;
      s0 = fmaf(w, cols[(C_RGB + 0) * cz + l], s0);
      s1 = fmaf(w, cols[(C_RGB + 1) * cz + l], s1);
      s2 = fmaf(w, cols[(C_RGB + 2) * cz + l], s2);
      sa += w;
      sd = fmaf(w, tv, sd);
      T *= one_m;
    }
    float g0, g1, g2, ga, gd;
    if (TRAIN) {
      rgb_out[ray * 3 + 0] = s0;
      rgb_out[ray * 3 + 1] = s1;
      rgb_out[ray * 3 + 2] = s2;
      acc_out[ray] = sa;
      const float bg = white_bg * (1.f - sa);
      const float e0 = (s0 + bg) - given[ray * 3 + 0];
      const float e1 = (s1 + bg) - given[ray * 3 + 1];
      const float e2 = (s2 + bg) - given[ray * 3 + 2];
      lossr[r] = e0 * e0 + e1 * e1 + e2 * e2;
      g0 = (2.f * scale) * e0;
      g1 = (2.f * scale) * e1;
      g2 = (2.f * scale) * e2;
      ga = -white_bg * (g0 + g1 + g2);
      gd = 0.f;
    } else {
      g0 = given[ray * 8 + 0];
      g1 = given[ray * 8 + 1];
      g2 = given[ray * 8 + 2];
      ga = given[ray * 8 + 3];
      gd = given[ray * 8 + 4];
    }
    float suffix = 0.f;
    for (int i = S - 1; i >= 0; --i) {
      const size_t l = lb + i;
      const int g = ray * S + i;
      const float tv = in.t[g];
      const float delta = (i == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
      const float w = cols[C_W * cz + l];
      const float r0 = cols[(C_RGB + 0) * cz + l];
      const float r1 = cols[(C_RGB + 1) * cz + l];
      const float r2 = cols[(C_RGB + 2) * cz + l];
      const float gw = g0 * r0 + g1 * r1 + g2 * r2 + ga + gd * tv;
      const float gsig = (gw * cols[C_T * cz + l] * cols[C_ONEM * cz + l] - suffix) * delta;
      suffix += gw * w;
      cols[C_DSIG * cz + l] = cols[C_SIGP * cz + l] > 0.f ? gsig * sigma_mul : 0.f;
      cols[(C_DZR1 + 0) * cz + l] = ((g0 * w * r0) * (1.f - r0)) * rgb_mul;
      cols[(C_DZR1 + 1) * cz + l] = ((g1 * w * r1) * (1.f - r1)) * rgb_mul;
      cols[(C_DZR1 + 2) * cz + l] = ((g2 * w * r2) * (1.f - r2)) * rgb_mul;
    }
  }
  for (int l = nr * S + tid; l < cap_c; l += THREADS) {
    cols[C_DSIG * cz + l] = 0.f;
    for (int c = 0; c < 3; ++c) cols[(C_DZR1 + c) * cz + l] = 0.f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- backward

constexpr int LDZ = H;                // row stride of the dz buffers

// What dact does to each output element: nothing, the ReLU mask (zero where
// mref <= 0), or the sine derivative ((v * w0) * mref, mref = cos(w0 z)).
enum class Epi { None, Relu, Cos };

// out[l][col] = EPI(sum_n dz[l][n] W[col][n] (+ dsig[l] wsig[col])) for the
// CTA's points l < cap_c, chunk by chunk, col < 128 * NQ. `wT` is W
// transposed: K rows of 128 * NQ. The dz chunk is staged (rounded to bf16 in
// BF16 mode) into the first activation buffer; `wst` is the weight stage.
template <int K, bool BF16, Epi EPI, bool DSIG, typename WT, int NQ = 2>
__device__ void dact(const float* dz, const WT* __restrict__ wT,
                     const float* mref, int ldm, const float* dsig,
                     const float* __restrict__ wsig, float w0, float* out,
                     int cap_c, float* smem, WT* wst) {
  float* in_s = smem + SM_ACT0;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  constexpr int K4 = K / 4;
  for (int l0 = 0; l0 < cap_c; l0 += P) {
    for (int idx = tid; idx < P * K4; idx += THREADS) {
      const int p = idx / K4, n4 = idx % K4;
      float4 v = *reinterpret_cast<const float4*>(
          dz + static_cast<size_t>(l0 + p) * LDZ + n4 * 4);
      if (BF16) {
        v.x = round_bf16(v.x); v.y = round_bf16(v.y);
        v.z = round_bf16(v.z); v.w = round_bf16(v.w);
      }
      in_s[(n4 * 4 + 0) * LDA + p] = v.x;
      in_s[(n4 * 4 + 1) * LDA + p] = v.y;
      in_s[(n4 * 4 + 2) * LDA + p] = v.z;
      in_s[(n4 * 4 + 3) * LDA + p] = v.w;
    }
    float acc[8][4 * NQ];
    zero<NQ>(acc);
    gemm_acc<K, NQ>(acc, in_s, wT, wst);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = q * 128 + tx * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const size_t row = static_cast<size_t>(l0 + ty * 8 + i);
        float v[4] = {acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2],
                      acc[i][q * 4 + 3]};
        if (DSIG) {
          const float ds = dsig[row];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = v[u] + ds * __ldg(wsig + col + u);
        }
        if (EPI == Epi::Relu) {
          const float4 m = *reinterpret_cast<const float4*>(mref + row * ldm + col);
          v[0] = m.x > 0.f ? v[0] : 0.f;
          v[1] = m.y > 0.f ? v[1] : 0.f;
          v[2] = m.z > 0.f ? v[2] : 0.f;
          v[3] = m.w > 0.f ? v[3] : 0.f;
        } else if (EPI == Epi::Cos) {
          const float4 m = *reinterpret_cast<const float4*>(mref + row * ldm + col);
          v[0] = (v[0] * w0) * m.x;
          v[1] = (v[1] * w0) * m.y;
          v[2] = (v[2] * w0) * m.z;
          v[3] = (v[3] * w0) * m.w;
        }
        *reinterpret_cast<float4*>(out + row * LDZ + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// Stage KT points of an A strip (64 columns from m0) and of B (NN columns).
template <int NQ>
__device__ __forceinline__ void stage_dw(const float* A, int lda, int m0,
                                         const float* B, int kt, float* as,
                                         float* bs) {
  constexpr int NN = 128 * NQ;
  const int tid = threadIdx.x;
  {
    const int row = tid >> 4, c4 = (tid & 15) * 4;
    cp_async16(as + row * 64 + c4,
               A + static_cast<size_t>(kt * KT + row) * lda + m0 + c4);
  }
#pragma unroll
  for (int c = 0; c < 2 * NQ; ++c) {
    const int e = c * THREADS + tid;
    const int row = e / (32 * NQ), c4 = (e % (32 * NQ)) * 4;
    cp_async16(bs + row * NN + c4, B + static_cast<size_t>(kt * KT + row) * LDZ + c4);
  }
  cp_async_commit();
}

// dW staging (in the second activation buffer): 2 x KT x 64 + 2 x KT x 256
static_assert(2 * KT * 64 + 2 * KT * H <= H * LDA, "dW stage does not fit");

// part[m][n] = sum_l A[l][m] B[l][n] for m < mrows, n < 128*NQ, over the
// CTA's points l < cap_c, in 64-row strips of A (width M, stride lda >= 64
// past the last strip's start); B has stride LDZ. RA/RB round the operand
// to bf16 as it is read.
template <int NQ, bool RA, bool RB>
__device__ void dweight(const float* A, int lda, int M, int mrows,
                        const float* B, int cap_c, float* part, float* smem) {
  constexpr int NN = 128 * NQ;
  float* As = smem + SM_ACT1;             // 2 x KT x 64
  float* Bs = As + 2 * KT * 64;           // 2 x KT x NN
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int nt = cap_c / KT;
  for (int m0 = 0; m0 < M; m0 += 64) {
    float acc[8][4 * NQ];
    zero<NQ>(acc);
    stage_dw<NQ>(A, lda, m0, B, 0, As, Bs);
    for (int kt = 0; kt < nt; ++kt) {
      if (kt + 1 < nt) {
        const int nb = (kt + 1) & 1;
        stage_dw<NQ>(A, lda, m0, B, kt + 1, As + nb * KT * 64, Bs + nb * KT * NN);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* as = As + (kt & 1) * KT * 64 + ty * 8;
      const float* bs = Bs + (kt & 1) * KT * NN + tx * 4;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + k * 64);
        const float4 a1 = *reinterpret_cast<const float4*>(as + k * 64 + 4);
        float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[4 * NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + k * NN + q * 128);
          b[4 * q] = bv.x; b[4 * q + 1] = bv.y; b[4 * q + 2] = bv.z; b[4 * q + 3] = bv.w;
        }
        if (RA) {
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = round_bf16(a[i]);
        }
        if (RB) {
#pragma unroll
          for (int j = 0; j < 4 * NQ; ++j) b[j] = round_bf16(b[j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m >= mrows) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        *reinterpret_cast<float4*>(part + static_cast<size_t>(m) * NN + q * 128 + tx * 4) =
            make_float4(acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2],
                        acc[i][q * 4 + 3]);
      }
    }
  }
}

// out[c] = sum over the CTA's points of B[l][c], for c < n (in point order).
__device__ __forceinline__ void colsum(const float* B, int n, int cap_c, float* out) {
  for (int c = threadIdx.x; c < n; c += THREADS) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l) s += B[static_cast<size_t>(l) * LDZ + c];
    out[c] = s;
  }
}

// The direction cotangent of the field kernels' points [p0, p0 + npts)
// (fused_siren.py / fused_gabor.py: _encode_bwd of dzr0 wr0d^T), one thread
// a (point, coordinate): each encoding column's cotangent g_c = sum_k
// dzr0[l][k] wr0d[c][k] over the HR columns of dzr0 (stride LDZ, rounded to
// bf16 in BF16 mode; wr0d is DP x HR), then dx = g_x + sum_c g_c cos(2^j x
// + phase) 2^j with the exact cosine, as the TPU kernels take it.
template <bool BF16, typename WT>
__device__ void direction_cotangent(const float* dzr0, const WT* __restrict__ wr0d,
                                    const float* __restrict__ dirs, int p0, int npts,
                                    int real_d, float* __restrict__ ddirs) {
  for (int idx = threadIdx.x; idx < npts * 3; idx += THREADS) {
    const int l = idx / 3, d = idx % 3;
    const float* row = dzr0 + static_cast<size_t>(l) * LDZ;
    auto g = [&](int c) {
      float s = 0.f;
      for (int k = 0; k < HR; ++k)
        s = fmaf(BF16 ? round_bf16(row[k]) : row[k], load1(wr0d + c * HR + k), s);
      return s;
    };
    const size_t at = static_cast<size_t>(p0 + l) * 3 + d;
    const float x = dirs[at];
    float s = 0.f;
    for (int c = 3 + d; c < real_d; c += 3) {
      const int j = (c - 3) / 6;
      const float phase = (((c - 3) / 3) & 1) ? HALF_PI : 0.f;
      const float scale = static_cast<float>(1 << j);
      const float arg = __fadd_rn(__fmul_rn(x, scale), phase);
      s = fmaf(g(c) * cosf(arg), scale, s);
    }
    ddirs[at] = g(d) + s;
  }
}

// out[i] = sum over CTAs, in CTA order, of partial[cta][i], i <= N_TOT (the
// gradients, and the loss in the last slot).
template <int N_TOT, int NPART>
__global__ void reduce_partials(const float* __restrict__ partial, int ctas,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > N_TOT) return;
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s += partial[static_cast<size_t>(b) * NPART + i];
  out[i] = s;
}

}  // namespace nerf
