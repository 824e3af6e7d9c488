// Shared pieces of the fused NeRF render kernels for Hopper (sm_90a):
// the packed weight layout, the shared-memory plan, and the forward of one
// 64-point chunk (positional encoding, the 11-matmul NeRF MLP, density and
// colour). fused_render_fwd.cu composites the chunk straight away;
// fused_render_train.cu also stashes every activation for its backward.
//
// The MLP is the one of nerf_tpu/ops/pallas/fused_nerf.py::_mlp_tile: block1
// (5 layers), block2 with the skip input (4 layers), a split 257-wide head
// (256 features, one density row reduced in float32 from the unrounded h9),
// and the view-dependent rgb head. In bfloat16 mode every matmul input and
// weight is rounded to bf16 and the products are summed in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf {

constexpr int H = 256;        // hidden width (the only one supported)
constexpr int HR = H / 2;     // rgb-head width
constexpr int PP = 64;        // padded position-encoding width
constexpr int DP = 32;        // padded direction-encoding width
constexpr int P = 64;         // points per chunk
constexpr int LDA = P + 4;    // row stride (floats) of activation tiles
constexpr int KT = 16;        // weight rows per staged tile
constexpr int THREADS = 256;

// Packed matrix buffer: each matrix (K, N) row-major, (in, out) order, K
// padded with zero rows (w1/w6p to PP, wr0d to DP), wr1 padded to 8 columns.
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + PP * H;
constexpr int OFF_W3 = OFF_W2 + H * H;
constexpr int OFF_W4 = OFF_W3 + H * H;
constexpr int OFF_W5 = OFF_W4 + H * H;
constexpr int OFF_W6H = OFF_W5 + H * H;
constexpr int OFF_W6P = OFF_W6H + H * H;
constexpr int OFF_W7 = OFF_W6P + PP * H;
constexpr int OFF_W8 = OFF_W7 + H * H;
constexpr int OFF_W9 = OFF_W8 + H * H;
constexpr int OFF_W10F = OFF_W9 + H * H;
constexpr int OFF_WR0F = OFF_W10F + H * H;
constexpr int OFF_WR0D = OFF_WR0F + H * HR;
constexpr int OFF_WR1 = OFF_WR0D + DP * HR;
constexpr int N_W = OFF_WR1 + HR * 8;

// Packed float32 vector buffer: b1..b9, b10f, w10s (rounded to the compute
// dtype), br0, br1 (8), b10s.
constexpr int OFF_B10F = 9 * H;
constexpr int OFF_W10S = 10 * H;
constexpr int OFF_BR0 = 11 * H;
constexpr int OFF_BR1 = OFF_BR0 + HR;
constexpr int OFF_B10S = OFF_BR1 + 8;
constexpr int N_B = OFF_B10S + 1;

// Shared memory (floats): two activation buffers, the two encodings, the
// per-point chunk columns, then the weight stage (2 x KT x H of float32).
constexpr int SM_ACT0 = 0;
constexpr int SM_ACT1 = SM_ACT0 + H * LDA;
constexpr int SM_PENC = SM_ACT1 + H * LDA;
constexpr int SM_DENC = SM_PENC + PP * LDA;
constexpr int SM_T = SM_DENC + DP * LDA;
constexpr int SM_DELTA = SM_T + P;
constexpr int SM_SIGMA = SM_DELTA + P;
constexpr int SM_RGB = SM_SIGMA + P;         // 3 x P
constexpr int SM_WST = SM_RGB + 3 * P;
constexpr int SMEM_BYTES = SM_WST * 4 + 2 * KT * H * 4;
static_assert(SM_WST % 4 == 0, "weight stage must be 16-byte aligned");
static_assert(SMEM_BYTES <= 232448, "exceeds the per-block shared memory");

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

// Positional encoding of one coordinate, column c of [x, sin(2^j x),
// sin(2^j x + pi/2), ...] (the cos columns as a phase-shifted sine, as the
// TPU kernel builds them).
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
  int num_rays, S, real_p, real_d;
};

// Where the train kernels keep one CTA's activations, point-major with the
// CTA-local point index as the row: h[0..8] = h1..h9 (h9 unrounded), feat,
// y, penc, denc (stride PP, columns past DP zero), and the per-point
// columns sigma_pre and rgb (3 arrays).
struct Stash {
  float* h[9];
  float* feat;
  float* y;
  float* penc;
  float* denc;
  float* sigma_pre;
  float* rgb;             // rgb + c * cap is channel c
  int cap;
};

// The forward of points [chunk0, chunk0 + nvalid) (nvalid <= P): leaves t,
// delta, sigma (after the ReLU) and rgb of each point in shared memory. With
// STASH every activation also goes to `st` at local rows l0.. (all P rows,
// the ones past nvalid from zero encodings).
template <bool BF16, bool STASH, typename WT>
__device__ void forward_chunk(const RayInputs& in, const WT* __restrict__ wmat,
                              int chunk0, int nvalid, float* smem,
                              const Stash& st, size_t l0) {
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* penc = smem + SM_PENC;
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* delta_s = smem + SM_DELTA;
  float* sig_s = smem + SM_SIGMA;
  float* rgb_s = smem + SM_RGB;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  const float* vec = in.vec;
  const int tid = threadIdx.x;
  const int S = in.S;

  // ---- encodings and per-point columns ----
  for (int idx = tid; idx < PP * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid && c < in.real_p) {
      const int g = chunk0 + p;
      const int ray = g / S;
      const int d = c < 3 ? c : (c - 3) % 3;
      const float x = __fadd_rn(in.o_aff[ray * 3 + d],
                                __fmul_rn(in.t[g], in.d_aff[ray * 3 + d]));
      v = encode_col<BF16>(x, c);
      if (BF16) v = round_bf16(v);
    }
    penc[c * LDA + p] = v;
  }
  for (int idx = tid; idx < DP * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid && c < in.real_d) {
      const int ray = (chunk0 + p) / S;
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<false>(in.viewdirs[ray * 3 + d], c);
      if (BF16) v = round_bf16(v);
    }
    denc[c * LDA + p] = v;
  }
  if (tid < P) {
    const int g = chunk0 + tid;
    float tv = 0.f, dv = 0.f;
    if (tid < nvalid) {
      tv = in.t[g];
      dv = (g % S == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
    }
    t_s[tid] = tv;
    delta_s[tid] = dv;
  }
  __syncthreads();
  if (STASH) {
    for (int idx = tid; idx < P * PP; idx += THREADS) {
      const int p = idx / PP, c = idx % PP;
      st.penc[(l0 + p) * PP + c] = penc[c * LDA + p];
      st.denc[(l0 + p) * PP + c] = c < DP ? denc[c * LDA + p] : 0.f;
    }
  }
#define sh(i) (STASH ? st.h[i] : nullptr)

  float acc2[8][8];
  float acc1[8][4];
  // ---- block1 ----
  zero<2>(acc2);
  gemm_acc<PP, 2>(acc2, penc, wmat + OFF_W1, wst);
  epilogue<2, BF16>(acc2, vec + 0 * H, true, act0, sh(0), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + OFF_W2, wst);
  epilogue<2, BF16>(acc2, vec + 1 * H, true, act1, sh(1), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act1, wmat + OFF_W3, wst);
  epilogue<2, BF16>(acc2, vec + 2 * H, true, act0, sh(2), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + OFF_W4, wst);
  epilogue<2, BF16>(acc2, vec + 3 * H, true, act1, sh(3), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act1, wmat + OFF_W5, wst);
  epilogue<2, BF16>(acc2, vec + 4 * H, true, act0, sh(4), H, l0);
  // ---- block2: skip input, then 3 more layers ----
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + OFF_W6H, wst);
  gemm_acc<PP, 2>(acc2, penc, wmat + OFF_W6P, wst);
  epilogue<2, BF16>(acc2, vec + 5 * H, true, act1, sh(5), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act1, wmat + OFF_W7, wst);
  epilogue<2, BF16>(acc2, vec + 6 * H, true, act0, sh(6), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + OFF_W8, wst);
  epilogue<2, BF16>(acc2, vec + 7 * H, true, act1, sh(7), H, l0);
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act1, wmat + OFF_W9, wst);
  {
    // h9 = relu(acc + b9). The density is a float32 reduction of the
    // UNROUNDED h9 against w10s: each thread sums its 8 columns, the
    // warp's 32 lanes (same 8 points, all 256 columns) reduce by shuffle.
    const int tx = tid & 31, ty = tid >> 5;
    float part[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j >> 2) * 128 + tx * 4 + (j & 3);
      const float b = __ldg(vec + 8 * H + col);
      const float ws = __ldg(vec + OFF_W10S + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc2[i][j] = fmaxf(acc2[i][j] + b, 0.f);
        part[i] = fmaf(acc2[i][j], ws, part[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
    }
    if (tx == 0) {
      const float b10s = __ldg(vec + OFF_B10S);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sig_s[ty * 8 + i] = fmaxf(part[i] + b10s, 0.f);
        if (STASH) st.sigma_pre[l0 + ty * 8 + i] = part[i] + b10s;
      }
    }
    // bias and relu are in; store h9 (rounded in bf16 mode; the stash
    // keeps it unrounded: the backward reads it in float32)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = q * 4 + u;
        const int col = q * 128 + tx * 4 + u;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = BF16 ? round_bf16(acc2[i][j]) : acc2[i][j];
        float* dst = act0 + col * LDA + ty * 8;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
      if (STASH) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* g = st.h[8] + (l0 + ty * 8 + i) * H + q * 128 + tx * 4;
          *reinterpret_cast<float4*>(g) =
              make_float4(acc2[i][q * 4], acc2[i][q * 4 + 1], acc2[i][q * 4 + 2],
                          acc2[i][q * 4 + 3]);
        }
      }
    }
  }
  // feature head: no activation
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + OFF_W10F, wst);
  epilogue<2, BF16>(acc2, vec + OFF_B10F, false, act1,
                    STASH ? st.feat : nullptr, H, l0);
  // ---- rgb head ----
  zero<1>(acc1);
  gemm_acc<H, 1>(acc1, act1, wmat + OFF_WR0F, wst);
  gemm_acc<DP, 1>(acc1, denc, wmat + OFF_WR0D, wst);
  epilogue<1, BF16>(acc1, vec + OFF_BR0, true, act0,
                    STASH ? st.y : nullptr, HR, l0);
#undef sh
  __syncthreads();
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(act0[k * LDA + p], load1(wmat + OFF_WR1 + k * 8 + c), z);
    z += __ldg(vec + OFF_BR1 + c);
    const float r = 1.f / (1.f + expf(-z));
    rgb_s[c * P + p] = r;
    if (STASH) st.rgb[static_cast<size_t>(c) * st.cap + l0 + p] = r;
  }
  __syncthreads();
}

}  // namespace nerf
