// The NeRF family's pieces of the fused render kernels for Hopper (sm_90a):
// the packed weight layout, the shared-memory plan, and the forward of one
// 64-point chunk (positional encoding, the 11-matmul NeRF MLP, density and
// colour). fused_render_fwd.cu composites the chunk straight away;
// fused_render_train.cu also stashes every activation for its backward.
// The generic pieces (gemm, compositing, backward blocks) are in
// render_common.cuh, shared with the SIREN family.
//
// The MLP is the one of nerf_tpu/ops/pallas/fused_nerf.py::_mlp_tile: block1
// (5 layers), block2 with the skip input (4 layers), a split 257-wide head
// (256 features, one density row reduced in float32 from the unrounded h9),
// and the view-dependent rgb head. In bfloat16 mode every matmul input and
// weight is rounded to bf16 and the products are summed in float32.

#pragma once

#include "render_common.cuh"

namespace nerf {

constexpr int PP = 64;        // padded position-encoding width

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

// Shared memory (floats) after the two activation buffers: the two
// encodings, the per-point chunk columns, then the weight stage (2 x KT x H
// of float32).
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
