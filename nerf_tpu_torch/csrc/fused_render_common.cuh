// The NeRF family's pieces of the fused render kernels and of the NeRF field
// kernels for Hopper (sm_90a): the packed weight layout, the shared-memory
// plan, the encodings of one 64-point chunk (of ray samples, or of given
// points and directions), the MLP of the chunk (the 11-matmul NeRF MLP,
// density and colour), and the MLP backward over a CTA's stashed points.
// fused_render_fwd.cu composites each chunk straight away;
// fused_render_train.cu also stashes every activation for its backward;
// fused_nerf_fwd.cu writes each point's rgb and density, and
// fused_nerf_bwd.cu stashes, runs the backward with its input products and
// the encodings' backward. The generic pieces (gemm, compositing, backward
// blocks) are in render_common.cuh, shared with the other families.
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

// The encodings of ray samples [chunk0, chunk0 + nvalid) (nvalid <= P) into
// shared memory, zero past nvalid, and their t and delta columns. Ends past
// a barrier.
template <bool BF16>
__device__ void encode_ray_chunk(const RayInputs& in, int chunk0, int nvalid,
                                 float* smem) {
  float* penc = smem + SM_PENC;
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* delta_s = smem + SM_DELTA;
  const int tid = threadIdx.x;
  const int S = in.S;

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
}

// The encodings of field points [p0, p0 + nvalid) (nvalid <= P), given with
// their directions, into shared memory, zero past nvalid: the positional and
// the direction encoding both take the degree-11 sine in BF16 mode, as the
// TPU field kernel's _forward_tile (the render kernels encode the view
// direction with the exact sine). Ends past a barrier.
template <bool BF16>
__device__ void encode_point_chunk(const float* __restrict__ pts,
                                   const float* __restrict__ dirs, int p0,
                                   int nvalid, int real_p, int real_d,
                                   float* smem) {
  float* penc = smem + SM_PENC;
  float* denc = smem + SM_DENC;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < PP * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid && c < real_p) {
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<BF16>(pts[static_cast<size_t>(p0 + p) * 3 + d], c);
      if (BF16) v = round_bf16(v);
    }
    penc[c * LDA + p] = v;
  }
  for (int idx = tid; idx < DP * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid && c < real_d) {
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<BF16>(dirs[static_cast<size_t>(p0 + p) * 3 + d], c);
      if (BF16) v = round_bf16(v);
    }
    denc[c * LDA + p] = v;
  }
  __syncthreads();
}

// The MLP of the chunk whose encodings are in shared memory: leaves sigma
// (after the ReLU) and rgb of each of its P points in shared memory. With
// STASH every activation also goes to `st` at local rows l0.. (all P rows,
// the ones past the chunk's points from zero encodings).
template <bool BF16, bool STASH, typename WT>
__device__ void mlp_chunk(const float* __restrict__ vec, const WT* __restrict__ wmat,
                          float* smem, const Stash& st, size_t l0) {
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* penc = smem + SM_PENC;
  float* denc = smem + SM_DENC;
  float* sig_s = smem + SM_SIGMA;
  float* rgb_s = smem + SM_RGB;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  const int tid = threadIdx.x;

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

// The forward of ray samples [chunk0, chunk0 + nvalid) (nvalid <= P): leaves
// t, delta, sigma (after the ReLU) and rgb of each point in shared memory,
// and with STASH every activation in `st` (see mlp_chunk).
template <bool BF16, bool STASH, typename WT>
__device__ void forward_chunk(const RayInputs& in, const WT* __restrict__ wmat,
                              int chunk0, int nvalid, float* smem,
                              const Stash& st, size_t l0) {
  encode_ray_chunk<BF16>(in, chunk0, nvalid, smem);
  mlp_chunk<BF16, STASH>(in.vec, wmat, smem, st, l0);
}

// ---------------------------------------------------------------- backward

constexpr int N_TOT = N_W + N_B;                 // gradient floats
constexpr int NPART = (N_TOT + 1 + 3) / 4 * 4;   // per-CTA: gradients, loss
constexpr int N_COLS = 12;                       // per-point columns (C_*)

// Scratch floats per stashed point of a backward kernel with NDZ dz buffers
// (points x LDZ each): the stash, the dz buffers and the per-point columns.
template <int NDZ>
__host__ __device__ constexpr int floats_per_point() {
  return 9 * H + H + HR + PP + PP + NDZ * LDZ + N_COLS;
}

// One CTA's scratch: the stash, up to three dz buffers, the columns.
struct Scratch {
  Stash st;
  float* dz[3];
  float* cols;            // N_COLS x cap
};

template <int NDZ>
__device__ Scratch carve(float* p, int cap) {
  static_assert(floats_per_point<NDZ>() % 4 == 0,
                "stash rows must stay 16-byte aligned");
  Scratch s;
  const size_t c = static_cast<size_t>(cap);
  for (int i = 0; i < 9; ++i) { s.st.h[i] = p; p += c * H; }
  s.st.feat = p; p += c * H;
  s.st.y = p; p += c * HR;
  s.st.penc = p; p += c * PP;
  s.st.denc = p; p += c * PP;
  for (int i = 0; i < NDZ; ++i) { s.dz[i] = p; p += c * LDZ; }
  for (int i = NDZ; i < 3; ++i) s.dz[i] = nullptr;
  s.cols = p;
  s.st.sigma_pre = p + C_SIGP * c;
  s.st.rgb = p + C_RGB * c;
  s.st.cap = cap;
  return s;
}

// One hidden layer of the backward: from cur = dz_L, the next dz
// (dz_L W_L^T masked by h_prev > 0) into nxt, dW_L = h_prev^T dz_L and
// db_L = sum dz_L.
template <bool BF16, typename WT>
__device__ void back_layer(const float* cur, const WT* __restrict__ wT,
                           const float* h_prev, float* nxt, float* part_w,
                           float* part_b, int cap_c, float* smem) {
  if (nxt != nullptr)
    dact<H, BF16, Epi::Relu, false>(cur, wT, h_prev, H, nullptr, nullptr, 1.f, nxt,
                                    cap_c, smem, reinterpret_cast<WT*>(smem + SM_WST));
  dweight<2, false, BF16>(h_prev, H, H, H, cur, cap_c, part_w, smem);
  colsum(cur, H, cap_c, part_b);
  __syncthreads();
}

// Offsets in the field backward's buffer of input-product matrices: w1^T and
// w6p^T (H rows) and wr0d^T (HR rows), each zero-padded to HR columns.
constexpr int OFF_T_W1 = 0;
constexpr int OFF_T_W6P = OFF_T_W1 + H * HR;
constexpr int OFF_T_WR0D = OFF_T_W6P + H * HR;
constexpr int N_T_IN = OFF_T_WR0D + HR * HR;

// The MLP backward (fused_nerf.py::_mlp_bwd_core) over the CTA's points
// l < cap_c, layer by layer, from the stash and the cotangent columns dzr1
// and dsig: each dz (points x 256, float32, unrounded) is computed chunk by
// chunk into the next dz buffer (dz W^T on the register-tiled gemm, against
// the transposed matrices wmat_t), and each weight gradient is one product
// A^T dz over all the CTA's points, written once per CTA into `part`
// (offsets of the packed layout, the vectors from N_W); bias and w10s
// gradients are column sums. With INPUTS (the field backward) also the
// input products, against `wt_in` (OFF_T_*): dz6 w6p^T into columns
// [0, HR) and dzr0 wr0d^T into [HR, H) of sc.dz[2], and dz1 w1^T into
// columns [0, HR) of sc.dz[1]; it then ends past a barrier. Rounding in
// BF16 mode follows _mlp_bwd_core: both operands of every dW product and
// the dz of every dz W^T are rounded to bf16, sums are float32, and h9,
// sigma_pre and the rgb sigmoid are read in float32.
template <bool BF16, bool INPUTS, typename WT>
__device__ void mlp_backward(const Scratch& sc, size_t cz, const float* __restrict__ vec,
                             const WT* __restrict__ wmat, const WT* __restrict__ wmat_t,
                             const WT* __restrict__ wt_in, float* part, int cap_c,
                             float* smem) {
  const int tid = threadIdx.x;
  const float* cols = sc.cols;
  const float* dsig = cols + C_DSIG * cz;
  const float* h9 = sc.st.h[8];
  float* dzA = sc.dz[0];
  float* dzB = sc.dz[1];
  float* pvec = part + N_W;
  // rgb output layer: dy = dzr1 wr1^T (3 live columns), dzr0 = dy * (y > 0)
  for (int idx = tid; idx < cap_c * HR; idx += THREADS) {
    const int l = idx / HR, k = idx % HR;
    float dy = 0.f;
    for (int c = 0; c < 3; ++c) {
      float d = cols[(C_DZR1 + c) * cz + l];
      if (BF16) d = round_bf16(d);
      dy = fmaf(d, load1(wmat + OFF_WR1 + k * 8 + c), dy);
    }
    dzA[static_cast<size_t>(l) * LDZ + k] =
        sc.st.y[static_cast<size_t>(l) * HR + k] > 0.f ? dy : 0.f;
  }
  for (int o = tid; o < HR * 8; o += THREADS) {
    const int k = o / 8, c = o % 8;
    float s = 0.f;
    if (c < 3) {
      for (int l = 0; l < cap_c; ++l) {
        float d = cols[(C_DZR1 + c) * cz + l];
        if (BF16) d = round_bf16(d);
        s = fmaf(sc.st.y[static_cast<size_t>(l) * HR + k], d, s);
      }
    }
    part[OFF_WR1 + o] = s;
  }
  for (int c = tid; c < 8; c += THREADS) {
    float s = 0.f;
    if (c < 3)
      for (int l = 0; l < cap_c; ++l) s += cols[(C_DZR1 + c) * cz + l];
    pvec[OFF_BR1 + c] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l) s += dsig[l];
    pvec[OFF_B10S] = s;
  }
  for (int k = tid; k < H; k += THREADS) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l)
      s = fmaf(h9[static_cast<size_t>(l) * H + k], dsig[l], s);
    pvec[OFF_W10S + k] = s;
  }
  __syncthreads();
  // rgb hidden layer: dfeat = dzr0 wr0f^T; wr0f, wr0d, br0 (and ddenc)
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  dact<HR, BF16, Epi::None, false>(dzA, wmat_t + OFF_WR0F, nullptr, 0, nullptr,
                                   nullptr, 1.f, dzB, cap_c, smem, wst);
  if constexpr (INPUTS)
    dact<HR, BF16, Epi::None, false, WT, 1>(dzA, wt_in + OFF_T_WR0D, nullptr, 0,
                                            nullptr, nullptr, 1.f, sc.dz[2] + HR,
                                            cap_c, smem, wst);
  dweight<1, false, BF16>(sc.st.feat, H, H, H, dzA, cap_c, part + OFF_WR0F, smem);
  dweight<1, false, BF16>(sc.st.denc, PP, PP, DP, dzA, cap_c, part + OFF_WR0D, smem);
  colsum(dzA, HR, cap_c, pvec + OFF_BR0);
  __syncthreads();
  // feature head: dz9 = (dfeat w10f^T + dsig w10s) * (h9 > 0); w10f, b10f
  dact<H, BF16, Epi::Relu, true>(dzB, wmat_t + OFF_W10F, h9, H, dsig, vec + OFF_W10S,
                                 1.f, dzA, cap_c, smem, wst);
  dweight<2, BF16, BF16>(h9, H, H, H, dzB, cap_c, part + OFF_W10F, smem);
  colsum(dzB, H, cap_c, pvec + OFF_B10F);
  __syncthreads();
  // block2 and block1
  back_layer<BF16>(dzA, wmat_t + OFF_W9, sc.st.h[7], dzB, part + OFF_W9, pvec + 8 * H, cap_c, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W8, sc.st.h[6], dzA, part + OFF_W8, pvec + 7 * H, cap_c, smem);
  back_layer<BF16>(dzA, wmat_t + OFF_W7, sc.st.h[5], dzB, part + OFF_W7, pvec + 6 * H, cap_c, smem);
  // the skip layer: dz5 from w6h; w6h from h5, w6p from the position encoding
  dweight<2, false, BF16>(sc.st.penc, PP, PP, PP, dzB, cap_c, part + OFF_W6P, smem);
  if constexpr (INPUTS)
    dact<H, BF16, Epi::None, false, WT, 1>(dzB, wt_in + OFF_T_W6P, nullptr, 0, nullptr,
                                           nullptr, 1.f, sc.dz[2], cap_c, smem, wst);
  back_layer<BF16>(dzB, wmat_t + OFF_W6H, sc.st.h[4], dzA, part + OFF_W6H, pvec + 5 * H, cap_c, smem);
  back_layer<BF16>(dzA, wmat_t + OFF_W5, sc.st.h[3], dzB, part + OFF_W5, pvec + 4 * H, cap_c, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W4, sc.st.h[2], dzA, part + OFF_W4, pvec + 3 * H, cap_c, smem);
  back_layer<BF16>(dzA, wmat_t + OFF_W3, sc.st.h[1], dzB, part + OFF_W3, pvec + 2 * H, cap_c, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W2, sc.st.h[0], dzA, part + OFF_W2, pvec + 1 * H, cap_c, smem);
  // first layer: w1 from the position encoding (and dz1 w1^T)
  dweight<2, false, BF16>(sc.st.penc, PP, PP, PP, dzA, cap_c, part + OFF_W1, smem);
  colsum(dzA, H, cap_c, pvec + 0 * H);
  if constexpr (INPUTS) {
    dact<H, BF16, Epi::None, false, WT, 1>(dzA, wt_in + OFF_T_W1, nullptr, 0, nullptr,
                                           nullptr, 1.f, dzB, cap_c, smem, wst);
    __syncthreads();
  }
}

}  // namespace nerf
