// The SIREN family's pieces of the fused render kernels for Hopper (sm_90a):
// the packed weight layout, the shared-memory plan, and the forward of one
// 64-point chunk. fused_render_siren_fwd.cu composites the chunk straight
// away; fused_render_siren_train.cu also stashes what its backward needs.
// The generic pieces (gemm, compositing, backward blocks) are in
// render_common.cuh, shared with the NeRF family.
//
// The MLP is the one of nerf_tpu/ops/pallas/fused_siren.py::_mlp_tile on
// raw positions p = o_aff + t d_aff (no positional encoding):
//   h_l = sin(w0_l (h_{l-1} W_l + b_l)), l = 1..8, h_0 = p, w0_1 = w0 (30),
//         w0_l = w0h (1) after it;
//   sigma = relu(h8 . ws + bs) * sigma_mul, in float32 from the UNROUNDED h8;
//   feat = h8 Wre + bre (no activation);
//   y = sin(w0h (feat Wr0f + denc Wr0d + br0)), denc the frequency encoding
//         of the view direction (exact sine);
//   rgb = sigmoid((y Wr1 + br1) * rgb_mul).
// In bfloat16 mode every matmul input and weight is rounded to bf16 (the raw
// positions too), the products are summed in float32, and the sines and
// cosines of the layers are the degree-11 fast_sin (cos x = fast_sin(x +
// pi/2)), as the TPU kernels' _trig. In float32 they are sinf/cosf: |w0 z|
// reaches tens of radians, so no __sinf and no fast math.

#pragma once

#include "render_common.cuh"

namespace siren {

using namespace nerf;

constexpr int NL = 8;         // sine layers (the only depth supported)

// Packed matrix buffer: each matrix (K, N) row-major, (in, out) order: w1
// (8 x H, rows 3..7 zero), w2..w8, wre, wr0f (H x HR), wr0d (DP x HR, zero
// rows past the real encoding), wr1 (HR x 8, zero columns past 3).
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + 8 * H;
constexpr int OFF_WRE = OFF_W2 + 7 * H * H;
constexpr int OFF_WR0F = OFF_WRE + H * H;
constexpr int OFF_WR0D = OFF_WR0F + H * HR;
constexpr int OFF_WR1 = OFF_WR0D + DP * HR;
constexpr int N_W = OFF_WR1 + HR * 8;
__host__ __device__ constexpr int off_w(int l) {
  return l == 1 ? OFF_W1 : OFF_W2 + (l - 2) * H * H;
}

// Packed float32 vector buffer: b1..b8, bre, ws (rounded to the compute
// dtype), br0, br1 (8), bs.
constexpr int OFF_BRE = 8 * H;
constexpr int OFF_WS = 9 * H;
constexpr int OFF_BR0 = 10 * H;
constexpr int OFF_BR1 = OFF_BR0 + HR;
constexpr int OFF_BS = OFF_BR1 + 8;
constexpr int N_B = OFF_BS + 1;

// Shared memory (floats) after the two activation buffers: the raw
// positions (3 x P, padded to 4 x P), the direction encoding, the per-point
// chunk columns, then the weight stage (2 x KT x H of float32).
constexpr int SM_POS = SM_ACT1 + H * LDA;
constexpr int SM_DENC = SM_POS + 4 * P;
constexpr int SM_T = SM_DENC + DP * LDA;
constexpr int SM_DELTA = SM_T + P;
constexpr int SM_SIGMA = SM_DELTA + P;
constexpr int SM_RGB = SM_SIGMA + P;         // 3 x P
constexpr int SM_WST = SM_RGB + 3 * P;
constexpr int SMEM_BYTES = SM_WST * 4 + 2 * KT * H * 4;
static_assert(SM_WST % 4 == 0, "weight stage must be 16-byte aligned");
static_assert(SMEM_BYTES <= 232448, "exceeds the per-block shared memory");

// The model's scalars: first-layer and hidden w0, the density and colour
// multipliers.
struct Siren {
  float w0, w0h, sigma_mul, rgb_mul;
};

template <bool FAST>
__device__ __forceinline__ float sine(float x) {
  return FAST ? fast_sin(x) : sinf(x);
}
template <bool FAST>
__device__ __forceinline__ float cosine(float x) {
  return FAST ? fast_sin(__fadd_rn(x, HALF_PI)) : cosf(x);
}

constexpr int DENC_LD = 64;   // stash stride of denc (dweight reads 64 columns)

// Where the train kernels keep one CTA's activations, point-major with the
// CTA-local point index as the row: h[0..7] = h1..h8 (h1..h7 rounded to the
// compute dtype, h8 unrounded: the density row reads it in float32) and
// c[0..7] = cos(w0_l z_l) (the sine's derivative without w0), feat, y and
// cr0 = cos(w0h zr0), denc (stride DENC_LD, columns past DP zero), and the
// per-point columns sigma_pre, rgb (3) and the raw positions (3, rounded to
// the compute dtype).
struct Stash {
  float* h[NL];
  float* c[NL];
  float* feat;
  float* y;
  float* cr0;
  float* denc;
  float* sigma_pre;
  float* rgb;             // rgb + k * cap is channel k
  float* pos;             // pos + k * cap is coordinate k
  int cap;
};

// A sine layer's epilogue: z = acc + bias, arg = w0 z, h = sin(arg);
// out[col][ty*8+i] = h (rounded to bf16 in bf16 mode). acc is left holding
// arg. SIGMA (the last layer) also adds h . ws of the thread's columns into
// part, in float32 on the unrounded h. With STASH, h goes to hs (unrounded
// when SIGMA, else as stored) and cos(arg) to cs, point-major, row
// l0+ty*8+i, stride ld.
template <int NQ, bool BF16, bool STASH, bool SIGMA>
__device__ __forceinline__ void sine_epilogue(float (&acc)[8][4 * NQ],
                                              const float* __restrict__ bias,
                                              float w0, float* out_s, float* hs,
                                              float* cs, int ld, size_t l0,
                                              const float* __restrict__ ws,
                                              float (&part)[8]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = q * 128 + tx * 4 + u;
      const float b = __ldg(bias + col);
      const float wsv = SIGMA ? __ldg(ws + col) : 0.f;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float arg = __fmul_rn(w0, acc[i][q * 4 + u] + b);
        acc[i][q * 4 + u] = arg;
        const float h = sine<BF16>(arg);
        if (SIGMA) part[i] = fmaf(h, wsv, part[i]);
        o[i] = BF16 ? round_bf16(h) : h;
        v[u][i] = SIGMA ? h : o[i];
      }
      float* dst = out_s + col * LDA + ty * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
    }
    if (STASH) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const size_t off = (l0 + ty * 8 + i) * ld + q * 128 + tx * 4;
        *reinterpret_cast<float4*>(hs + off) =
            make_float4(v[0][i], v[1][i], v[2][i], v[3][i]);
        *reinterpret_cast<float4*>(cs + off) = make_float4(
            cosine<BF16>(acc[i][q * 4]), cosine<BF16>(acc[i][q * 4 + 1]),
            cosine<BF16>(acc[i][q * 4 + 2]), cosine<BF16>(acc[i][q * 4 + 3]));
      }
    }
  }
}

// The forward of points [chunk0, chunk0 + nvalid) (nvalid <= P): leaves t,
// delta, sigma (after the ReLU and sigma_mul) and rgb of each point in
// shared memory. With STASH what the backward needs also goes to `st` at
// local rows l0.. (all P rows, the ones past nvalid from zero inputs).
template <bool BF16, bool STASH, typename WT>
__device__ void forward_chunk(const RayInputs& in, const WT* __restrict__ wmat,
                              const Siren& sp, int chunk0, int nvalid,
                              float* smem, const Stash& st, size_t l0) {
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* pos = smem + SM_POS;
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* delta_s = smem + SM_DELTA;
  float* sig_s = smem + SM_SIGMA;
  float* rgb_s = smem + SM_RGB;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  const float* vec = in.vec;
  const int tid = threadIdx.x;
  const int S = in.S;

  // ---- raw positions, direction encoding, per-point columns ----
  for (int idx = tid; idx < 3 * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid) {
      const int g = chunk0 + p;
      const int ray = g / S;
      v = __fadd_rn(in.o_aff[ray * 3 + c], __fmul_rn(in.t[g], in.d_aff[ray * 3 + c]));
      if (BF16) v = round_bf16(v);
    }
    pos[c * P + p] = v;
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
    for (int idx = tid; idx < P * DENC_LD; idx += THREADS) {
      const int p = idx / DENC_LD, c = idx % DENC_LD;
      st.denc[(l0 + p) * DENC_LD + c] = c < DP ? denc[c * LDA + p] : 0.f;
    }
    for (int idx = tid; idx < 3 * P; idx += THREADS) {
      const int c = idx / P, p = idx % P;
      st.pos[static_cast<size_t>(c) * st.cap + l0 + p] = pos[c * P + p];
    }
  }
#define HS(l) (STASH ? st.h[l] : nullptr)
#define CS(l) (STASH ? st.c[l] : nullptr)

  const int tx = tid & 31, ty = tid >> 5;
  float acc2[8][8];
  float acc1[8][4];
  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = 0.f;

  // ---- layer 1 (K = 3): straight from the positions ----
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float w[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) load4(wmat + OFF_W1 + k * H + q * 128 + tx * 4, w[k]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      const float x0 = pos[p], x1 = pos[P + p], x2 = pos[2 * P + p];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float a = fmaf(x0, w[0][u], 0.f);
        a = fmaf(x1, w[1][u], a);
        acc2[i][q * 4 + u] = fmaf(x2, w[2][u], a);
      }
    }
  }
  sine_epilogue<2, BF16, STASH, false>(acc2, vec + 0 * H, sp.w0, act0, HS(0), CS(0),
                                       H, l0, nullptr, part);
  // ---- sine layers 2..7, ping-pong between the activation buffers ----
#pragma unroll 1
  for (int l = 2; l < NL; ++l) {
    const float* src = (l & 1) ? act1 : act0;
    float* dst = (l & 1) ? act0 : act1;
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, src, wmat + off_w(l), wst);
    sine_epilogue<2, BF16, STASH, false>(acc2, vec + (l - 1) * H, sp.w0h, dst,
                                         HS(l - 1), CS(l - 1), H, l0, nullptr, part);
  }
  // ---- layer 8 (act0 -> act1) and the density row ----
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + off_w(NL), wst);
  sine_epilogue<2, BF16, STASH, true>(acc2, vec + (NL - 1) * H, sp.w0h, act1,
                                      HS(NL - 1), CS(NL - 1), H, l0, vec + OFF_WS, part);
  // each thread summed h8 . ws over its 8 columns; the warp's 32 lanes (same
  // 8 points, all 256 columns) reduce by shuffle
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
  }
  if (tx == 0) {
    const float bs = __ldg(vec + OFF_BS);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sp_pre = part[i] + bs;
      sig_s[ty * 8 + i] = fmaxf(sp_pre, 0.f) * sp.sigma_mul;
      if (STASH) st.sigma_pre[l0 + ty * 8 + i] = sp_pre;
    }
  }
  // ---- feature remap: no activation (act1 -> act0) ----
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act1, wmat + OFF_WRE, wst);
  epilogue<2, BF16>(acc2, vec + OFF_BRE, false, act0, STASH ? st.feat : nullptr, H, l0);
  // ---- rgb head: sine layer on [feat, denc] (-> act1), then the output ----
  zero<1>(acc1);
  gemm_acc<H, 1>(acc1, act0, wmat + OFF_WR0F, wst);
  gemm_acc<DP, 1>(acc1, denc, wmat + OFF_WR0D, wst);
  sine_epilogue<1, BF16, STASH, false>(acc1, vec + OFF_BR0, sp.w0h, act1,
                                       STASH ? st.y : nullptr, STASH ? st.cr0 : nullptr,
                                       HR, l0, nullptr, part);
#undef HS
#undef CS
  __syncthreads();
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(act1[k * LDA + p], load1(wmat + OFF_WR1 + k * 8 + c), z);
    z = (z + __ldg(vec + OFF_BR1 + c)) * sp.rgb_mul;
    const float r = 1.f / (1.f + expf(-z));
    rgb_s[c * P + p] = r;
    if (STASH) st.rgb[static_cast<size_t>(c) * st.cap + l0 + p] = r;
  }
  __syncthreads();
}

}  // namespace siren
