// The GaborNet family's pieces of the fused render kernels for Hopper
// (sm_90a): the packed weight layout, the shared-memory plan, the filters,
// and the forward of one 64-point chunk. fused_render_gabor_fwd.cu composites
// the chunk straight away; fused_render_gabor_train.cu also stashes what its
// backward needs. The generic pieces (gemm, compositing, backward blocks)
// are in render_common.cuh, shared with the NeRF and SIREN families.
//
// The network is the one of nerf_tpu/ops/pallas/fused_render_gabor.py::
// _mlp_tile. With x = o' + t d' each Gabor filter of stage i is
//   g_i = sin(A + t B) * exp(P + t Q + t^2 R)
// from five per-ray coefficients (A, B, P, Q, R: the float32 prep outside
// the kernel, (5, R, 8 x 256), -gamma/2 folded into P, Q, R), and
//   z_1 = g_1,  u_i = z_{i-1} W_{i-1} + b_{i-1},  z_i = u_i * g_i (i = 2..8);
//   sigma = relu(z_8 . ws + bs) * sigma_mul, in float32 from the UNROUNDED
//         z_8 (the JAX module rounds it; the TPU kernel does not);
//   feat = z_8 Wre + bre (no activation);
//   y = relu(feat Wr0f + denc Wr0d + br0), denc the frequency encoding of
//         the view direction (exact sine);
//   rgb = sigmoid((y Wr1 + br1) * rgb_mul).
// Each filter is evaluated as written: sinarg = A + t*B, then
// e = (P + t*Q) + t2*R with t2 = t*t, E = expf(e), g = sin(sinarg) * E,
// every operation rounded on its own (__fmul_rn/__fadd_rn), so that the
// kernel and the plain PyTorch version compute the same filter. In bfloat16
// mode every matmul input and weight is rounded to bf16 (each z at the
// product that reads it), the products are summed in float32, and the sines
// and cosines are the degree-11 fast_sin (cos x = fast_sin(x + pi/2)), as
// the TPU kernels' _trig. In float32 they are sinf/cosf: |A + t B| reaches
// hundreds of radians, so no __sinf and no fast math. The filters
// themselves are never rounded to bf16.

#pragma once

#include "render_common.cuh"

namespace gabor {

using namespace nerf;

constexpr int NL = 8;              // filter stages (the only depth supported)
constexpr int NH = NL * H;         // coefficient columns of one ray
constexpr int NCOEF = 5;           // A, B, P, Q, R
static_assert(THREADS == H, "the per-ray passes give each thread one column");

// Packed matrix buffer: each matrix (K, N) row-major, (in, out) order: w1..w7
// (H x H), wre, wr0f (H x HR), wr0d (DP x HR, zero rows past the real
// encoding), wr1 (HR x 8, zero columns past 3).
__host__ __device__ constexpr int off_w(int i) { return (i - 1) * H * H; }  // i = 1..7
constexpr int OFF_WRE = (NL - 1) * H * H;
constexpr int OFF_WR0F = OFF_WRE + H * H;
constexpr int OFF_WR0D = OFF_WR0F + H * HR;
constexpr int OFF_WR1 = OFF_WR0D + DP * HR;
constexpr int N_W = OFF_WR1 + HR * 8;

// Packed float32 vector buffer: b1..b7, bre, ws (rounded to the compute
// dtype), br0, br1 (8), bs.
constexpr int OFF_BRE = (NL - 1) * H;
constexpr int OFF_WS = NL * H;
constexpr int OFF_BR0 = (NL + 1) * H;
constexpr int OFF_BR1 = OFF_BR0 + HR;
constexpr int OFF_BS = OFF_BR1 + 8;
constexpr int N_B = OFF_BS + 1;

// Shared memory (floats) after the two activation buffers: the direction
// encoding, the per-point chunk columns (t, t^2, delta, sigma, rgb), each
// point's coefficient row (int: ray * NH, -1 past the chunk's valid
// points), then the weight stage (2 x KT x H of float32).
constexpr int SM_DENC = SM_ACT1 + H * LDA;
constexpr int SM_T = SM_DENC + DP * LDA;
constexpr int SM_T2 = SM_T + P;
constexpr int SM_DELTA = SM_T2 + P;
constexpr int SM_SIGMA = SM_DELTA + P;
constexpr int SM_RGB = SM_SIGMA + P;         // 3 x P
constexpr int SM_ROW = SM_RGB + 3 * P;
constexpr int SM_WST = SM_ROW + P;
constexpr int SMEM_BYTES = SM_WST * 4 + 2 * KT * H * 4;
static_assert(SM_WST % 4 == 0, "weight stage must be 16-byte aligned");
static_assert(SMEM_BYTES <= 232448, "exceeds the per-block shared memory");

// The per-ray coefficients and the model's scalars.
struct Gabor {
  const float* coef;      // (NCOEF, num_rays, NH): plane k holds coefficient k
  size_t plane;           // num_rays * NH
  float sigma_mul, rgb_mul;
};

template <bool FAST>
__device__ __forceinline__ float sine(float x) {
  return FAST ? fast_sin(x) : sinf(x);
}
template <bool FAST>
__device__ __forceinline__ float cosine(float x) {
  return FAST ? fast_sin(__fadd_rn(x, HALF_PI)) : cosf(x);
}

// One filter element: its sine argument, sin(sinarg) and the Gaussian
// factor E, from the five coefficients and t (t2 = t * t).
struct Filter {
  float sinarg, sn, E;
};
template <bool FAST>
__device__ __forceinline__ Filter filter_at(float a, float b, float p, float q,
                                            float r, float t, float t2) {
  Filter f;
  f.sinarg = __fadd_rn(a, __fmul_rn(t, b));
  const float e = __fadd_rn(__fadd_rn(p, __fmul_rn(t, q)), __fmul_rn(t2, r));
  f.E = expf(e);
  f.sn = sine<FAST>(f.sinarg);
  return f;
}

constexpr int DENC_LD = 64;   // stash stride of denc (dweight reads 64 columns)

// Where the train kernel keeps one CTA's activations, point-major with the
// CTA-local point index as the row: z[0..7] = z_1..z_8 (z_1..z_7 rounded to
// the compute dtype, as the products read them; z_8 unrounded: the density
// row reads it in float32), u[0..6] = u_2..u_8 (float32), feat, y, denc
// (stride DENC_LD, columns past DP zero), and the per-point columns
// sigma_pre and rgb (3). The filters are not stashed: the backward
// evaluates them again from the coefficients, bit for bit.
struct Stash {
  float* z[NL];
  float* u[NL - 1];
  float* feat;
  float* y;
  float* denc;
  float* sigma_pre;
  float* rgb;             // rgb + k * cap is channel k
  int cap;
};

// Stage `stage` (0-based) of a chunk, in a gemm's epilogue: for each of the
// thread's 8 points x 8 columns, the filter g from the point's ray
// coefficients, z = g (FIRST) or z = (acc + bias) * g. The z go to out_s
// (feature-major, rounded to bf16 in bf16 mode). LAST also adds z . ws of
// the thread's columns into part, in float32 on the unrounded z. With
// STASH, z goes to zs (unrounded when LAST, else as stored) and u = acc +
// bias to us, point-major, row l0+ty*8+i, stride H.
template <bool BF16, bool STASH, bool FIRST, bool LAST>
__device__ __forceinline__ void stage_epilogue(const float (&acc)[8][8],
                                               const float* __restrict__ bias,
                                               const Gabor& gp, int stage,
                                               const float* t_s, const float* t2_s,
                                               const int* row_s, float* out_s,
                                               float* zs, float* us, size_t l0,
                                               const float* __restrict__ ws,
                                               float (&part)[8]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* cs = gp.coef + stage * H;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c0 = q * 128 + tx * 4;
    float o[4][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      const int row = row_s[p];
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (row >= 0) {
        const float* c = cs + row + c0;
        const float4 a = __ldg(reinterpret_cast<const float4*>(c));
        const float4 b = __ldg(reinterpret_cast<const float4*>(c + gp.plane));
        const float4 pp = __ldg(reinterpret_cast<const float4*>(c + 2 * gp.plane));
        const float4 qq = __ldg(reinterpret_cast<const float4*>(c + 3 * gp.plane));
        const float4 rr = __ldg(reinterpret_cast<const float4*>(c + 4 * gp.plane));
        const float tv = t_s[p], t2 = t2_s[p];
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
        const float pv[4] = {pp.x, pp.y, pp.z, pp.w}, qv[4] = {qq.x, qq.y, qq.z, qq.w};
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const Filter f = filter_at<BF16>(av[u], bv[u], pv[u], qv[u], rv[u], tv, t2);
          g[u] = __fmul_rn(f.sn, f.E);
        }
      }
      float zv[4], uv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (FIRST) {
          zv[u] = g[u];
          uv[u] = 0.f;
        } else {
          uv[u] = acc[i][q * 4 + u] + __ldg(bias + c0 + u);
          zv[u] = __fmul_rn(uv[u], g[u]);
        }
        if (LAST) part[i] = fmaf(zv[u], __ldg(ws + c0 + u), part[i]);
        o[u][i] = BF16 ? round_bf16(zv[u]) : zv[u];
      }
      if (STASH) {
        const size_t off = (l0 + p) * H + c0;
        *reinterpret_cast<float4*>(zs + off) =
            LAST ? make_float4(zv[0], zv[1], zv[2], zv[3])
                 : make_float4(o[0][i], o[1][i], o[2][i], o[3][i]);
        if (!FIRST)
          *reinterpret_cast<float4*>(us + off) = make_float4(uv[0], uv[1], uv[2], uv[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float* dst = out_s + (c0 + u) * LDA + ty * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(o[u][0], o[u][1], o[u][2], o[u][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(o[u][4], o[u][5], o[u][6], o[u][7]);
    }
  }
}

// The forward of points [chunk0, chunk0 + nvalid) (nvalid <= P): leaves t,
// delta, sigma (after the ReLU and sigma_mul) and rgb of each point in
// shared memory. With STASH what the backward needs also goes to `st` at
// local rows l0.. (all P rows; the ones past nvalid have zero filters).
template <bool BF16, bool STASH, typename WT>
__device__ void forward_chunk(const RayInputs& in, const Gabor& gp,
                              const WT* __restrict__ wmat, int chunk0, int nvalid,
                              float* smem, const Stash& st, size_t l0) {
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* t2_s = smem + SM_T2;
  float* delta_s = smem + SM_DELTA;
  float* sig_s = smem + SM_SIGMA;
  float* rgb_s = smem + SM_RGB;
  int* row_s = reinterpret_cast<int*>(smem + SM_ROW);
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  const float* vec = in.vec;
  const int tid = threadIdx.x;
  const int S = in.S;

  // ---- direction encoding, per-point columns ----
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
    int row = -1;
    if (tid < nvalid) {
      tv = in.t[g];
      dv = (g % S == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
      row = (g / S) * NH;
    }
    t_s[tid] = tv;
    t2_s[tid] = __fmul_rn(tv, tv);
    delta_s[tid] = dv;
    row_s[tid] = row;
  }
  __syncthreads();
  if (STASH) {
    for (int idx = tid; idx < P * DENC_LD; idx += THREADS) {
      const int p = idx / DENC_LD, c = idx % DENC_LD;
      st.denc[(l0 + p) * DENC_LD + c] = c < DP ? denc[c * LDA + p] : 0.f;
    }
  }
#define ZS(i) (STASH ? st.z[i] : nullptr)
#define US(i) (STASH ? st.u[i] : nullptr)

  const int tx = tid & 31, ty = tid >> 5;
  float acc2[8][8];
  float acc1[8][4];
  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = 0.f;

  // ---- stage 1: z_1 = g_1 (-> act0) ----
  zero<2>(acc2);
  stage_epilogue<BF16, STASH, true, false>(acc2, nullptr, gp, 0, t_s, t2_s, row_s,
                                           act0, ZS(0), nullptr, l0, nullptr, part);
  // ---- stages 2..7, ping-pong between the activation buffers ----
#pragma unroll 1
  for (int l = 2; l < NL; ++l) {
    const float* src = (l & 1) ? act1 : act0;
    float* dst = (l & 1) ? act0 : act1;
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, src, wmat + off_w(l - 1), wst);
    stage_epilogue<BF16, STASH, false, false>(acc2, vec + (l - 2) * H, gp, l - 1, t_s,
                                              t2_s, row_s, dst, ZS(l - 1), US(l - 2),
                                              l0, nullptr, part);
  }
  // ---- stage 8 (act0 -> act1) and the density row ----
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + off_w(NL - 1), wst);
  stage_epilogue<BF16, STASH, false, true>(acc2, vec + (NL - 2) * H, gp, NL - 1, t_s,
                                           t2_s, row_s, act1, ZS(NL - 1), US(NL - 2),
                                           l0, vec + OFF_WS, part);
#undef ZS
#undef US
  // each thread summed z8 . ws over its 8 columns; the warp's 32 lanes (same
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
      sig_s[ty * 8 + i] = fmaxf(sp_pre, 0.f) * gp.sigma_mul;
      if (STASH) st.sigma_pre[l0 + ty * 8 + i] = sp_pre;
    }
  }
  // ---- feature remap: no activation (act1 -> act0) ----
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act1, wmat + OFF_WRE, wst);
  epilogue<2, BF16>(acc2, vec + OFF_BRE, false, act0, STASH ? st.feat : nullptr, H, l0);
  // ---- rgb head: relu layer on [feat, denc] (-> act1), then the output ----
  zero<1>(acc1);
  gemm_acc<H, 1>(acc1, act0, wmat + OFF_WR0F, wst);
  gemm_acc<DP, 1>(acc1, denc, wmat + OFF_WR0D, wst);
  epilogue<1, BF16>(acc1, vec + OFF_BR0, true, act1, STASH ? st.y : nullptr, HR, l0);
  __syncthreads();
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(act1[k * LDA + p], load1(wmat + OFF_WR1 + k * 8 + c), z);
    z = (z + __ldg(vec + OFF_BR1 + c)) * gp.rgb_mul;
    const float r = 1.f / (1.f + expf(-z));
    rgb_s[c * P + p] = r;
    if (STASH) st.rgb[static_cast<size_t>(c) * st.cap + l0 + p] = r;
  }
  __syncthreads();
}

}  // namespace gabor
