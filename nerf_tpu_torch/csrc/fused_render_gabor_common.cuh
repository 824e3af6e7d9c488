// The GaborNet family's pieces of the fused render and field kernels for
// Hopper (sm_90a): the packed weight layout, the shared-memory plan, the
// filters (from per-ray coefficients, or from the field's points and the
// raw filter banks), the forward of one 64-point chunk, and the network
// backward over a CTA's stashed points. fused_render_gabor_fwd.cu
// composites the chunk straight away; fused_render_gabor_train.cu also
// stashes what its backward needs; fused_gabor_fwd.cu / fused_gabor_bwd.cu
// (the field) run the same network and backward on given points. The
// generic pieces (gemm, compositing, backward blocks) are in
// render_common.cuh, shared with the NeRF and SIREN families.
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
// points), the field kernels' points (rounded to the compute dtype) and
// their squared norms, then the weight stage (2 x KT x H of float32).
constexpr int SM_DENC = SM_ACT1 + H * LDA;
constexpr int SM_T = SM_DENC + DP * LDA;
constexpr int SM_T2 = SM_T + P;
constexpr int SM_DELTA = SM_T2 + P;
constexpr int SM_SIGMA = SM_DELTA + P;
constexpr int SM_RGB = SM_SIGMA + P;         // 3 x P
constexpr int SM_ROW = SM_RGB + 3 * P;
constexpr int SM_X = SM_ROW + P;             // field: points (3 x P), |x|^2 (P)
constexpr int SM_WST = SM_X + 4 * P;
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

// The filters of ray samples (the render kernels): g = sin(A + t B) *
// exp(P + t Q + t^2 R) from the coefficients of the point's ray, zero past
// the chunk's valid points (row -1).
template <bool FAST>
struct RayFilters {
  const Gabor& gp;
  const float* t_s;
  const float* t2_s;
  const int* row_s;

  // g of point p, columns c0..c0+3 of stage `stage`
  __device__ __forceinline__ void operator()(int stage, int p, int c0,
                                             float (&g)[4]) const {
    const int row = row_s[p];
    g[0] = g[1] = g[2] = g[3] = 0.f;
    if (row < 0) return;
    const float* c = gp.coef + stage * H + row + c0;
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
      const Filter f = filter_at<FAST>(av[u], bv[u], pv[u], qv[u], rv[u], tv, t2);
      g[u] = __fmul_rn(f.sn, f.E);
    }
  }
};

// Stage `stage` (0-based) of a chunk, in a gemm's epilogue: for each of the
// thread's 8 points x 8 columns, the filter g from `filt` (RayFilters, or
// the field kernels' PointFilters), z = g (FIRST) or z = (acc + bias) * g.
// The z go to out_s (feature-major, rounded to bf16 in bf16 mode). LAST
// also adds z . ws of the thread's columns into part, in float32 on the
// unrounded z. With STASH, z goes to zs (unrounded when LAST, else as
// stored) and u = acc + bias to us, point-major, row l0+ty*8+i, stride H.
template <bool BF16, bool STASH, bool FIRST, bool LAST, typename Filt>
__device__ __forceinline__ void stage_epilogue(const float (&acc)[8][8],
                                               const float* __restrict__ bias,
                                               const Filt& filt, int stage,
                                               float* out_s, float* zs, float* us,
                                               size_t l0, const float* __restrict__ ws,
                                               float (&part)[8]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c0 = q * 128 + tx * 4;
    float o[4][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      float g[4];
      filt(stage, p, c0, g);
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

// The field kernels' filter banks, float32 (never rounded), stage s at
// s * F_STRIDE: omega (3 x H), phi (H), mu^T (3 x H), |mu|^2 (H) and gamma
// (H), as fused_gabor.py::pack_params packs them (without its padding rows).
constexpr int F_OM = 0, F_PH = 3 * H, F_MU = 4 * H, F_M2 = 7 * H, F_GAM = 8 * H;
constexpr int F_STRIDE = 9 * H;
constexpr int N_F = NL * F_STRIDE;

// One filter element of a field point, column c of the stage whose banks
// start at fs, as fused_gabor.py::_filters_from_points evaluates it: x the
// point rounded to the compute dtype (x0..x2), xx = |x|^2 of the unrounded
// point, sinarg = x . omega + phi, q = (xx - 2 x . mu) + |mu|^2 (the
// expansion, not |x - mu|^2: q can fall slightly below zero by
// cancellation, and E then exceeds 1, as on the TPU), E = exp((-gamma/2)
// q). Every operation is rounded on its own, so that the forward and the
// backward get the same filter bit for bit.
struct PointFilter {
  float sinarg, sn, E, q;
};
template <bool FAST>
__device__ __forceinline__ PointFilter point_filter_at(const float* __restrict__ fs,
                                                       int c, float x0, float x1,
                                                       float x2, float xx) {
  PointFilter f;
  const float s = fmaf(x2, __ldg(fs + F_OM + 2 * H + c),
                       fmaf(x1, __ldg(fs + F_OM + H + c),
                            __fmul_rn(x0, __ldg(fs + F_OM + c))));
  const float xm = fmaf(x2, __ldg(fs + F_MU + 2 * H + c),
                        fmaf(x1, __ldg(fs + F_MU + H + c),
                             __fmul_rn(x0, __ldg(fs + F_MU + c))));
  f.sinarg = __fadd_rn(s, __ldg(fs + F_PH + c));
  f.q = __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xm)), __ldg(fs + F_M2 + c));
  f.E = expf(__fmul_rn(__fmul_rn(-0.5f, __ldg(fs + F_GAM + c)), f.q));
  f.sn = sine<FAST>(f.sinarg);
  return f;
}

// The filters of field points (the field kernels), from the points in
// shared memory (SM_X: 3 x P rounded, then |x|^2), zero past nvalid.
template <bool FAST>
struct PointFilters {
  const float* fpack;
  const float* x_s;
  int nvalid;

  __device__ __forceinline__ void operator()(int stage, int p, int c0,
                                             float (&g)[4]) const {
    g[0] = g[1] = g[2] = g[3] = 0.f;
    if (p >= nvalid) return;
    const float* fs = fpack + stage * F_STRIDE;
    const float x0 = x_s[p], x1 = x_s[P + p], x2 = x_s[2 * P + p], xx = x_s[3 * P + p];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const PointFilter f = point_filter_at<FAST>(fs, c0 + u, x0, x1, x2, xx);
      g[u] = __fmul_rn(f.sn, f.E);
    }
  }
};

// The view direction's encoding (exact sine) of ray samples [chunk0, chunk0
// + nvalid) (nvalid <= P) and their per-point columns (t, t^2, delta, the
// ray's coefficient row) into shared memory; zero (row -1) past nvalid.
// Ends past a barrier.
template <bool BF16>
__device__ void load_ray_chunk(const RayInputs& in, int chunk0, int nvalid,
                               float* smem) {
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* t2_s = smem + SM_T2;
  float* delta_s = smem + SM_DELTA;
  int* row_s = reinterpret_cast<int*>(smem + SM_ROW);
  const int tid = threadIdx.x;
  const int S = in.S;
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
}

// The points [p0, p0 + nvalid) (nvalid <= P) of a field chunk, given with
// their directions (n, 3), into shared memory, zero past nvalid: each point
// rounded to the compute dtype (as _mm rounds pts8) and its |x|^2 from the
// unrounded coordinates (SM_X), and the direction encoding with the exact
// sine (fused_gabor.py encodes with jnp.sin in both modes). Ends past a
// barrier.
template <bool BF16>
__device__ void load_point_chunk(const float* __restrict__ pts,
                                 const float* __restrict__ dirs, int p0, int nvalid,
                                 int real_d, float* smem) {
  float* x_s = smem + SM_X;
  float* denc = smem + SM_DENC;
  const int tid = threadIdx.x;
  if (tid < P) {
    float x[3] = {0.f, 0.f, 0.f};
    if (tid < nvalid)
      for (int c = 0; c < 3; ++c) x[c] = pts[static_cast<size_t>(p0 + tid) * 3 + c];
    for (int c = 0; c < 3; ++c) x_s[c * P + tid] = BF16 ? round_bf16(x[c]) : x[c];
    x_s[3 * P + tid] =
        __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                  __fmul_rn(x[2], x[2]));
  }
  for (int idx = tid; idx < DP * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid && c < real_d) {
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<false>(dirs[static_cast<size_t>(p0 + p) * 3 + d], c);
      if (BF16) v = round_bf16(v);
    }
    denc[c * LDA + p] = v;
  }
  __syncthreads();
}

// The network of the chunk whose direction encoding is in shared memory,
// with the filters of `filt`: leaves sigma (after the ReLU and sigma_mul)
// and rgb of each of its P points in shared memory. With STASH what the
// backward needs also goes to `st` at local rows l0.. (all P rows; the
// ones past the chunk's points have zero filters).
template <bool BF16, bool STASH, typename WT, typename Filt>
__device__ void mlp_chunk(const float* __restrict__ vec, const WT* __restrict__ wmat,
                          float sigma_mul, float rgb_mul, const Filt& filt,
                          float* smem, const Stash& st, size_t l0) {
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* denc = smem + SM_DENC;
  float* sig_s = smem + SM_SIGMA;
  float* rgb_s = smem + SM_RGB;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  const int tid = threadIdx.x;

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
  stage_epilogue<BF16, STASH, true, false>(acc2, nullptr, filt, 0, act0, ZS(0), nullptr,
                                           l0, nullptr, part);
  // ---- stages 2..7, ping-pong between the activation buffers ----
#pragma unroll 1
  for (int l = 2; l < NL; ++l) {
    const float* src = (l & 1) ? act1 : act0;
    float* dst = (l & 1) ? act0 : act1;
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, src, wmat + off_w(l - 1), wst);
    stage_epilogue<BF16, STASH, false, false>(acc2, vec + (l - 2) * H, filt, l - 1, dst,
                                              ZS(l - 1), US(l - 2), l0, nullptr, part);
  }
  // ---- stage 8 (act0 -> act1) and the density row ----
  zero<2>(acc2);
  gemm_acc<H, 2>(acc2, act0, wmat + off_w(NL - 1), wst);
  stage_epilogue<BF16, STASH, false, true>(acc2, vec + (NL - 2) * H, filt, NL - 1, act1,
                                           ZS(NL - 1), US(NL - 2), l0, vec + OFF_WS, part);
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
      sig_s[ty * 8 + i] = fmaxf(sp_pre, 0.f) * sigma_mul;
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
    z = (z + __ldg(vec + OFF_BR1 + c)) * rgb_mul;
    const float r = 1.f / (1.f + expf(-z));
    rgb_s[c * P + p] = r;
    if (STASH) st.rgb[static_cast<size_t>(c) * st.cap + l0 + p] = r;
  }
  __syncthreads();
}

// The forward of ray samples [chunk0, chunk0 + nvalid) (nvalid <= P): leaves
// t, delta, sigma and rgb of each point in shared memory (see mlp_chunk).
template <bool BF16, bool STASH, typename WT>
__device__ void forward_chunk(const RayInputs& in, const Gabor& gp,
                              const WT* __restrict__ wmat, int chunk0, int nvalid,
                              float* smem, const Stash& st, size_t l0) {
  load_ray_chunk<BF16>(in, chunk0, nvalid, smem);
  const RayFilters<BF16> filt{gp, smem + SM_T, smem + SM_T2,
                              reinterpret_cast<const int*>(smem + SM_ROW)};
  mlp_chunk<BF16, STASH>(in.vec, wmat, gp.sigma_mul, gp.rgb_mul, filt, smem, st, l0);
}

// ---------------------------------------------------------------- backward

constexpr int N_TOT = N_W + N_B;                 // gradient floats of the MLP
constexpr int N_COLS = 16;                       // per-point columns (C_*, C_DP)
constexpr int C_DP = 11;                         // field: the point cotangent (3)
static_assert(C_DP > C_DSIG && C_DP + 3 <= N_COLS, "column plan");

// Scratch floats per stashed point of a backward kernel with NDZ buffers of
// points x LDZ (the train kernel's two dz buffers; the field kernel's also
// hold each stage's dsinarg and dq): the stash, those buffers, the columns.
template <int NDZ>
__host__ __device__ constexpr int floats_per_point() {
  return NL * H + (NL - 1) * H + H + HR + DENC_LD + NDZ * LDZ + N_COLS;
}

// One CTA's scratch in device memory: the stash, up to four buffers of
// points x LDZ, the per-point columns.
struct Scratch {
  Stash st;
  float* dz[4];
  float* cols;            // N_COLS x cap
};

template <int NDZ>
__device__ Scratch carve(float* p, int cap) {
  static_assert(floats_per_point<NDZ>() % 4 == 0,
                "stash rows must stay 16-byte aligned");
  Scratch s;
  const size_t c = static_cast<size_t>(cap);
  for (int i = 0; i < NL; ++i) { s.st.z[i] = p; p += c * H; }
  for (int i = 0; i < NL - 1; ++i) { s.st.u[i] = p; p += c * H; }
  s.st.feat = p; p += c * H;
  s.st.y = p; p += c * HR;
  s.st.denc = p; p += c * DENC_LD;
  for (int i = 0; i < NDZ; ++i) { s.dz[i] = p; p += c * LDZ; }
  for (int i = NDZ; i < 4; ++i) s.dz[i] = nullptr;
  s.cols = p;
  s.st.sigma_pre = p + C_SIGP * c;
  s.st.rgb = p + C_RGB * c;
  s.st.cap = cap;
  return s;
}

// The network backward (the train kernel's, fused_render_gabor.py::
// _train_kernel; fused_gabor.py::_bwd_kernel's chain) over the CTA's points
// l < cap_c, from the stash and the cotangent columns dzr1 (the sigmoid
// input's, times rgb_mul) and dsig (the density pre-activation's, times
// sigma_mul): the heads as in the NeRF train kernel (relu rgb head, no
// activation on the remap), then stage by stage, 8 down to 1.
// `filters(stage, dz, u)` takes each stage's dz (points x LDZ) to the
// filter's cotangent dg = dz * u (stage > 0; else dg = dz) and, for stage
// > 0, replaces dz in place by du = dz * g; it ends past a barrier. Then
// dW_{i-1} = z_{i-1}^T du_i (one product over the CTA's points with its 64
// x 256 output strip in registers), db_{i-1} a column sum, and dz_{i-1} =
// du_i W_{i-1}^T on the forward's gemm against the transposed matrices
// wmat_t; the gradients go once per CTA into `part` (offsets of the packed
// layout, the vectors from N_W). `on_dzr0(dzr0)` runs once dzr0 (points x
// HR at stride LDZ) is complete, before its buffer is reused (the field
// backward takes the direction cotangent there). Rounding in BF16 mode: both
// operands of every dW product and the dz of every dz W^T are rounded to
// bf16 (mmT_acc, dact), sums are float32, the bias, ws and bs gradients are
// float32 sums of the unrounded values, and z_8, sigma_pre and the rgb
// sigmoid are read in float32.
template <bool BF16, typename WT, typename OnDzr0, typename Filters>
__device__ void net_backward(const Scratch& sc, size_t cz, const float* __restrict__ vec,
                             const WT* __restrict__ wmat, const WT* __restrict__ wmat_t,
                             float* part, int cap_c, float* smem, OnDzr0 on_dzr0,
                             Filters filters) {
  const int tid = threadIdx.x;
  const float* cols = sc.cols;
  const float* dsig = cols + C_DSIG * cz;
  const float* z8 = sc.st.z[NL - 1];
  float* dzA = sc.dz[0];
  float* dzB = sc.dz[1];
  float* pvec = part + N_W;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
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
    pvec[OFF_BS] = s;
  }
  for (int k = tid; k < H; k += THREADS) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l)
      s = fmaf(z8[static_cast<size_t>(l) * H + k], dsig[l], s);
    pvec[OFF_WS + k] = s;
  }
  __syncthreads();
  // rgb hidden layer: dfeat = dzr0 wr0f^T; wr0f, wr0d, br0
  dact<HR, BF16, Epi::None, false>(dzA, wmat_t + OFF_WR0F, nullptr, 0, nullptr,
                                   nullptr, 1.f, dzB, cap_c, smem, wst);
  dweight<1, false, BF16>(sc.st.feat, H, H, H, dzA, cap_c, part + OFF_WR0F, smem);
  dweight<1, false, BF16>(sc.st.denc, DENC_LD, DENC_LD, DP, dzA, cap_c,
                          part + OFF_WR0D, smem);
  colsum(dzA, HR, cap_c, pvec + OFF_BR0);
  __syncthreads();
  on_dzr0(static_cast<const float*>(dzA));
  // feature remap: dz8 = dfeat wre^T + dsig ws; wre from the unrounded z8, bre
  // (dact's first barrier also orders on_dzr0's reads of dzA before its
  // writes)
  dact<H, BF16, Epi::None, true>(dzB, wmat_t + OFF_WRE, nullptr, 0, dsig,
                                 vec + OFF_WS, 1.f, dzA, cap_c, smem, wst);
  dweight<2, BF16, BF16>(z8, H, H, H, dzB, cap_c, part + OFF_WRE, smem);
  colsum(dzB, H, cap_c, pvec + OFF_BRE);
  __syncthreads();
  // stages 8..2: filter cotangents and du in place, then w_{i-1}, b_{i-1}
  // and dz_{i-1}
  float* cur = dzA;
  float* nxt = dzB;
#pragma unroll 1
  for (int stage = NL - 1; stage >= 1; --stage) {
    filters(stage, cur, static_cast<const float*>(sc.st.u[stage - 1]));
    dweight<2, false, BF16>(sc.st.z[stage - 1], H, H, H, cur, cap_c,
                            part + off_w(stage), smem);
    colsum(cur, H, cap_c, pvec + (stage - 1) * H);
    dact<H, BF16, Epi::None, false>(cur, wmat_t + off_w(stage), nullptr, 0, nullptr,
                                    nullptr, 1.f, nxt, cap_c, smem, wst);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // stage 1: dg_1 = dz_1, no weight before it
  filters(0, cur, static_cast<const float*>(nullptr));
}

}  // namespace gabor
