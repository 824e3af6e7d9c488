// The GaborNet network on Hopper's tensor cores (sm_90a), over one chunk of
// TC_P points, shared by the bfloat16 forward render (fused_render_gabor_fwd_tc.cu,
// which composites each chunk straight away), the bfloat16 train pass
// (fused_render_gabor_train_tc.cu, which stashes what its backward needs)
// and the bfloat16 field forward (fused_gabor_fwd_tc.cu, which writes each
// point's rgb and sigma). One chain, so the train pass's forward is the
// forward render's bit for bit and the field's differs only in its filters.
// The train pass's network backward closes the file, shared with the
// bfloat16 field backward (fused_gabor_bwd_tc.cu), which runs the field
// forward's chain with STASH.
//
// The chain is nerf_tpu/ops/pallas/fused_render_gabor.py::_mlp_tile in
// bfloat16, at its rounding points (fused_render_gabor_common.cuh states the
// network). Each stage's product u_i = z_{i-1} W_{i-1} (and wre, wr0f, wr0d)
// is render_tc.cuh's gemm_fwd: the chunk's bf16 activation tile in shared
// memory times the weights streamed through a ring of cp.async stages,
// mma.sync m16n8k16 with float32 sums. Its epilogue evaluates the filter of
// each accumulator element (row = point, column = neuron) in registers, each
// operation rounded on its own (the degree-11 fast_sin of the TPU kernel's
// _trig, expf without fast math; the filters never rounded), forms z_i =
// (u_i + b) g_i in float32 (z_1 = g_1 has no product) and stores z_i rounded
// to bf16 as the next product's operand. The filters come from
//   * the ray's coefficients (the renders), exactly as
//     fused_render_gabor_common.cuh::filter_at<true>. Where a chunk lies in
//     one ray (every chunk at S = 256, lego_siren.txt's samples) each thread
//     loads a column pair's five coefficients once (__ldg float2, through L1:
//     the 8 lanes of a column group read the same addresses) and evaluates
//     its 8 rows from them; where a chunk spans rays (S = 37, a ragged last
//     CTA) or is short, each row loads them by its own ray (-1 past the
//     chunk's points: zero filters);
//   * the point and the raw filter banks (the field), exactly as
//     point_filter_at<true>: x rounded to bf16 as _mm rounds pts8, |x|^2 from
//     the unrounded point, the banks float32, loaded once a column pair.
// The density is the float32 reduction of the UNROUNDED z_8 against ws (each
// thread over its columns, the 4 lanes of a row by shuffle, the 8 warps in
// order), plus bs, relu, times sigma_mul; the feature product reads the
// rounded z_8. The rgb head's 128 x 3 layer and the sigmoid run on the CUDA
// cores.
// With STASH each stage's epilogue also writes u_i = acc + b (float32, the
// filter cotangent's factor) and the unrounded z_8 (the ws gradient) from
// its registers, and the chunk's rounded tiles go to the stash after each
// product.
//
// Widths and depth: hidden 256 with a 32-column direction encoding and 8
// stages (64-point chunks, one activation tile overwritten in place, two
// CTAs an SM) and, built with their plan's -D flags (ops/cuda/
// gabor_plan.py), hidden 512, 768 and 1024, the direction encoding padded
// to 64 columns and any number of stages from 1 (z_NL and u_NL take the
// place of z_8 and u_8 below). Every product runs in blocks of NB = 256
// output columns (the rgb head's of 128) over the whole input; above
// hidden 256 a stage's blocks read one activation tile and write the
// other (a block written in place would overwrite the input of the next),
// the forward chunks are 64 points up to hidden 512 and 32 wider, one CTA
// an SM where two do not fit; the backward's dz W^T runs in chunks of
// TC_PB points and blocks of NB columns, each with its block of u. A block
// changes which warp computes an output, never the order of its sum over
// k, so hidden 256 computes what it did with one.

#pragma once

#include "render_tc.cuh"
#include "fused_render_gabor_common.cuh"

namespace gabor {

// Shared memory (bytes) of a forward CTA: the activation tiles (at hidden
// 256 one, each stage's z overwriting its input once the product has read
// it; wider two, a stage's blocks reading one and writing the other), the
// direction encoding, the weight stages, the density partials, the chunk's
// per-point columns (GC_*, floats, TC_P each) and each point's coefficient
// row (the renders). A render's columns: t, t^2, delta, sigma (after the
// ReLU), rgb (3); a field's: its rounded point (GC_X .. GC_X + 2, over t,
// t^2 and delta) and |x|^2 (GC_XX), sigma, rgb. Two CTAs share an SM at
// hidden 256 (gabor_plan.py's fwd_ctas_per_sm).
constexpr bool ONE_TILE = H == NB;
constexpr int GB_ACT0 = 0;
constexpr int GB_ACT1 = ONE_TILE ? GB_ACT0 : GB_ACT0 + TC_P * LDS * 2;
constexpr int GB_DENC = GB_ACT1 + TC_P * LDS * 2;
constexpr int GB_WST = GB_DENC + TC_P * LDD * 2;
constexpr int GB_SIG = GB_WST + WST_FWD_BYTES;
constexpr int GB_COL = GB_SIG + WARPS * TC_P * 4;
constexpr int GC_T = 0, GC_T2 = 1, GC_DELTA = 2, GC_SIGMA = 3, GC_RGB = 4, N_GC = 7;
constexpr int GC_X = 0, GC_XX = 7;
constexpr int GB_ROW = GB_COL + (N_GC + 1) * TC_P * 4;
constexpr int SMEM_GABOR_TC = GB_ROW + TC_P * 4;
static_assert(SMEM_GABOR_TC <= 232448, "exceeds the per-block shared memory");
static_assert(!ONE_TILE || 2 * (SMEM_GABOR_TC + 1024) <= 233472,
              "two forward CTAs share an SM");

struct GSmem {
  bf16* act[2];   // the same tile twice at hidden 256
  bf16* denc;
  bf16* wst;
  float* sig;
  float* col;
  int* row;       // the point's ray * NH, -1 past the chunk's points (renders)
};

__device__ __forceinline__ GSmem carve_gsmem(unsigned char* sb) {
  return GSmem{{reinterpret_cast<bf16*>(sb + GB_ACT0), reinterpret_cast<bf16*>(sb + GB_ACT1)},
               reinterpret_cast<bf16*>(sb + GB_DENC),
               reinterpret_cast<bf16*>(sb + GB_WST), reinterpret_cast<float*>(sb + GB_SIG),
               reinterpret_cast<float*>(sb + GB_COL), reinterpret_cast<int*>(sb + GB_ROW)};
}

// One backward CTA's device-memory stash (the train pass's and the field
// backward's), point-major with the CTA-local point as the row: z_1..z_8
// rounded (the products' bf16 operands), feat and the two dz buffers (bf16,
// H columns), y (HR), denc (DP), then u_2..u_8 and the unrounded z_8
// (float32, H) and the per-point columns (float32, N_COLS x cap;
// render_common.cuh C_*, the field's point cotangent at C_DP). The filters
// are not stashed: the backward evaluates them again from the coefficients
// or the point, bit for bit.
struct TcStash {
  bf16* z[NL];
  bf16* feat;
  bf16* dz[2];
  bf16* y;
  bf16* denc;
  float* u[NU];
  float* z8f;
  float* cols;
};
// 14,208 bytes a point at the default shape (gabor_plan.py's
// tc_bytes_per_point); at hidden 1024 with 8 stages 56,448, 14.8 GB at
// 1024 rays x 256 samples.
constexpr int TC_BYTES_PER_POINT = 2 * ((NL + 3) * H + HR + DP) + 4 * (NL * H + N_COLS);
static_assert(TC_BYTES_PER_POINT % 16 == 0, "stash rows must stay 16-byte aligned");
constexpr int NPART = (N_TOT + 1 + 3) / 4 * 4;    // a train CTA's partial: gradients, loss

__device__ inline TcStash carve_tc_stash(unsigned char* p, int cap) {
  TcStash s;
  const size_t c = static_cast<size_t>(cap);
  auto take_b = [&](int cols) {
    bf16* r = reinterpret_cast<bf16*>(p);
    p += c * cols * 2;
    return r;
  };
  auto take_f = [&](int cols) {
    float* r = reinterpret_cast<float*>(p);
    p += c * cols * 4;
    return r;
  };
  for (int i = 0; i < NL; ++i) s.z[i] = take_b(H);
  s.feat = take_b(H);
  s.dz[0] = take_b(H);
  s.dz[1] = take_b(H);
  s.y = take_b(HR);
  s.denc = take_b(DP);
  for (int i = 0; i < NL - 1; ++i) s.u[i] = take_f(H);
  s.z8f = take_f(H);
  s.cols = take_f(N_COLS);
  return s;
}

// The direction encoding (exact sine, rounded to bf16; point-major) of ray
// samples [chunk0, chunk0 + nvalid) and their columns t, t^2, delta and
// coefficient row, zero (row -1) past nvalid, as
// fused_render_gabor_common.cuh::load_ray_chunk with the encoding rounded to
// bf16. Ends past a barrier.
__device__ inline void load_chunk(const RayInputs& in, int chunk0, int nvalid, const GSmem& sm) {
  const int tid = threadIdx.x, S = in.S;
  for (int idx = tid; idx < TC_P * DP; idx += THREADS) {
    const int p = idx / DP, c = idx % DP;
    float v = 0.f;
    if (p < nvalid && c < in.real_d) {
      const int ray = (chunk0 + p) / S;
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<false>(in.viewdirs[ray * 3 + d], c);
    }
    sm.denc[p * LDD + c] = __float2bfloat16_rn(v);
  }
  if (tid < TC_P) {
    const int g = chunk0 + tid;
    float tv = 0.f, dv = 0.f;
    int row = -1;
    if (tid < nvalid) {
      tv = in.t[g];
      dv = (g % S == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
      row = (g / S) * NH;
    }
    sm.col[GC_T * TC_P + tid] = tv;
    sm.col[GC_T2 * TC_P + tid] = __fmul_rn(tv, tv);
    sm.col[GC_DELTA * TC_P + tid] = dv;
    sm.row[tid] = row;
  }
  __syncthreads();
}

// The field points [p0, p0 + nvalid) into shared memory, zero past nvalid,
// as fused_render_gabor_common.cuh::load_point_chunk<true>: each point
// rounded to bf16 and its |x|^2 from the unrounded coordinates, and the
// direction encoding (exact sine) rounded to bf16. Ends past a barrier.
__device__ inline void load_point_chunk_tc(const float* __restrict__ pts,
                                           const float* __restrict__ dirs, int p0, int nvalid,
                                           int real_d, const GSmem& sm) {
  const int tid = threadIdx.x;
  if (tid < TC_P) {
    float x[3] = {0.f, 0.f, 0.f};
    if (tid < nvalid)
      for (int c = 0; c < 3; ++c) x[c] = pts[static_cast<size_t>(p0 + tid) * 3 + c];
    for (int c = 0; c < 3; ++c) sm.col[(GC_X + c) * TC_P + tid] = round_bf16(x[c]);
    sm.col[GC_XX * TC_P + tid] =
        __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])), __fmul_rn(x[2], x[2]));
  }
  for (int idx = tid; idx < TC_P * DP; idx += THREADS) {
    const int p = idx / DP, c = idx % DP;
    float v = 0.f;
    if (p < nvalid && c < real_d) {
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<false>(dirs[static_cast<size_t>(p0 + p) * 3 + d], c);
    }
    sm.denc[p * LDD + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
}

// The five coefficients (A, B, P, Q, R) of two neighbouring columns at c.
__device__ __forceinline__ void load_coef(float2 (&k)[NCOEF], const float* c, size_t plane) {
#pragma unroll
  for (int i = 0; i < NCOEF; ++i) k[i] = __ldg(reinterpret_cast<const float2*>(c + i * plane));
}

// The filters of ray samples, stage `coef` (gp.coef + stage * H): `column`
// takes a column pair, `pair` gives g of both columns at a row. UNIFORM:
// every point of the chunk lies in the ray whose coefficient row is base_u.
template <bool UNIFORM>
struct RayFilterTc {
  const float* coef;
  size_t plane;
  int base_u;
  const GSmem& sm;
  float2 k[NCOEF];
  int col;

  __device__ __forceinline__ void column(int c) {
    col = c;
    if constexpr (UNIFORM) load_coef(k, coef + base_u + c, plane);
  }
  __device__ __forceinline__ void pair(int row, float& g0, float& g1) {
    const int base = UNIFORM ? base_u : sm.row[row];
    g0 = g1 = 0.f;
    if (UNIFORM || base >= 0) {
      if constexpr (!UNIFORM) load_coef(k, coef + base + col, plane);
      const float tv = sm.col[GC_T * TC_P + row], t2 = sm.col[GC_T2 * TC_P + row];
      const Filter f0 = filter_at<true>(k[0].x, k[1].x, k[2].x, k[3].x, k[4].x, tv, t2);
      const Filter f1 = filter_at<true>(k[0].y, k[1].y, k[2].y, k[3].y, k[4].y, tv, t2);
      g0 = __fmul_rn(f0.sn, f0.E);
      g1 = __fmul_rn(f1.sn, f1.E);
    }
  }
};

// The filters of field points from the banks of one stage (fs = fpack +
// stage * F_STRIDE), zero past nvalid.
struct PointFilterTc {
  const float* fs;
  const GSmem& sm;
  int nvalid;
  float2 om[3], mu[3], ph, m2, hg;   // hg = -gamma / 2

  __device__ __forceinline__ void column(int c) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      om[d] = __ldg(reinterpret_cast<const float2*>(fs + F_OM + d * H + c));
      mu[d] = __ldg(reinterpret_cast<const float2*>(fs + F_MU + d * H + c));
    }
    ph = __ldg(reinterpret_cast<const float2*>(fs + F_PH + c));
    m2 = __ldg(reinterpret_cast<const float2*>(fs + F_M2 + c));
    const float2 gam = __ldg(reinterpret_cast<const float2*>(fs + F_GAM + c));
    hg = make_float2(__fmul_rn(-0.5f, gam.x), __fmul_rn(-0.5f, gam.y));
  }
  // point_filter_at<true>'s operations, in its order: the filter element
  // with the backward's factors (full) or its value g (one)
  static __device__ __forceinline__ PointFilter full(float x0, float x1, float x2, float xx,
                                                     float om0, float om1, float om2, float mu0,
                                                     float mu1, float mu2, float ph, float m2,
                                                     float hg) {
    PointFilter f;
    const float s = fmaf(x2, om2, fmaf(x1, om1, __fmul_rn(x0, om0)));
    const float xm = fmaf(x2, mu2, fmaf(x1, mu1, __fmul_rn(x0, mu0)));
    f.sinarg = __fadd_rn(s, ph);
    f.q = __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xm)), m2);
    f.E = expf(__fmul_rn(hg, f.q));
    f.sn = fast_sin(f.sinarg);
    return f;
  }
  static __device__ __forceinline__ float one(float x0, float x1, float x2, float xx, float om0,
                                              float om1, float om2, float mu0, float mu1,
                                              float mu2, float ph, float m2, float hg) {
    const PointFilter f = full(x0, x1, x2, xx, om0, om1, om2, mu0, mu1, mu2, ph, m2, hg);
    return __fmul_rn(f.sn, f.E);
  }
  __device__ __forceinline__ void pair(int row, float& g0, float& g1) const {
    g0 = g1 = 0.f;
    if (row >= nvalid) return;
    const float x0 = sm.col[GC_X * TC_P + row], x1 = sm.col[(GC_X + 1) * TC_P + row];
    const float x2 = sm.col[(GC_X + 2) * TC_P + row], xx = sm.col[GC_XX * TC_P + row];
    g0 = one(x0, x1, x2, xx, om[0].x, om[1].x, om[2].x, mu[0].x, mu[1].x, mu[2].x, ph.x, m2.x,
             hg.x);
    g1 = one(x0, x1, x2, xx, om[0].y, om[1].y, om[2].y, mu[0].y, mu[1].y, mu[2].y, ph.y, m2.y,
             hg.y);
  }
};

// The epilogue of a stage over the warp's TC_P x 32 tile of the block of
// columns from nb: for each accumulator element the filter g from `filt`,
// then z = g (first) or z = (acc + bias) g, stored rounded to bf16 into the
// activation tile `out`; the last stage also adds z . ws of the thread's
// columns into sp, in float32 on the unrounded z. STASH: u = acc + bias to
// us and, last, the unrounded z to z8f (float32, row l0 + row, stride H).
template <bool STASH, typename Filt>
__device__ __forceinline__ void stage_epilogue_tc(float (&acc)[MT_F][4][4], int nb, Filt& filt,
                                                  bool first, bool last,
                                                  const float* __restrict__ bias,
                                                  const float* __restrict__ ws, bf16* out,
                                                  float (&sp)[MT_F][2], float* us, float* z8f,
                                                  size_t l0) {
  const int l = threadIdx.x & 31, g = l >> 2, c = l & 3;
  const int n0 = nb + (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + j * 8 + 2 * c;
    filt.column(col);
    float b0 = 0.f, b1 = 0.f, w0 = 0.f, w1 = 0.f;
    if (!first) {
      b0 = __ldg(bias + col);
      b1 = __ldg(bias + col + 1);
    }
    if (last) {
      w0 = __ldg(ws + col);
      w1 = __ldg(ws + col + 1);
    }
#pragma unroll
    for (int mt = 0; mt < MT_F; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        float g0, g1;
        filt.pair(row, g0, g1);
        float z0 = g0, z1 = g1;
        if (!first) {
          const float u0 = acc[mt][j][2 * h] + b0, u1 = acc[mt][j][2 * h + 1] + b1;
          z0 = __fmul_rn(u0, g0);
          z1 = __fmul_rn(u1, g1);
          if constexpr (STASH)
            *reinterpret_cast<float2*>(us + (l0 + row) * H + col) = make_float2(u0, u1);
        }
        if (last) {
          sp[mt][h] = fmaf(z0, w0, sp[mt][h]);
          sp[mt][h] = fmaf(z1, w1, sp[mt][h]);
          if constexpr (STASH)
            *reinterpret_cast<float2*>(z8f + (l0 + row) * H + col) = make_float2(z0, z1);
        }
        put2(out + row * LDS + col, z0, z1);
      }
  }
}

// The network of the chunk whose inputs are in shared memory, each stage's
// filter epilogue `epilogue(acc, nb, stage, first, last, bias, ws, out, sp)`
// (0-based stage, the block of columns from nb, the tile `out` it writes).
// Stage l (1-based) reads tile l & 1 and writes tile (l + 1) & 1 (the same
// tile at hidden 256); the remap reads the last stage's tile and writes the
// other, and the rgb head writes y back into the last stage's. Leaves sigma
// (after the ReLU, times sigma_mul) and rgb of each point in the columns
// GC_SIGMA and GC_RGB; with STASH they go to the stash's per-point columns
// instead (sigma before the ReLU, C_SIGP), with the chunk's tiles (z_i,
// feat, y) at rows l0.. (`cap` rows a column). Ends past a barrier.
template <bool STASH, typename Epi>
__device__ __forceinline__ void network_tc(const float* __restrict__ vec,
                                           const bf16* __restrict__ wmat, float sigma_mul,
                                           float rgb_mul, const GSmem& sm, const TcStash& st,
                                           size_t l0, int cap, Epi epilogue) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float sp[MT_F][2] = {};
  // ---- stages: z_1 = g_1, then z_i = (z_{i-1} W_{i-1} + b_{i-1}) g_i ----
#pragma unroll 1
  for (int l = 1; l <= NL; ++l) {
    const bool first = l == 1, last = l == NL;
    const bf16* a_in = sm.act[l & 1];
    bf16* a_out = sm.act[(l + 1) & 1];
    const float* bias = first ? nullptr : vec + (l - 2) * H;
    const float* ws = last ? vec + OFF_WS : nullptr;
    for (int nb = 0; nb < H; nb += NB) {
      float acc[MT_F][4][4];
      zero_acc(acc);
      if (!first) gemm_fwd<H, NB>(acc, a_in, LDS, wmat + off_w(l - 1) + nb, sm.wst, H);
      epilogue(acc, nb, l - 1, first, last, bias, ws, a_out, sp);
    }
    if constexpr (STASH) {
      __syncthreads();
      tile_out(a_out, LDS, H, st.z[l - 1], l0);
    }
  }
  bf16* const zt = sm.act[(NL + 1) & 1];   // z_NL, then y
  bf16* const ft = sm.act[NL & 1];         // feat
  // ---- the density row: z_NL . ws by row, the 8 warps in order ----
#pragma unroll
  for (int mt = 0; mt < MT_F; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = sp[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) sm.sig[warp * TC_P + mt * 16 + (lane >> 2) + 8 * h] = v;
    }
  __syncthreads();
  if (tid < TC_P) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sm.sig[w * TC_P + tid];
    if constexpr (STASH)
      st.cols[C_SIGP * static_cast<size_t>(cap) + l0 + tid] = s + __ldg(vec + OFF_BS);
    else
      sm.col[GC_SIGMA * TC_P + tid] = fmaxf(s + __ldg(vec + OFF_BS), 0.f) * sigma_mul;
  }
  // ---- feature remap: no activation ----
  for (int nb = 0; nb < H; nb += NB) {
    float acc[MT_F][4][4];
    zero_acc(acc);
    gemm_fwd<H, NB>(acc, zt, LDS, wmat + OFF_WRE + nb, sm.wst, H);
    store_act<4>(acc, vec + OFF_BRE, false, ft, nb);
  }
  if constexpr (STASH) {
    __syncthreads();
    tile_out(ft, LDS, H, st.feat, l0);
  }
  // ---- rgb head: relu layer on [feat, denc], then the output ----
  for (int nb = 0; nb < HR; nb += 128) {
    float acc2[MT_F][2][4];
    zero_acc(acc2);
    gemm_fwd<H, 128>(acc2, ft, LDS, wmat + OFF_WR0F + nb, sm.wst, HR);
    gemm_fwd<DP, 128>(acc2, sm.denc, LDD, wmat + OFF_WR0D + nb, sm.wst, HR);
    store_act<2>(acc2, vec + OFF_BR0, true, zt, nb);
  }
  __syncthreads();
  if constexpr (STASH) tile_out(zt, LDS, HR, st.y, l0);
  if (tid < 3 * TC_P) {
    const int ch = tid / TC_P, p = tid % TC_P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(__bfloat162float(zt[p * LDS + k]),
               __bfloat162float(wmat[OFF_WR1 + k * 8 + ch]), z);
    z = (z + __ldg(vec + OFF_BR1 + ch)) * rgb_mul;
    const float r = 1.f / (1.f + expf(-z));
    if constexpr (STASH)
      st.cols[(C_RGB + ch) * static_cast<size_t>(cap) + l0 + p] = r;
    else
      sm.col[(GC_RGB + ch) * TC_P + p] = r;
  }
  __syncthreads();
}

// The forward of ray samples [chunk0, chunk0 + nvalid) (nvalid <= TC_P). STASH
// (the train pass): what the backward needs to the stash `st` at rows l0..
// (`cap` rows a column). Else (the forward render): t, delta, sigma and rgb
// in the shared-memory columns, nothing to device memory. Ends past a
// barrier.
template <bool STASH>
__device__ void forward_chunk_gabor_tc(const RayInputs& in, const Gabor& gp,
                                       const bf16* __restrict__ wmat, int chunk0, int nvalid,
                                       const GSmem& sm, const TcStash& st, size_t l0, int cap) {
  const int S = in.S;
  load_chunk(in, chunk0, nvalid, sm);
  if constexpr (STASH) tile_out(sm.denc, LDD, DP, st.denc, l0);
  const int ray_first = chunk0 / S;
  const bool uniform = nvalid == TC_P && (chunk0 + TC_P - 1) / S == ray_first;
  const int base_u = ray_first * NH;
  network_tc<STASH>(
      in.vec, wmat, gp.sigma_mul, gp.rgb_mul, sm, st, l0, cap,
      [&](float (&acc)[MT_F][4][4], int nb, int stage, bool first, bool last,
          const float* bias, const float* ws, bf16* out, float (&sp)[MT_F][2]) {
        float* us = STASH && !first ? st.u[stage - 1] : nullptr;
        float* z8f = STASH ? st.z8f : nullptr;
        const float* coef = gp.coef + stage * H;
        if (uniform) {
          RayFilterTc<true> f{coef, gp.plane, base_u, sm};
          stage_epilogue_tc<STASH>(acc, nb, f, first, last, bias, ws, out, sp, us, z8f, l0);
        } else {
          RayFilterTc<false> f{coef, gp.plane, base_u, sm};
          stage_epilogue_tc<STASH>(acc, nb, f, first, last, bias, ws, out, sp, us, z8f, l0);
        }
      });
}

// ---------------------------------------------------------------- backward
// The network backward of the bfloat16 train pass
// (fused_render_gabor_train_tc.cu), shared with the bfloat16 field backward
// (fused_gabor_bwd_tc.cu). Each dz W^T is a tensor-core product chunk by
// chunk against the packed W itself (gemm_dact), each weight gradient A^T
// du one product over all the CTA's points (dweight_tc). The two callers
// differ in where a filter comes from and where its cotangents go: the
// stages policy of backward and dact_filter (the train pass's RayStages:
// the filter from the ray's coefficients, the rays' coefficient
// cotangents; the field's PointStages: the filter from the point, the
// banks' gradients and the point cotangent).

// Shared memory (bytes) of a backward kernel: two activation tiles (a dz
// chunk of every column, [TC_PB][LDS]; a block's staged output,
// [TC_PB][LDN]), the block's u tile (float32 [TC_PB][LDU]), the weight
// stages of a dz W^T product, a chunk's per-point columns (the heads' dzr1
// and dsig; a filter stage's dsig with the train pass's t, t^2 and local
// ray or the field's rounded point and |x|^2), a reduction buffer, and
// each column's running sums (the train pass's coefficient cotangents of
// the ray in progress, 5 x H; the field's bank gradients, 9 x H). The
// weight gradients' stages overlay the activation and u tiles (which are
// at least as large at hidden 256); the per-ray losses of the compositing
// pass the second activation tile.
constexpr int LDU = NB + 8;                       // row stride (floats) of the u tile
constexpr int BB_ACT0 = 0;
constexpr int BB_ACT1 = BB_ACT0 + TC_PB * LDS * 2;
constexpr int BB_U = BB_ACT1 + TC_PB * LDN * 2;
constexpr int BB_TILES = BB_U + TC_PB * LDU * 4;
constexpr int BB_WST = BB_TILES > DW_STAGE_BYTES ? BB_TILES : DW_STAGE_BYTES;
constexpr int BB_COL = BB_WST + WST_DACT_BYTES;
constexpr int BC_T = 0, BC_T2 = 1, BC_DSIG = 2, BC_RAY = 3, BC_X = 4, BC_XX = 7;
constexpr int N_BC = 8;
constexpr int NRUN = 9;                           // running sums a column
constexpr int BB_RED = BB_COL + N_BC * TC_PB * 4;
constexpr int BB_RUN = BB_RED + 4 * THREADS * 4;
constexpr int SMEM_BWD = BB_RUN + NRUN * H * 4;
static_assert(SMEM_BWD <= 232448, "exceeds the per-block shared memory");
static_assert(TC_PB * LDN * 2 >= TC_PB * LDG * 4, "direction cotangents fit a tile");

struct BwdSmem {
  bf16* act0;
  bf16* act1;
  float* u;
  bf16* wst;
  float* col;
  float* red;
  float* run;
};

// colsum[col] = the column sums cs of each thread's columns (colsum from
// the block's first column), over the warp's 8 row groups (lanes of the
// same column pair) by shuffles.
__device__ __forceinline__ void write_colsum(float (&cs)[4][2], float* colsum) {
  const int lane = threadIdx.x & 31, n0 = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = cs[j][u];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < 4) colsum[n0 + j * 8 + 2 * lane + u] = v;
    }
}

// dz_out = dz_in W^T over the CTA's points l < cap_c, block by block of NB
// columns and chunk by chunk of TC_PB points: dz_in (KP columns) and dz_out
// (H) bf16 with stride LDZ, W (H x KP) the packed matrix. The unrounded
// values are summed by column into colsum (H), in a fixed order; dz_out
// gets them rounded. Ends past a barrier.
template <int KP>
__device__ void dact_plain(const bf16* __restrict__ dz_in, const bf16* __restrict__ w,
                           bf16* __restrict__ dz_out, float* __restrict__ colsum, int cap_c,
                           const BwdSmem& sm) {
  const int tid = threadIdx.x, n0 = (tid >> 5) * 32;
  for (int nb = 0; nb < H; nb += NB) {
    float cs[4][2] = {};
    for (int l0 = 0; l0 < cap_c; l0 += TC_PB) {
      constexpr int CPR = KP / 8;
      for (int e = tid; e < TC_PB * CPR; e += THREADS) {
        const int r = e / CPR, q = (e % CPR) * 8;
        cp_async16(sm.act0 + r * LDS + q, dz_in + static_cast<size_t>(l0 + r) * LDZ + q);
      }
      cp_async_commit();
      float acc[MT_B][4][4];
      zero_acc(acc);
      gemm_dact<KP>(acc, sm.act0, w + static_cast<size_t>(nb) * KP, sm.wst);
      each_pair<4>(acc, n0, [&](int, int j, int, int row, int col, float& v0, float& v1) {
        cs[j][0] += v0;
        cs[j][1] += v1;
        put2(sm.act1 + row * LDN + col, v0, v1);
      });
      __syncthreads();
      tile_out(sm.act1, LDN, NB, dz_out + nb, static_cast<size_t>(l0), LDZ, TC_PB);
    }
    write_colsum(cs, colsum + nb);
  }
  __syncthreads();
}

// Filter stage `stage` (0-based) of the multiplicative chain's backward
// over the CTA's points l < cap_c, block by block of NB columns and chunk
// by chunk of TC_PB points: dz = dz_in W^T (+ dsig ws: DSIG) on the tensor
// cores, dz_in bf16 (H columns, stride LDZ) and W (H x H) the packed
// matrix, with the block's u (float32, uref) staged beside it and the
// policy's per-point columns (stages.columns, a thread a row); then the
// policy's filter epilogue (stages.chunk, given the block's first column).
// Not FIRST: du to dz_out (bf16) and its column sums (the bias gradient)
// to colsum. After each chunk stages.after_chunk, after the last block
// stages.end_stage. Ends past a barrier.
template <bool FIRST, bool DSIG, typename Stages>
__device__ void dact_filter(const bf16* __restrict__ dz_in, const bf16* __restrict__ w,
                            const float* __restrict__ uref, int stage,
                            const float* __restrict__ dsig, const float* __restrict__ wsig,
                            bf16* __restrict__ dz_out, float* __restrict__ colsum,
                            const Stages& stages, int cap_c, const BwdSmem& sm) {
  const int tid = threadIdx.x;
  for (int nb = 0; nb < H; nb += NB) {
    float cs[4][2] = {};
    for (int l0 = 0; l0 < cap_c; l0 += TC_PB) {
      for (int e = tid; e < TC_PB * (H / 8); e += THREADS) {
        const int r = e / (H / 8), q = (e % (H / 8)) * 8;
        cp_async16(sm.act0 + r * LDS + q, dz_in + static_cast<size_t>(l0 + r) * LDZ + q);
      }
      if constexpr (!FIRST) {
        for (int e = tid; e < TC_PB * (NB / 4); e += THREADS) {
          const int r = e / (NB / 4), q = (e % (NB / 4)) * 4;
          cp_async16(sm.u + r * LDU + q, uref + static_cast<size_t>(l0 + r) * H + nb + q);
        }
      }
      cp_async_commit();
      if (tid < TC_PB) {
        stages.columns(l0, sm);
        if constexpr (DSIG) sm.col[BC_DSIG * TC_PB + tid] = dsig[l0 + tid];
      }
      float acc[MT_B][4][4];
      zero_acc(acc);
      gemm_dact<H>(acc, sm.act0, w + static_cast<size_t>(nb) * H, sm.wst);
      stages.template chunk<FIRST, DSIG>(acc, nb, stage, l0, wsig, sm, cs);
      __syncthreads();
      if constexpr (!FIRST)
        tile_out(sm.act1, LDN, NB, dz_out + nb, static_cast<size_t>(l0), LDZ, TC_PB);
      stages.after_chunk(l0, sm);
    }
    if constexpr (!FIRST) write_colsum(cs, colsum + nb);
  }
  stages.end_stage(stage, sm);
  __syncthreads();
}

// The network backward (_train_kernel's; fused_gabor.py::_bwd_kernel's
// chain) over the CTA's points l < cap_c from the stash and the cotangent
// columns dzr1 and dsig, into the CTA's partial (offsets of the packed
// layout, the vectors from N_W). The policy `stages` takes each filter
// stage's epilogue (dact_filter) and stages.on_dzr0(dzr0) once dzr0 is
// complete (st.dz[0], HR columns; it may use the activation tiles and the
// weight stages, and ends past a barrier): the train pass's gives the rays'
// coefficient cotangents, the field's the banks' gradients and the point
// and direction cotangents.
template <typename Stages>
__device__ void backward(const TcStash& st, int cap, const float* __restrict__ vec,
                         const bf16* __restrict__ wmat, float* __restrict__ part, int cap_c,
                         const BwdSmem& sm, const Stages& stages) {
  const int tid = threadIdx.x;
  const size_t cz = static_cast<size_t>(cap);
  const float* dsig = st.cols + C_DSIG * cz;
  const float* dzr1 = st.cols + C_DZR1 * cz;
  float* pvec = part + N_W;
  // rgb output layer (CUDA cores), chunk by chunk, in blocks of 128 of the
  // HR columns: dzr0 = (r(dzr1) wr1^T) (y > 0) to dz[0] (HR columns), with
  // its column sums (br0) and wr1 = r(y)^T r(dzr1) in two halves of each
  // chunk's points; br1 and bs (the sums of dzr1 and dsig) by four threads
  // over the staged columns, in the first block
  constexpr int HB = THREADS / 2;
  for (int kb = 0; kb < HR; kb += HB) {
    const int k = kb + (tid & (HB - 1)), half = tid / HB;
    const float w0 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 0]);
    const float w1 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 1]);
    const float w2 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 2]);
    const bf16* __restrict__ y = st.y;
    bf16* __restrict__ dz0 = st.dz[0];
    float* col_s = sm.col;              // [4][TC_PB]: dzr1 (3), dsig
    float sb = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sx = 0.f;
    for (int l0 = 0; l0 < cap_c; l0 += TC_PB) {
      if (tid < 4 * TC_PB) {
        const int c = tid / TC_PB, p = tid % TC_PB;
        col_s[tid] = c < 3 ? dzr1[c * cz + l0 + p] : dsig[l0 + p];
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TC_PB / 2; ++j) {
        const int p = half + 2 * j;
        const size_t l = static_cast<size_t>(l0 + p);
        const float yv = __bfloat162float(y[l * HR + k]);
        const float d0 = round_bf16(col_s[p]), d1 = round_bf16(col_s[TC_PB + p]),
                    d2 = round_bf16(col_s[2 * TC_PB + p]);
        float dy = fmaf(d0, w0, 0.f);
        dy = fmaf(d1, w1, dy);
        dy = fmaf(d2, w2, dy);
        const float v = yv > 0.f ? dy : 0.f;
        dz0[l * LDZ + k] = __float2bfloat16_rn(v);
        sb += v;
        s0 = fmaf(yv, d0, s0);
        s1 = fmaf(yv, d1, s1);
        s2 = fmaf(yv, d2, s2);
      }
      if (tid < 4)
        for (int p = 0; p < TC_PB; ++p) sx += col_s[tid * TC_PB + p];
      __syncthreads();
    }
    float* red = sm.red;                // [4][256]: br0, wr1 (3) by thread
    red[tid] = sb;
    red[THREADS + tid] = s0;
    red[2 * THREADS + tid] = s1;
    red[3 * THREADS + tid] = s2;
    __syncthreads();
    if (tid < HB) {
      pvec[OFF_BR0 + kb + tid] = red[tid] + red[tid + HB];
      float* o = part + OFF_WR1 + (kb + tid) * 8;
      for (int c = 0; c < 3; ++c)
        o[c] = red[(1 + c) * THREADS + tid] + red[(1 + c) * THREADS + tid + HB];
      for (int c = 3; c < 8; ++c) o[c] = 0.f;
    } else if (tid < HB + 8 && kb == 0) {
      pvec[OFF_BR1 + tid - HB] = 0.f;
    }
    __syncthreads();
    if (kb == 0) {
      if (tid < 3) pvec[OFF_BR1 + tid] = sx;
      if (tid == 3) pvec[OFF_BS] = sx;
    }
  }
  // the density row: ws = z_NL^T dsig, a column loop on the unrounded z_NL
  for (int n = tid; n < H; n += THREADS) {
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < cap_c; ++l) s = fmaf(st.z8f[static_cast<size_t>(l) * H + n], dsig[l], s);
    pvec[OFF_WS + n] = s;
  }
  stages.on_dzr0(st.dz[0]);
  // rgb hidden layer: wr0f, wr0d; dfeat = dzr0 wr0f^T (bre)
  dweight_tc<NB, NB / 2, 4, 2>(st.feat, H, H, st.dz[0], cap_c, part + OFF_WR0F, sm.act0, HR);
  dweight_tc<32, NB / 2, 1, 8>(st.denc, DP, DP, st.dz[0], cap_c, part + OFF_WR0D, sm.act0, HR);
  dact_plain<HR>(st.dz[0], wmat + OFF_WR0F, st.dz[1], pvec + OFF_BRE, cap_c, sm);
  // feature remap: wre from r(z_NL); dz_NL = dfeat wre^T + dsig ws, then
  // stage NL's filter cotangents and du_NL (b_{NL-1}); with NL = 1 stage 1's
  dweight_tc<128, NB, 2, 4>(st.z[NL - 1], H, H, st.dz[1], cap_c, part + OFF_WRE, sm.act0, H);
  if constexpr (NL == 1) {
    dact_filter<true, true>(st.dz[1], wmat + OFF_WRE, nullptr, 0, dsig, vec + OFF_WS, nullptr,
                            nullptr, stages, cap_c, sm);
  } else {
    dact_filter<false, true>(st.dz[1], wmat + OFF_WRE, st.u[NL - 2], NL - 1, dsig,
                             vec + OFF_WS, st.dz[0], pvec + (NL - 2) * H, stages, cap_c, sm);
    // stages NL-1..2 (0-based NL-2..1): w_s from z_s and du_{s+1}; dz_s =
    // du_{s+1} w_s^T, the stage's filter cotangents and du_s (b_{s-1})
    bf16* cur = st.dz[0];
    bf16* nxt = st.dz[1];
#pragma unroll 1
    for (int s = NL - 1; s >= 2; --s) {
      dweight_tc<128, NB, 2, 4>(st.z[s - 1], H, H, cur, cap_c, part + off_w(s), sm.act0, H);
      dact_filter<false, false>(cur, wmat + off_w(s), st.u[s - 2], s - 1, nullptr, nullptr,
                                nxt, pvec + (s - 2) * H, stages, cap_c, sm);
      bf16* t = cur;
      cur = nxt;
      nxt = t;
    }
    // stage 1: w_1, then dg_1 = dz_1 (no weight before it)
    dweight_tc<128, NB, 2, 4>(st.z[0], H, H, cur, cap_c, part + off_w(1), sm.act0, H);
    dact_filter<true, false>(cur, wmat + off_w(1), nullptr, 0, nullptr, nullptr, nullptr,
                             nullptr, stages, cap_c, sm);
  }
}

}  // namespace gabor
