// The SIREN family's pieces of the fused render and field kernels for Hopper
// (sm_90a): the packed weight layout, the shared-memory plan, the inputs of
// one chunk of P points (ray samples, or field points), its forward, and
// the MLP backward over a CTA's stashed points. fused_render_siren_fwd.cu
// composites the chunk straight away; fused_render_siren_train.cu also
// stashes what its backward needs; fused_siren_fwd.cu / fused_siren_bwd.cu
// (the field) run the same chain and backward on given points. The
// generic pieces (gemm, compositing, backward blocks) are in
// render_common.cuh, shared with the NeRF family.
//
// The MLP is the one of nerf_tpu/ops/pallas/fused_siren.py::_mlp_tile on
// raw positions (p = o_aff + t d_aff, or the field's points; no positional
// encoding):
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
//
// Widths: hidden 256 with a 32-column direction encoding and 64-point
// chunks and, built with their plan's -D flags (ops/cuda/siren_plan.py:
// -DNERF_H, -DNERF_DP, -DNERF_P, ...), hidden 512 with 32-point chunks and
// 768 and 1024 with 16-point chunks (both activation buffers stay in shared
// memory), the direction encoding padded to 64 columns; every product runs
// in blocks of NB = 256 output columns (the rgb head's of 128), the weight
// stage one block's. A block changes which thread computes an output, not
// the order of its sum over k, so hidden 256 computes what it did with one.

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
// chunk columns, then the weight stage (2 x KT x NB of float32: a product's
// block of columns).
constexpr int SM_POS = SM_ACT1 + H * LDA;
constexpr int SM_DENC = SM_POS + 4 * P;
constexpr int SM_T = SM_DENC + DP * LDA;
constexpr int SM_DELTA = SM_T + P;
constexpr int SM_SIGMA = SM_DELTA + P;
constexpr int SM_RGB = SM_SIGMA + P;         // 3 x P
constexpr int SM_WST = SM_RGB + 3 * P;
constexpr int SMEM_BYTES = SM_WST * 4 + 2 * KT * NB * 4;
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
static_assert(DP <= DENC_LD, "a direction encoding wider than its stash");

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

// A sine layer's epilogue over a block of 128 NQ columns from column nb: z
// = acc + bias, arg = w0 z, h = sin(arg); out[col][ty*PT+i] = h (rounded to
// bf16 in bf16 mode). acc is left holding arg. SIGMA (the last layer) also
// adds h . ws of the thread's columns into part, in float32 on the
// unrounded h. With STASH, h goes to hs (unrounded when SIGMA, else as
// stored) and cos(arg) to cs, point-major, row l0+ty*PT+i, stride ld.
template <int NQ, bool BF16, bool STASH, bool SIGMA>
__device__ __forceinline__ void sine_epilogue(float (&acc)[PT][4 * NQ],
                                              const float* __restrict__ bias,
                                              float w0, float* out_s, float* hs,
                                              float* cs, int ld, size_t l0,
                                              const float* __restrict__ ws,
                                              float (&part)[PT], int nb = 0) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float v[4][PT];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = nb + q * 128 + tx * 4 + u;
      const float b = __ldg(bias + col);
      const float wsv = SIGMA ? __ldg(ws + col) : 0.f;
      float o[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const float arg = __fmul_rn(w0, acc[i][q * 4 + u] + b);
        acc[i][q * 4 + u] = arg;
        const float h = sine<BF16>(arg);
        if (SIGMA) part[i] = fmaf(h, wsv, part[i]);
        o[i] = BF16 ? round_bf16(h) : h;
        v[u][i] = SIGMA ? h : o[i];
      }
      store_pts(out_s + col * LDA + ty * PT, o);
    }
    if (STASH) {
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const size_t off = (l0 + ty * PT + i) * ld + nb + q * 128 + tx * 4;
        *reinterpret_cast<float4*>(hs + off) =
            make_float4(v[0][i], v[1][i], v[2][i], v[3][i]);
        *reinterpret_cast<float4*>(cs + off) = make_float4(
            cosine<BF16>(acc[i][q * 4]), cosine<BF16>(acc[i][q * 4 + 1]),
            cosine<BF16>(acc[i][q * 4 + 2]), cosine<BF16>(acc[i][q * 4 + 3]));
      }
    }
  }
}

// The inputs of ray samples [chunk0, chunk0 + nvalid) (nvalid <= P) into
// shared memory: the raw positions o_aff + t d_aff (rounded to bf16 in BF16
// mode), the view direction's encoding (exact sine), t and delta; zero past
// nvalid. Ends past a barrier.
template <bool BF16>
__device__ void load_ray_chunk(const RayInputs& in, int chunk0, int nvalid,
                               float* smem) {
  float* pos = smem + SM_POS;
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* delta_s = smem + SM_DELTA;
  const int tid = threadIdx.x;
  const int S = in.S;
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
}

// The inputs of field points [p0, p0 + nvalid) (nvalid <= P), given with
// their directions (n, 3), into shared memory, zero past nvalid: the points
// themselves (rounded to bf16 in BF16 mode, as _mm rounds pts8) and the
// direction encoding with the EXACT sine (fused_siren.py::_forward_tile
// encodes with jnp.sin in both modes; only the layers take the fast sine).
// Ends past a barrier.
template <bool BF16>
__device__ void load_point_chunk(const float* __restrict__ pts,
                                 const float* __restrict__ dirs, int p0, int nvalid,
                                 int real_d, float* smem) {
  float* pos = smem + SM_POS;
  float* denc = smem + SM_DENC;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 3 * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (p < nvalid) {
      v = pts[static_cast<size_t>(p0 + p) * 3 + c];
      if (BF16) v = round_bf16(v);
    }
    pos[c * P + p] = v;
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

// The SIREN chain of the chunk whose positions and direction encoding are
// in shared memory: leaves sigma (after the ReLU and sigma_mul) and rgb of
// each of its P points in shared memory. With STASH what the backward
// needs also goes to `st` at local rows l0.. (all P rows, the ones past the
// chunk's points from zero inputs). Each product runs in blocks of NB
// output columns (one at hidden 256), the rgb head's in blocks of 128.
template <bool BF16, bool STASH, typename WT>
__device__ void mlp_chunk(const float* __restrict__ vec, const WT* __restrict__ wmat,
                          const Siren& sp, float* smem, const Stash& st, size_t l0) {
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* pos = smem + SM_POS;
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
    for (int idx = tid; idx < 3 * P; idx += THREADS) {
      const int c = idx / P, p = idx % P;
      st.pos[static_cast<size_t>(c) * st.cap + l0 + p] = pos[c * P + p];
    }
  }
#define HS(l) (STASH ? st.h[l] : nullptr)
#define CS(l) (STASH ? st.c[l] : nullptr)

  const int tx = tid & 31, ty = tid >> 5;
  float part[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) part[i] = 0.f;

  // ---- layer 1 (K = 3): straight from the positions ----
  for (int nb = 0; nb < H; nb += NB) {
    float acc2[PT][8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float w[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        load4(wmat + OFF_W1 + k * H + nb + q * 128 + tx * 4, w[k]);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int p = ty * PT + i;
        const float x0 = pos[p], x1 = pos[P + p], x2 = pos[2 * P + p];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float a = fmaf(x0, w[0][u], 0.f);
          a = fmaf(x1, w[1][u], a);
          acc2[i][q * 4 + u] = fmaf(x2, w[2][u], a);
        }
      }
    }
    sine_epilogue<2, BF16, STASH, false>(acc2, vec + 0 * H, sp.w0, act0, HS(0), CS(0), H,
                                         l0, nullptr, part, nb);
  }
  // ---- sine layers 2..7, ping-pong between the activation buffers ----
#pragma unroll 1
  for (int l = 2; l < NL; ++l) {
    const float* src = (l & 1) ? act1 : act0;
    float* dst = (l & 1) ? act0 : act1;
    for (int nb = 0; nb < H; nb += NB) {
      float acc2[PT][8];
      zero<2>(acc2);
      gemm_acc<H, 2>(acc2, src, wmat + off_w(l) + nb, wst, H);
      sine_epilogue<2, BF16, STASH, false>(acc2, vec + (l - 1) * H, sp.w0h, dst,
                                           HS(l - 1), CS(l - 1), H, l0, nullptr, part, nb);
    }
  }
  // ---- layer 8 (act0 -> act1) and the density row ----
  for (int nb = 0; nb < H; nb += NB) {
    float acc2[PT][8];
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act0, wmat + off_w(NL) + nb, wst, H);
    sine_epilogue<2, BF16, STASH, true>(acc2, vec + (NL - 1) * H, sp.w0h, act1,
                                        HS(NL - 1), CS(NL - 1), H, l0, vec + OFF_WS, part, nb);
  }
  // each thread summed h8 . ws over its 8 columns of every block; the warp's
  // 32 lanes (same PT points, all H columns) reduce by shuffle
#pragma unroll
  for (int i = 0; i < PT; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
  }
  if (tx == 0) {
    const float bs = __ldg(vec + OFF_BS);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const float sp_pre = part[i] + bs;
      sig_s[ty * PT + i] = fmaxf(sp_pre, 0.f) * sp.sigma_mul;
      if (STASH) st.sigma_pre[l0 + ty * PT + i] = sp_pre;
    }
  }
  // ---- feature remap: no activation (act1 -> act0) ----
  for (int nb = 0; nb < H; nb += NB) {
    float acc2[PT][8];
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act1, wmat + OFF_WRE + nb, wst, H);
    epilogue<2, BF16>(acc2, vec + OFF_BRE, false, act0, STASH ? st.feat : nullptr, H, l0, nb);
  }
  // ---- rgb head: sine layer on [feat, denc] (-> act1), then the output ----
  for (int nb = 0; nb < HR; nb += 128) {
    float acc1[PT][4];
    zero<1>(acc1);
    gemm_acc<H, 1>(acc1, act0, wmat + OFF_WR0F + nb, wst, HR);
    gemm_acc<DP, 1>(acc1, denc, wmat + OFF_WR0D + nb, wst, HR);
    sine_epilogue<1, BF16, STASH, false>(acc1, vec + OFF_BR0, sp.w0h, act1,
                                         STASH ? st.y : nullptr, STASH ? st.cr0 : nullptr,
                                         HR, l0, nullptr, part, nb);
  }
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

// The forward of ray samples [chunk0, chunk0 + nvalid) (nvalid <= P): leaves
// t, delta, sigma and rgb of each point in shared memory (see mlp_chunk).
template <bool BF16, bool STASH, typename WT>
__device__ void forward_chunk(const RayInputs& in, const WT* __restrict__ wmat,
                              const Siren& sp, int chunk0, int nvalid,
                              float* smem, const Stash& st, size_t l0) {
  load_ray_chunk<BF16>(in, chunk0, nvalid, smem);
  mlp_chunk<BF16, STASH>(in.vec, wmat, sp, smem, st, l0);
}

// ---------------------------------------------------------------- backward

constexpr int N_TOT = N_W + N_B;                 // gradient floats
constexpr int NPART = (N_TOT + 1 + 3) / 4 * 4;   // per-CTA: gradients, loss
constexpr int C_POS = 11;                        // after the shared C_* columns
constexpr int N_COLS = 16;
constexpr int FLOATS_PER_POINT =
    2 * NL * H + H + 2 * HR + DENC_LD + 2 * LDZ + N_COLS;
static_assert(FLOATS_PER_POINT % 4 == 0, "stash rows must stay 16-byte aligned");
static_assert(C_POS > C_DSIG && C_POS + 3 <= N_COLS, "column plan");

// One CTA's scratch in device memory: the stash, two dz buffers (points x
// LDZ each) and the per-point columns.
struct Scratch {
  Stash st;
  float* dz[2];
  float* cols;            // N_COLS x cap
};

__device__ inline Scratch carve(float* p, int cap) {
  Scratch s;
  const size_t c = static_cast<size_t>(cap);
  for (int i = 0; i < NL; ++i) { s.st.h[i] = p; p += c * H; }
  for (int i = 0; i < NL; ++i) { s.st.c[i] = p; p += c * H; }
  s.st.feat = p; p += c * H;
  s.st.y = p; p += c * HR;
  s.st.cr0 = p; p += c * HR;
  s.st.denc = p; p += c * DENC_LD;
  s.dz[0] = p; p += c * LDZ;
  s.dz[1] = p; p += c * LDZ;
  s.cols = p;
  s.st.sigma_pre = p + C_SIGP * c;
  s.st.rgb = p + C_RGB * c;
  s.st.pos = p + C_POS * c;
  s.st.cap = cap;
  return s;
}

// One sine layer of the backward, l = 8..2: from cur = dz_l, the next
// dz_{l-1} = ((dz_l W_l^T) * w0_{l-1}) * cos(w0_{l-1} z_{l-1}) into nxt,
// dW_l = h_{l-1}^T dz_l and db_l = sum dz_l.
template <bool BF16, typename WT>
__device__ void back_layer(const float* cur, const WT* __restrict__ wT,
                           const float* h_prev, const float* c_prev, float w0_prev,
                           float* nxt, float* part_w, float* part_b, int cap_c,
                           float* smem) {
  dact<H, BF16, Epi::Cos, false>(cur, wT, c_prev, H, nullptr, nullptr, w0_prev, nxt,
                                 cap_c, smem, reinterpret_cast<WT*>(smem + SM_WST), H);
  dweight<2, false, BF16>(h_prev, H, H, H, cur, cap_c, part_w, smem, H);
  colsum(cur, H, cap_c, part_b);
  __syncthreads();
}

// The MLP backward (fused_siren.py::_mlp_bwd_core) over the CTA's points
// l < cap_c, layer by layer, from the stash and the cotangent columns dzr1
// (the sigmoid input's, times rgb_mul) and dsig (the density
// pre-activation's, times sigma_mul): each dz (points x H, float32,
// unrounded) chunk by chunk into the other dz buffer (dz W^T on the
// forward's register-tiled gemm against the transposed matrices wmat_t, in
// blocks of NB columns, its epilogue multiplying by w0 and the stashed
// cosine), and each weight gradient as one product A^T dz over the CTA's
// points with its 64 x 256 output strips in registers, written once per
// CTA into `part` (offsets of
// the packed layout, the vectors from N_W). The first layer's gradient (K
// = 3) is a plain column loop; bias, ws and bs gradients are column sums.
// `on_dzr0(dzr0)` runs once dzr0 (points x HR at stride LDZ) is complete,
// before its buffer is reused (the field backward takes the direction
// cotangent there). Returns the buffer holding dz1; ends past a barrier.
// Rounding in BF16 mode follows _mlp_bwd_core: both operands of every dW
// product and the dz of every dz W^T are rounded to bf16, sums are
// float32, and h8, sigma_pre and the rgb sigmoid are read in float32.
template <bool BF16, typename WT, typename OnDzr0>
__device__ const float* mlp_backward(const Scratch& sc, size_t cz,
                                     const float* __restrict__ vec,
                                     const WT* __restrict__ wmat,
                                     const WT* __restrict__ wmat_t, const Siren& sp,
                                     float* part, int cap_c, float* smem,
                                     OnDzr0 on_dzr0) {
  const int tid = threadIdx.x;
  const float* cols = sc.cols;
  const float* dsig = cols + C_DSIG * cz;
  const float* h8 = sc.st.h[NL - 1];
  float* dzA = sc.dz[0];
  float* dzB = sc.dz[1];
  float* pvec = part + N_W;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  // rgb output layer: dy = dzr1 wr1^T (3 live columns),
  // dzr0 = (dy * w0h) * cos(w0h zr0)
  for (int idx = tid; idx < cap_c * HR; idx += THREADS) {
    const int l = idx / HR, k = idx % HR;
    float dy = 0.f;
    for (int c = 0; c < 3; ++c) {
      float d = cols[(C_DZR1 + c) * cz + l];
      if (BF16) d = round_bf16(d);
      dy = fmaf(d, load1(wmat + OFF_WR1 + k * 8 + c), dy);
    }
    dzA[static_cast<size_t>(l) * LDZ + k] =
        (dy * sp.w0h) * sc.st.cr0[static_cast<size_t>(l) * HR + k];
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
      s = fmaf(h8[static_cast<size_t>(l) * H + k], dsig[l], s);
    pvec[OFF_WS + k] = s;
  }
  __syncthreads();
  // rgb sine layer: dfeat = dzr0 wr0f^T; wr0f, wr0d, br0
  dact<HR, BF16, Epi::None, false>(dzA, wmat_t + OFF_WR0F, nullptr, 0, nullptr,
                                   nullptr, 1.f, dzB, cap_c, smem, wst, H);
  dweight<1, false, BF16>(sc.st.feat, H, H, H, dzA, cap_c, part + OFF_WR0F, smem, HR);
  dweight<1, false, BF16>(sc.st.denc, DENC_LD, DENC_LD, DP, dzA, cap_c,
                          part + OFF_WR0D, smem, HR);
  colsum(dzA, HR, cap_c, pvec + OFF_BR0);
  __syncthreads();
  on_dzr0(static_cast<const float*>(dzA));
  // feature remap: dz8 = ((dfeat wre^T + dsig ws) * w0h) * cos(w0h z8);
  // wre from the unrounded h8, bre (dact's first barrier also orders
  // on_dzr0's reads of dzA before its writes)
  dact<H, BF16, Epi::Cos, true>(dzB, wmat_t + OFF_WRE, sc.st.c[NL - 1], H, dsig,
                                vec + OFF_WS, sp.w0h, dzA, cap_c, smem, wst, H);
  dweight<2, BF16, BF16>(h8, H, H, H, dzB, cap_c, part + OFF_WRE, smem, H);
  colsum(dzB, H, cap_c, pvec + OFF_BRE);
  __syncthreads();
  // sine layers 8..2
  float* cur = dzA;
  float* nxt = dzB;
#pragma unroll 1
  for (int l = NL; l >= 2; --l) {
    back_layer<BF16>(cur, wmat_t + off_w(l), sc.st.h[l - 2], sc.st.c[l - 2],
                     l == 2 ? sp.w0 : sp.w0h, nxt, part + off_w(l),
                     pvec + (l - 1) * H, cap_c, smem);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // first layer: dW1 = pos^T dz1 (rows 3..7 zero), db1
  const float* pos = cols + C_POS * cz;
  for (int n = tid; n < H; n += THREADS) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int l = 0; l < cap_c; ++l) {
      float d = cur[static_cast<size_t>(l) * LDZ + n];
      if (BF16) d = round_bf16(d);
      s0 = fmaf(pos[l], d, s0);
      s1 = fmaf(pos[cz + l], d, s1);
      s2 = fmaf(pos[2 * cz + l], d, s2);
    }
    part[OFF_W1 + 0 * H + n] = s0;
    part[OFF_W1 + 1 * H + n] = s1;
    part[OFF_W1 + 2 * H + n] = s2;
    for (int k = 3; k < 8; ++k) part[OFF_W1 + k * H + n] = 0.f;
  }
  colsum(cur, H, cap_c, pvec + 0 * H);
  __syncthreads();
  return cur;
}

}  // namespace siren
