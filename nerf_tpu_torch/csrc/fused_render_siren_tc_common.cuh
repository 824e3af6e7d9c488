// The SIREN family's forward chain on Hopper's tensor cores (sm_90a), over
// one chunk of TC_P points, shared by the bfloat16 train pass
// (fused_render_siren_train_tc.cu, which stashes what its backward needs),
// the bfloat16 forward render (fused_render_siren_fwd_tc.cu, which keeps
// each point's density and colour in shared memory and composites them
// straight away), the bfloat16 field forward (fused_siren_fwd_tc.cu, which
// writes them out in point order) and the bfloat16 field backward
// (fused_siren_bwd_tc.cu, which stashes as the train pass does). One
// chain, so the train pass's and the field backward's forward outputs are
// the forward render's and the field forward's bit for bit. The chunk's
// input stage is a loader policy: ray samples (load_chunk_tc) or given
// points and directions (load_point_chunk_tc). The MLP backward over a
// CTA's stash (backward, at the end), shared by the train pass and the
// field backward, closes the file.
//
// The chain is nerf_tpu/ops/pallas/fused_siren.py::_mlp_tile in bfloat16,
// at its rounding points:
//   * the raw positions (p = o_aff + t d_aff, or the given points) rounded
//     to bf16, and layer 1 (K = 3) on the CUDA cores in mlp_chunk's fmaf
//     order (x0 w0, then x1 w1, then x2 w2): at w0 = 30 one ulp of the
//     argument flips bf16 roundings downstream;
//   * layers 2..8, the feature remap and the rgb head's [feat, denc]
//     product on render_tc.cuh's gemm_fwd (mma.sync m16n8k16, bf16
//     operands, float32 sums), each sine layer's epilogue in the
//     accumulator layout: arg = w0 (acc + b) rounded as written, h =
//     fast_sin(arg) (the degree-11 sine of the TPU kernel's _trig), h
//     rounded to bf16 as the next product's operand;
//   * the density: the UNROUNDED h8 . ws summed in float32 over the
//     thread's columns, the 4 lanes of a row by shuffle, the 8 warps in
//     order; plus bs, relu, times sigma_mul; the feature product reads the
//     rounded h8;
//   * the rgb head's sine (w0h) in its product's epilogue, its 128 x 3
//     output layer and the sigmoid on the CUDA cores.
// Near ties (layers 2..8). The mma sums a product's terms in its own
// order; the plain version sums them in sequential k order (cuBLAS's
// float32 GEMM: fmaf from k = 0, as the CUDA-core kernels'
// render_common.cuh::gemm_acc). The two sums differ by a few ulps, which
// changes nothing unless h lies that close to the midpoint between two
// bf16 values: then the orders round h to different neighbours, and such a
// flip spreads through the later sine layers into sigma (times sigma_mul)
// and moves a sample's compositing weight by up to about 1e-3 (5e-3 at S =
// 37). So an element whose h is within TIE_ULPS * 2^-24 * w0 (|acc + b| +
// 1) of a midpoint is recomputed in sequential k order on the CUDA cores,
// from the product's own operands, and rounds as the plain version's does.
// The sums of all other elements round alike in either order, so every
// bf16 activation is the plain version's. chip_tie_margin.py sweeps the
// margin on the card: at hidden 256, 8 left flips and 16 none; at 512, 16
// left flips and 32 none; at 1024, 32 left flips and 64 none (the two
// orders' gap grows with the K = H terms of a sum). TIE_ULPS is twice the
// smallest clean margin, H / 8: 32 at 256, 64 at 512, 128 at 1024
// (siren_plan.py's tie_ulps). The field forward's larger sigma errors at
// 37 and 1,000 points (up to 2.6e-3 of the max at 512-1024, whatever the
// margin) are the plain version's own: cuBLAS sums a float32 GEMM of so
// few rows in another k order. The same points inside a 65,536-point batch
// get the kernel's bits, and the plain version there agrees within 5.1e-7
// (chip_tie_margin.py prints both). Each
// hidden layer reads one of two activation tiles and writes the other: its
// input stays in shared memory until the ties are recomputed. The ties,
// a small share of a layer's elements, are listed in shared memory and
// shared out over the CTA's threads (past TIE_CAP a thread recomputes its
// own).
// With STASH each sine epilogue also writes cos(arg) = fast_sin(arg +
// pi/2) in float32 (the backward's derivative factor, from the forward's
// own argument), and h8 unrounded.
//
// Widths: hidden 256 with a 32-column direction encoding (64-point chunks,
// two CTAs an SM) and, built with their plan's -D flags
// (ops/cuda/siren_plan.py), hidden 512, 768 and 1024 and the direction
// encoding padded to 64 columns. Every product runs in blocks of NB = 256
// output columns (the rgb head's of 128) over the whole input, from one
// activation tile into the other, and each block's near ties are
// recomputed from the layer's input tile before the next block; forward
// chunks of 64 points up to hidden 512 and 32 wider, one CTA an SM where
// two do not fit; the backward's dz W^T in chunks of TC_PB points and
// blocks of NB columns, each with its block of cosines. A block changes
// which warp computes an output, never the order of its sum over k, so
// hidden 256 computes what it did with one block.

#pragma once

#include "render_tc.cuh"
#include "fused_render_siren_common.cuh"

namespace siren {

// Shared memory (bytes) of a forward CTA: two activation tiles (a hidden
// layer reads one and writes the other; the feature remap and the rgb head
// overwrite their input once the product has read it), the direction
// encoding, the weight stages, the density partials, then the chunk's
// per-point columns (SC_*, floats, TC_P each): the rounded positions (3), t,
// delta, sigma (after the ReLU), rgb (3). Two CTAs share an SM at hidden 256
// with a 32-column direction encoding (siren_plan.py's fwd_ctas_per_sm).
constexpr int SB_ACT = 0;
constexpr int SB_DENC = SB_ACT + 2 * TC_P * LDS * 2;
constexpr int SB_WST = SB_DENC + TC_P * LDD * 2;
constexpr int SB_SIG = SB_WST + WST_FWD_BYTES;
constexpr int SB_COL = SB_SIG + WARPS * TC_P * 4;
constexpr int SC_POS = 0, SC_T = 3, SC_DELTA = 4, SC_SIGMA = 5, SC_RGB = 6, N_SC = 9;
// then the near ties of a block (see the header): two counts (odd and even
// blocks of the chain: one is reset while the other is read) and their
// positions (row H + column: TC_P H is at most 32,768)
constexpr int TIE_CAP = 1024;
constexpr int TIE_ULPS = H / 8;
constexpr int SB_TIE = SB_COL + N_SC * TC_P * 4;
constexpr int SB_END = SB_TIE + 16 + TIE_CAP * 2;
static_assert(SB_END <= 232448, "exceeds the per-block shared memory");
static_assert(H != NB || DP != 32 || 2 * (SB_END + 1024) <= 233472,
              "two forward CTAs share an SM");
static_assert(TC_P * H <= 65536, "a near tie's position fits 16 bits");

struct TcSmem {
  bf16* act[2];
  bf16* denc;
  bf16* wst;
  float* sig;
  float* col;
  int* tie_n;
  unsigned short* tie_at;
};

__device__ __forceinline__ TcSmem carve_smem(unsigned char* sb) {
  bf16* act = reinterpret_cast<bf16*>(sb + SB_ACT);
  return TcSmem{{act, act + TC_P * LDS}, reinterpret_cast<bf16*>(sb + SB_DENC),
                reinterpret_cast<bf16*>(sb + SB_WST), reinterpret_cast<float*>(sb + SB_SIG),
                reinterpret_cast<float*>(sb + SB_COL), reinterpret_cast<int*>(sb + SB_TIE),
                reinterpret_cast<unsigned short*>(sb + SB_TIE + 16)};
}

// One train CTA's device-memory stash, point-major with the CTA-local point
// as the row: h1..h8 rounded, feat and the two dz buffers (bf16, H
// columns), y (HR), denc (DP), then h8 unrounded and c1..c8 = cos(w0_l
// z_l) (float32, H), cr0 = cos(w0h zr0) (HR) and the per-point columns
// (float32, N_COLS x cap; render_common.cuh C_* and C_POS).
struct TcStash {
  bf16* h[NL];
  bf16* feat;
  bf16* dz[2];
  bf16* y;
  bf16* denc;
  float* h8f;
  float* c[NL];
  float* cr0;
  float* cols;
};

// The inputs of ray samples [chunk0, chunk0 + nvalid) into shared memory,
// zero past nvalid, as fused_render_siren_common.cuh::load_ray_chunk<true>:
// the raw positions rounded to bf16 (float32 columns), the direction
// encoding (exact sine) rounded to bf16 (point-major); with COLS also t and
// delta (the 1e10 tail). Ends past a barrier.
template <bool COLS>
__device__ void load_chunk_tc(const RayInputs& in, int chunk0, int nvalid, const TcSmem& sm) {
  const int tid = threadIdx.x, S = in.S;
  if (tid < 3 * TC_P) {
    const int c = tid / TC_P, p = tid % TC_P;
    float v = 0.f;
    if (p < nvalid) {
      const int g = chunk0 + p;
      const int ray = g / S;
      v = round_bf16(__fadd_rn(in.o_aff[ray * 3 + c], __fmul_rn(in.t[g], in.d_aff[ray * 3 + c])));
    }
    sm.col[(SC_POS + c) * TC_P + p] = v;
  }
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
  if constexpr (COLS) {
    if (tid < TC_P) {
      const int g = chunk0 + tid;
      float tv = 0.f, dv = 0.f;
      if (tid < nvalid) {
        tv = in.t[g];
        dv = (g % S == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
      }
      sm.col[SC_T * TC_P + tid] = tv;
      sm.col[SC_DELTA * TC_P + tid] = dv;
    }
  }
  __syncthreads();
}

// The inputs of field points [p0, p0 + nvalid), given with their
// directions, into shared memory, zero past nvalid, as
// fused_render_siren_common.cuh::load_point_chunk<true>: the raw points
// rounded to bf16 (float32 columns), the direction encoding (exact sine)
// rounded to bf16 (point-major). Ends past a barrier.
__device__ void load_point_chunk_tc(const float* __restrict__ pts,
                                    const float* __restrict__ dirs, int p0, int nvalid,
                                    int real_d, const TcSmem& sm) {
  const int tid = threadIdx.x;
  if (tid < 3 * TC_P) {
    const int c = tid / TC_P, p = tid % TC_P;
    float v = 0.f;
    if (p < nvalid) v = round_bf16(pts[static_cast<size_t>(p0 + p) * 3 + c]);
    sm.col[(SC_POS + c) * TC_P + p] = v;
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

// Whether h = fast_sin(w0 s) is a near tie (see the header), m = w0
// TIE_ULPS 2^-24: within m (|s| + 1) of the midpoint between its two bf16
// neighbours (h and the midpoint share sign and exponent, so their
// difference is exact).
__device__ __forceinline__ bool near_tie(float h, float s, float m) {
  const float mid = __uint_as_float((__float_as_uint(h) & 0xffff0000u) | 0x8000u);
  return fabsf(h - mid) <= fmaf(fabsf(s), m, m);
}

// bf16(fast_sin(w0 (a_row . W[:, col] + b))) with the dot product summed in
// sequential k order from zero, as render_common.cuh::gemm_acc sums it (W
// row-major, K = H, col any of its H columns). Out of line: it runs for a
// few elements a layer.
__device__ __noinline__ bf16 seq_sine(const bf16* a_row, const bf16* __restrict__ w, int col,
                                      float b, float w0) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; k += 8) {
    const uint4 pk = *reinterpret_cast<const uint4*>(a_row + k);
    const bf16* a8 = reinterpret_cast<const bf16*>(&pk);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc = fmaf(__bfloat162float(a8[u]), __bfloat162float(w[(k + u) * H + col]), acc);
  }
  return __float2bfloat16_rn(fast_sin(__fmul_rn(w0, acc + b)));
}

// A sine layer's epilogue over the warp's (16 MT) x 8 NT tile from column
// n0: arg = w0 (acc + b), h = fast_sin(arg), out[row][col] = h rounded to
// bf16. SIGMA (layer 8) also adds the unrounded h . ws of the thread's
// columns into sp (by row slot). STASH: cos(arg) to cs (float32, row l0 +
// row, stride ld) and, with SIGMA, the unrounded h to hf (float32, stride
// H). TIES (a block of a hidden layer of K = H, its input tile `in` and
// weights `w`, tie count `par` of sm): the near ties are recomputed in
// sequential k order over `in` and overwritten in `out`; count par ^ 1 is
// reset for the next block. The caller's next barrier publishes `out`.
template <int NT, int MT, bool STASH, bool SIGMA, bool TIES>
__device__ __forceinline__ void sine_tc(float (&acc)[MT][NT][4], int n0,
                                        const float* __restrict__ bias, float w0, bf16* out,
                                        float* cs, int ld, float* hf, size_t l0,
                                        const float* __restrict__ ws, float (&sp)[MT][2],
                                        const bf16* in = nullptr,
                                        const bf16* __restrict__ w = nullptr,
                                        const TcSmem* sm = nullptr, int par = 0) {
  static_assert(MT * NT * 4 <= 64, "a thread's elements fit the tie mask");
  // this thread's near ties, by element e = ((mt NT + j) 2 + hh) 2 + u in
  // each_pair's order, and the row and column of element e
  unsigned long long tie = 0;
  const float m = w0 * (TIE_ULPS * 0x1p-24f);
  const int lane = threadIdx.x & 31;
  auto row_of = [&](int e) { return (e / (4 * NT)) * 16 + (lane >> 2) + 8 * (e >> 1 & 1); };
  auto col_of = [&](int e) { return n0 + (e >> 2) % NT * 8 + 2 * (lane & 3) + (e & 1); };
  each_pair<NT>(acc, n0, [&](int mt, int j, int hh, int row, int col, float& v0, float& v1) {
    const float s0 = v0 + __ldg(bias + col), s1 = v1 + __ldg(bias + col + 1);
    const float a0 = __fmul_rn(w0, s0), a1 = __fmul_rn(w0, s1);
    const float h0 = fast_sin(a0), h1 = fast_sin(a1);
    if constexpr (SIGMA) {
      sp[mt][hh] = fmaf(h0, __ldg(ws + col), sp[mt][hh]);
      sp[mt][hh] = fmaf(h1, __ldg(ws + col + 1), sp[mt][hh]);
    }
    if constexpr (STASH) {
      *reinterpret_cast<float2*>(cs + (l0 + row) * ld + col) =
          make_float2(cosine<true>(a0), cosine<true>(a1));
      if constexpr (SIGMA)
        *reinterpret_cast<float2*>(hf + (l0 + row) * H + col) = make_float2(h0, h1);
    }
    put2(out + row * LDS + col, h0, h1);
    if constexpr (TIES) {
      const int e = ((mt * NT + j) << 1 | hh) << 1;
      tie |= static_cast<unsigned long long>(near_tie(h0, s0, m)) << e;
      tie |= static_cast<unsigned long long>(near_tie(h1, s1, m)) << (e + 1);
    }
  });
  if constexpr (TIES) {
    unsigned long long own = 0;   // ties past TIE_CAP: this thread recomputes them
    for (unsigned long long t = tie; t; t &= t - 1) {
      const int e = __ffsll(static_cast<long long>(t)) - 1;
      const int i = atomicAdd(sm->tie_n + par, 1);
      if (i < TIE_CAP)
        sm->tie_at[i] = static_cast<unsigned short>(row_of(e) * H + col_of(e));
      else
        own |= 1ull << e;
    }
    __syncthreads();
    const int n = min(sm->tie_n[par], TIE_CAP);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int row = sm->tie_at[i] / H, col = sm->tie_at[i] % H;
      out[row * LDS + col] = seq_sine(in + row * LDS, w, col, __ldg(bias + col), w0);
    }
    for (; own; own &= own - 1) {
      const int e = __ffsll(static_cast<long long>(own)) - 1, row = row_of(e), col = col_of(e);
      out[row * LDS + col] = seq_sine(in + row * LDS, w, col, __ldg(bias + col), w0);
    }
    if (threadIdx.x == 0) sm->tie_n[par ^ 1] = 0;
  }
}

// The forward of one chunk whose inputs `load()` puts in shared memory (the
// rounded positions and the direction encoding, and the ray loader's t and
// delta columns; it ends past a barrier). STASH (the train pass): what the
// backward needs to the stash `st` at rows l0.., sigma_pre, rgb and the
// rounded positions to its per-point columns (`cap` long). Else (the
// forward render and the field forward): sigma (after the ReLU, times
// sigma_mul) and rgb to the shared-memory columns sm.col (SC_*), nothing to
// device memory. Ends past a barrier.
template <bool STASH, typename Load>
__device__ void forward_chain_siren_tc(Load load, const float* __restrict__ vec, const Siren& sp,
                                       const bf16* __restrict__ wmat, const TcSmem& sm,
                                       const TcStash& st, size_t l0, int cap) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, n0 = warp * 32;
  const size_t cz = static_cast<size_t>(cap);
  if (tid < 2) sm.tie_n[tid] = 0;
  load();
  const float* pos = sm.col + SC_POS * TC_P;
  if constexpr (STASH) {
    tile_out(sm.denc, LDD, DP, st.denc, l0);
    if (tid < 3 * TC_P)
      st.cols[(C_POS + tid / TC_P) * cz + l0 + tid % TC_P] = pos[tid];
  }
  // the train pass's copy of the activation tile to the stash
  auto stash_act = [&](const bf16* tile, int ncols, bf16* dst) {
    if constexpr (STASH) {
      __syncthreads();
      tile_out(tile, LDS, ncols, dst, l0);
    }
  };
  float part[MT_F][2] = {};
  int par = 0;               // the tie count of the next block with ties
  // ---- layer 1 (K = 3) on the CUDA cores, straight into the accumulators ----
  for (int nb = 0; nb < H; nb += NB) {
    float acc[MT_F][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = nb + n0 + j * 8 + 2 * c;
      float w[3][2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[k][0] = __bfloat162float(wmat[OFF_W1 + k * H + col]);
        w[k][1] = __bfloat162float(wmat[OFF_W1 + k * H + col + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT_F; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mt * 16 + g + 8 * hh;
          const float x0 = pos[row], x1 = pos[TC_P + row], x2 = pos[2 * TC_P + row];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float a = fmaf(x0, w[0][u], 0.f);
            a = fmaf(x1, w[1][u], a);
            acc[mt][j][2 * hh + u] = fmaf(x2, w[2][u], a);
          }
        }
    }
    sine_tc<4, MT_F, STASH, false, false>(acc, nb + n0, vec, sp.w0, sm.act[0], st.c[0], H,
                                          nullptr, l0, nullptr, part);
  }
  stash_act(sm.act[0], H, st.h[0]);
  // ---- sine layers 2..8: layer l reads tile l & 1 and writes the other,
  // block by block; layer 8 (tile 0 -> tile 1) also sums the density row ----
#pragma unroll 1
  for (int l = 2; l <= NL; ++l) {
    const bf16* a_in = (l & 1) ? sm.act[1] : sm.act[0];
    bf16* a_out = (l & 1) ? sm.act[0] : sm.act[1];
    for (int nb = 0; nb < H; nb += NB) {
      float acc[MT_F][4][4];
      zero_acc(acc);
      gemm_fwd<H, NB>(acc, a_in, LDS, wmat + off_w(l) + nb, sm.wst, H);
      if (l < NL)
        sine_tc<4, MT_F, STASH, false, true>(acc, nb + n0, vec + (l - 1) * H, sp.w0h, a_out,
                                             st.c[l - 1], H, nullptr, l0, nullptr, part, a_in,
                                             wmat + off_w(l), &sm, par);
      else
        sine_tc<4, MT_F, STASH, true, true>(acc, nb + n0, vec + (NL - 1) * H, sp.w0h, a_out,
                                            st.c[NL - 1], H, st.h8f, l0, vec + OFF_WS, part,
                                            a_in, wmat + off_w(NL), &sm, par);
      par ^= 1;
    }
    if (l < NL) stash_act(a_out, H, st.h[l - 1]);
  }
  bf16* const h8 = sm.act[1];
  bf16* const act = sm.act[0];
#pragma unroll
  for (int mt = 0; mt < MT_F; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = part[mt][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (c == 0) sm.sig[warp * TC_P + mt * 16 + g + 8 * hh] = v;
    }
  __syncthreads();
  if (tid < TC_P) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sm.sig[w * TC_P + tid];
    if constexpr (STASH)
      st.cols[C_SIGP * cz + l0 + tid] = s + __ldg(vec + OFF_BS);
    else
      sm.col[SC_SIGMA * TC_P + tid] = fmaxf(s + __ldg(vec + OFF_BS), 0.f) * sp.sigma_mul;
  }
  if constexpr (STASH) tile_out(h8, LDS, H, st.h[NL - 1], l0);
  // ---- feature remap: no activation (tile 1 -> tile 0) ----
  for (int nb = 0; nb < H; nb += NB) {
    float acc[MT_F][4][4];
    zero_acc(acc);
    gemm_fwd<H, NB>(acc, h8, LDS, wmat + OFF_WRE + nb, sm.wst, H);
    store_act<4>(acc, vec + OFF_BRE, false, act, nb);
  }
  stash_act(act, H, st.feat);
  // ---- rgb head: sine layer on [feat, denc] (-> tile 1), then the output ----
  bf16* const y = sm.act[1];
  for (int nb = 0; nb < HR; nb += 128) {
    float acc2[MT_F][2][4];
    zero_acc(acc2);
    gemm_fwd<H, 128>(acc2, act, LDS, wmat + OFF_WR0F + nb, sm.wst, HR);
    gemm_fwd<DP, 128>(acc2, sm.denc, LDD, wmat + OFF_WR0D + nb, sm.wst, HR);
    sine_tc<2, MT_F, STASH, false, false>(acc2, nb + warp * 16, vec + OFF_BR0, sp.w0h, y,
                                          st.cr0, HR, nullptr, l0, nullptr, part);
  }
  __syncthreads();
  if constexpr (STASH) tile_out(y, LDS, HR, st.y, l0);
  if (tid < 3 * TC_P) {
    const int ch = tid / TC_P, p = tid % TC_P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(__bfloat162float(y[p * LDS + k]), __bfloat162float(wmat[OFF_WR1 + k * 8 + ch]),
               z);
    z = (z + __ldg(vec + OFF_BR1 + ch)) * sp.rgb_mul;
    const float r = 1.f / (1.f + expf(-z));
    if constexpr (STASH)
      st.cols[(C_RGB + ch) * cz + l0 + p] = r;
    else
      sm.col[(SC_RGB + ch) * TC_P + p] = r;
  }
  __syncthreads();
}

// The forward of ray samples [chunk0, chunk0 + nvalid): forward_chain_siren_tc
// with the ray loader (the forward render's also fills the t and delta
// columns).
template <bool STASH>
__device__ void forward_chunk_siren_tc(const RayInputs& in, const Siren& sp,
                                       const bf16* __restrict__ wmat, int chunk0, int nvalid,
                                       const TcSmem& sm, const TcStash& st, size_t l0, int cap) {
  forward_chain_siren_tc<STASH>([&] { load_chunk_tc<!STASH>(in, chunk0, nvalid, sm); }, in.vec,
                                sp, wmat, sm, st, l0, cap);
}

// ---------------------------------------------------------------- backward
// The bf16 MLP backward over a CTA's stashed points, shared by the train
// pass (fused_render_siren_train_tc.cu, after its compositing backward)
// and the field backward (fused_siren_bwd_tc.cu, from a given cotangent,
// with the input products as hooks): each dz W^T on the tensor cores chunk
// by chunk (dact_tc), each A^T dz once over the CTA's points (dweight_tc).

// Shared memory (bytes) of a backward CTA: two activation tiles (a dz
// chunk of every column, [TC_PB][LDS]; a block's staged output,
// [TC_PB][LDN]), the cosine tile (a block's, float32 [TC_PB][LDM]), the
// weight stages of a dz W^T product, a chunk's per-point cotangent columns,
// a reduction buffer. The weight gradients' stages overlay the activation
// and cosine tiles (which the plan makes at least as large at hidden 256);
// the per-ray losses of the compositing pass the second activation tile.
constexpr int LDM = NB + 8;                    // row stride (floats) of the cosines
constexpr int BB_ACT0 = 0;
constexpr int BB_ACT1 = BB_ACT0 + TC_PB * LDS * 2;
constexpr int BB_COS = BB_ACT1 + TC_PB * LDN * 2;
constexpr int BB_TILES = BB_COS + TC_PB * LDM * 4;
constexpr int BB_WST = BB_TILES > DW_STAGE_BYTES ? BB_TILES : DW_STAGE_BYTES;
constexpr int BB_COL = BB_WST + WST_DACT_BYTES;
constexpr int BB_RED = BB_COL + 4 * TC_PB * 4;
constexpr int SMEM_BWD = BB_RED + 4 * THREADS * 4;
static_assert(SMEM_BWD <= 232448, "exceeds the per-block shared memory");
static_assert(TC_PB * LDN * 2 >= TC_PB * LDG * 4, "direction cotangents fit a tile");

// A backward CTA's stash (TcStash), `cap` rows of each block: 15,744 bytes a
// point at hidden 256 (siren_plan.py's tc_bytes_per_point), the per-point
// columns (N_COLS floats) last. At hidden 1024 it is 62,592 bytes: 16.4 GB
// at 1024 rays x 256 samples, which an 80 GB card holds.
constexpr int TC_BYTES_PER_POINT = 2 * (11 * H + HR + DP) + 4 * (9 * H + HR + N_COLS);
static_assert(TC_BYTES_PER_POINT % 16 == 0, "stash rows must stay 16-byte aligned");

__device__ inline TcStash carve_stash(unsigned char* p, int cap) {
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
  for (int i = 0; i < NL; ++i) s.h[i] = take_b(H);
  s.feat = take_b(H);
  s.dz[0] = take_b(H);
  s.dz[1] = take_b(H);
  s.y = take_b(HR);
  s.denc = take_b(DP);
  s.h8f = take_f(H);
  for (int i = 0; i < NL; ++i) s.c[i] = take_f(H);
  s.cr0 = take_f(HR);
  s.cols = take_f(N_COLS);
  return s;
}

struct BwdSmem {
  bf16* act0;
  bf16* act1;
  float* cos;
  bf16* wst;
  float* col;
  float* red;
};

// dz_out = EPI(dz_in W^T) over the CTA's points l < cap_c, block by block
// of NB columns and chunk by chunk of TC_PB points: dz_in (KP columns) and
// dz_out (H) bf16 with stride LDZ, W (H x KP) the packed matrix. COS:
// EPI(x) = ((x (+ dsig ws)) w0) cos, the cosine from cref (float32, H
// columns), the block's staged into shared memory with the chunk's dz (and
// dsig) and its first weight tiles; else EPI(x) = x. The unrounded values
// are summed by column into colsum (H), in a fixed order; dz_out gets them
// rounded. Ends past a barrier.
template <int KP, bool COS, bool DSIG>
__device__ void dact_tc(const bf16* __restrict__ dz_in, const bf16* __restrict__ w,
                        const float* __restrict__ cref, float w0, const float* __restrict__ dsig,
                        const float* __restrict__ wsig, bf16* __restrict__ dz_out,
                        float* __restrict__ colsum, int cap_c, const BwdSmem& sm) {
  static_assert(COS || !DSIG, "dsig ws joins the sine layer's epilogue");
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = (tid >> 5) * 32;
  for (int nb = 0; nb < H; nb += NB) {
    float cs[4][2] = {};
    for (int l0 = 0; l0 < cap_c; l0 += TC_PB) {
      constexpr int CPR = KP / 8;
      for (int e = tid; e < TC_PB * CPR; e += THREADS) {
        const int r = e / CPR, q = (e % CPR) * 8;
        cp_async16(sm.act0 + r * LDS + q, dz_in + static_cast<size_t>(l0 + r) * LDZ + q);
      }
      if constexpr (COS) {
        for (int e = tid; e < TC_PB * (NB / 4); e += THREADS) {
          const int r = e / (NB / 4), q = (e % (NB / 4)) * 4;
          cp_async16(sm.cos + r * LDM + q, cref + static_cast<size_t>(l0 + r) * H + nb + q);
        }
      }
      if constexpr (DSIG) {
        if (tid < TC_PB / 4) cp_async16(sm.col + tid * 4, dsig + l0 + tid * 4);
      }
      cp_async_commit();
      float acc[MT_B][4][4];
      zero_acc(acc);
      gemm_dact<KP>(acc, sm.act0, w + static_cast<size_t>(nb) * KP, sm.wst);
      each_pair<4>(acc, n0, [&](int, int j, int, int row, int col, float& v0, float& v1) {
        float x0 = v0, x1 = v1;
        if constexpr (DSIG) {
          const float ds = sm.col[row];
          x0 = __fadd_rn(x0, __fmul_rn(ds, __ldg(wsig + nb + col)));
          x1 = __fadd_rn(x1, __fmul_rn(ds, __ldg(wsig + nb + col + 1)));
        }
        if constexpr (COS) {
          const float2 m = *reinterpret_cast<const float2*>(sm.cos + row * LDM + col);
          x0 = __fmul_rn(__fmul_rn(x0, w0), m.x);
          x1 = __fmul_rn(__fmul_rn(x1, w0), m.y);
        }
        cs[j][0] += x0;
        cs[j][1] += x1;
        put2(sm.act1 + row * LDN + col, x0, x1);
      });
      __syncthreads();
      tile_out(sm.act1, LDN, NB, dz_out + nb, static_cast<size_t>(l0), LDZ, TC_PB);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = cs[j][u];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < 4) colsum[nb + n0 + j * 8 + 2 * lane + u] = v;
      }
    __syncthreads();
  }
}

// The train pass's hooks: no input products.
struct NoBwdHooks {
  __device__ void on_dzr0(const bf16*) const {}
  __device__ void on_dz1(const bf16*) const {}
};

// The MLP backward (fused_siren.py::_mlp_bwd_core) over the CTA's points l
// < cap_c from the stash and the cotangent columns dzr1 and dsig, into the
// CTA's partial (offsets of the packed layout, the vectors from N_W). The
// input products are the hooks': hk.on_dzr0(dzr0) once dzr0 is complete
// (st.dz[0], HR columns at stride LDZ) and hk.on_dz1(dz1) at the end (H
// columns); each starts past a barrier. on_dzr0 may use sm.act0, sm.act1
// and sm.wst and must end past a barrier. The train pass takes
// NoBwdHooks.
template <typename Hooks>
__device__ void backward(const TcStash& st, int cap, const Siren& sp,
                         const float* __restrict__ vec, const bf16* __restrict__ wmat,
                         float* __restrict__ part, int cap_c, const BwdSmem& sm,
                         const Hooks& hk) {
  const int tid = threadIdx.x;
  const size_t cz = static_cast<size_t>(cap);
  const float* dsig = st.cols + C_DSIG * cz;
  const float* dzr1 = st.cols + C_DZR1 * cz;
  float* pvec = part + N_W;
  // rgb output layer (CUDA cores), chunk by chunk, in blocks of 128 of the
  // HR columns: dzr0 = ((r(dzr1) wr1^T) w0h) cr0 to dz[0] (HR columns), with
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
    const float* __restrict__ cr0 = st.cr0;
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
        const float v = __fmul_rn(__fmul_rn(dy, sp.w0h), cr0[l * HR + k]);
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
      for (int c = 0; c < 3; ++c) o[c] = red[(1 + c) * THREADS + tid] + red[(1 + c) * THREADS + tid + HB];
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
  hk.on_dzr0(st.dz[0]);
  // the density row: ws = h8^T dsig, a column loop on the unrounded h8
  for (int n = tid; n < H; n += THREADS) {
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < cap_c; ++l) s = fmaf(st.h8f[static_cast<size_t>(l) * H + n], dsig[l], s);
    pvec[OFF_WS + n] = s;
  }
  // rgb sine layer: wr0f, wr0d; dfeat = dzr0 wr0f^T (bre)
  dweight_tc<NB, NB / 2, 4, 2>(st.feat, H, H, st.dz[0], cap_c, part + OFF_WR0F, sm.act0, HR);
  dweight_tc<32, NB / 2, 1, 8>(st.denc, DP, DP, st.dz[0], cap_c, part + OFF_WR0D, sm.act0, HR);
  dact_tc<HR, false, false>(st.dz[0], wmat + OFF_WR0F, nullptr, 1.f, nullptr, nullptr, st.dz[1],
                            pvec + OFF_BRE, cap_c, sm);
  // feature remap: wre from r(h8); dz8 = ((dfeat wre^T + dsig ws) w0h) c8 (b8)
  dweight_tc<128, NB, 2, 4>(st.h[NL - 1], H, H, st.dz[1], cap_c, part + OFF_WRE, sm.act0, H);
  dact_tc<H, true, true>(st.dz[1], wmat + OFF_WRE, st.c[NL - 1], sp.w0h, dsig, vec + OFF_WS,
                         st.dz[0], pvec + (NL - 1) * H, cap_c, sm);
  // sine layers 8..2: w_l from h_{l-1}; dz_{l-1} = ((dz_l w_l^T) w0_{l-1}) c_{l-1}
  bf16* cur = st.dz[0];
  bf16* nxt = st.dz[1];
  for (int l = NL; l >= 2; --l) {
    dweight_tc<128, NB, 2, 4>(st.h[l - 2], H, H, cur, cap_c, part + off_w(l), sm.act0, H);
    dact_tc<H, true, false>(cur, wmat + off_w(l), st.c[l - 2], l == 2 ? sp.w0 : sp.w0h, nullptr,
                            nullptr, nxt, pvec + (l - 2) * H, cap_c, sm);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  // first layer: dW1 = r(pos)^T r(dz1) (rows 3..7 zero), a column loop
  const float* pos = st.cols + C_POS * cz;
  for (int n = tid; n < H; n += THREADS) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int l = 0; l < cap_c; ++l) {
      const float d = __bfloat162float(cur[static_cast<size_t>(l) * LDZ + n]);
      s0 = fmaf(pos[l], d, s0);
      s1 = fmaf(pos[cz + l], d, s1);
      s2 = fmaf(pos[2 * cz + l], d, s2);
    }
    part[OFF_W1 + 0 * H + n] = s0;
    part[OFF_W1 + 1 * H + n] = s1;
    part[OFF_W1 + 2 * H + n] = s2;
    for (int k = 3; k < 8; ++k) part[OFF_W1 + k * H + n] = 0.f;
  }
  hk.on_dz1(cur);
}

}  // namespace siren
