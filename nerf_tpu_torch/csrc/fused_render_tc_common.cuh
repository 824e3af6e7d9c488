// The NeRF family's forward chain on Hopper's tensor cores (sm_90a), over
// one 64-point chunk, shared by the bfloat16 train pass
// (fused_render_train_tc.cu, which stashes every activation for its
// backward), the bfloat16 forward render (fused_render_fwd_tc.cu, which
// keeps each point's density and colour in shared memory and composites
// them straight away) and the bfloat16 field forward (fused_nerf_fwd_tc.cu,
// which writes them out in point order). The chunk's input stage is a
// loader policy: ray samples (encode_chunk) or given points and directions
// (encode_point_chunk_tc). The train pass's MLP backward closes the file,
// shared with the bfloat16 field backward (fused_nerf_bwd_tc.cu).
//
// The chain is nerf_tpu/ops/pallas/fused_nerf.py::_mlp_tile in bfloat16:
// the encodings rounded to bf16, the 11 products (mma.sync m16n8k16 on
// render_tc.cuh's gemm_fwd: bf16 operands, float32 sums) with the skip
// input, every activation rounded to bf16 as the next product's operand,
// h9 kept unrounded for the density (its float32 reduction against w10s)
// and rounded for the feature product, the rgb head's last 128 x 3 layer
// and the sigmoid on the CUDA cores.
//
// Widths: hidden 256 (one block of 256 columns: one activation tile, two
// CTAs an SM) and, built with their plan's -D flags
// (ops/cuda/nerf_plan.py), hidden 512, 768 and 1024 with encodings padded to
// 128 / 64 columns. There every product runs in blocks of 256 output
// columns (the rgb head's of 128) over the whole input, from one activation
// tile into a second; forward chunks of 64 points up to 512 and 32 wider,
// the backward's dz W^T in chunks of 32 points with the block's mask; one
// CTA an SM. A block changes which warp computes an output, never the order
// of its sum over k, so hidden 256 computes what it did with one block.

#pragma once

#include "render_tc.cuh"

namespace nerf {

// Shared memory (bytes) of a forward CTA: the activation tiles, the two
// encodings, the weight stages, the density partials (FB_END); the forward
// render adds its per-point columns after them. At hidden 256 (one block of
// columns) a single activation tile: each layer's output overwrites its
// input once the product has read it, and two CTAs share an SM. Wider, a
// layer's blocks read one tile and write the other (FB_ACT2), and the plan
// (ops/cuda/nerf_plan.py) says how many CTAs share an SM.
constexpr bool ONE_TILE = H == NB;
constexpr int FB_ACT = 0;
constexpr int FB_ACT2 = FB_ACT + (ONE_TILE ? 0 : TC_P * LDS * 2);
constexpr int FB_PENC = FB_ACT2 + TC_P * LDS * 2;
constexpr int FB_DENC = FB_PENC + TC_P * LDP * 2;
constexpr int FB_WST = FB_DENC + TC_P * LDD * 2;
constexpr int FB_SIG = FB_WST + WST_FWD_BYTES;
constexpr int FB_END = FB_SIG + WARPS * TC_P * 4;

// The forward render's per-point columns of a chunk (floats, TC_P each):
// t, delta, sigma (after the ReLU), rgb (3).
constexpr int COL_T = 0, COL_DELTA = 1, COL_SIGMA = 2, COL_RGB = 3, N_FWD_COLS = 6;

// One train CTA's device-memory stash, point-major with the CTA-local point
// as the row: h1..h8, r(h9), feat and the two dz buffers (bf16, H
// columns), y (HR), penc (PP), denc (DP), then h9 (float32, H) and the
// per-point columns (float32, N_COLS x cap; render_common.cuh C_*).
struct TcStash {
  bf16* h[8];
  bf16* h9b;
  bf16* feat;
  bf16* dz[2];
  bf16* y;
  bf16* penc;
  bf16* denc;
  float* h9f;
  float* cols;
};

struct FwdSmem {
  bf16* act;
  bf16* act2;     // the second activation tile (the first at hidden 256)
  bf16* penc;
  bf16* denc;
  bf16* wst;
  float* sig;
  float* col;     // the forward render's columns (COL_*), else unused
};

// The encodings of ray samples [chunk0, chunk0 + nvalid) into shared memory,
// point-major, rounded to bf16, zero past nvalid (as fused_render_common.cuh
// ::encode_ray_chunk<true>); with COLS also their t and delta columns
// (delta with the 1e10 tail, zero past nvalid). Ends past a barrier.
template <bool COLS>
__device__ void encode_chunk(const RayInputs& in, int chunk0, int nvalid, const FwdSmem& sm) {
  const int tid = threadIdx.x, S = in.S;
  for (int idx = tid; idx < TC_P * PP; idx += THREADS) {
    const int p = idx / PP, c = idx % PP;
    float v = 0.f;
    if (p < nvalid && c < in.real_p) {
      const int g = chunk0 + p;
      const int ray = g / S;
      const int d = c < 3 ? c : (c - 3) % 3;
      const float x = __fadd_rn(in.o_aff[ray * 3 + d], __fmul_rn(in.t[g], in.d_aff[ray * 3 + d]));
      v = encode_col<true>(x, c);
    }
    sm.penc[p * LDP + c] = __float2bfloat16_rn(v);
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
      sm.col[COL_T * TC_P + tid] = tv;
      sm.col[COL_DELTA * TC_P + tid] = dv;
    }
  }
  __syncthreads();
}

// The encodings of field points [p0, p0 + nvalid), given with their
// directions, into shared memory, point-major, rounded to bf16, zero past
// nvalid, as fused_render_common.cuh::encode_point_chunk<true>: both
// through the degree-11 sine, as the TPU field kernel's _forward_tile (the
// ray loader encodes the view direction with the exact sine). Ends past a
// barrier.
__device__ void encode_point_chunk_tc(const float* __restrict__ pts,
                                      const float* __restrict__ dirs, int p0, int nvalid,
                                      int real_p, int real_d, const FwdSmem& sm) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < TC_P * PP; idx += THREADS) {
    const int p = idx / PP, c = idx % PP;
    float v = 0.f;
    if (p < nvalid && c < real_p) {
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<true>(pts[static_cast<size_t>(p0 + p) * 3 + d], c);
    }
    sm.penc[p * LDP + c] = __float2bfloat16_rn(v);
  }
  for (int idx = tid; idx < TC_P * DP; idx += THREADS) {
    const int p = idx / DP, c = idx % DP;
    float v = 0.f;
    if (p < nvalid && c < real_d) {
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<true>(dirs[static_cast<size_t>(p0 + p) * 3 + d], c);
    }
    sm.denc[p * LDD + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
}

// The forward plan's tiles in the dynamic shared memory `sb`; `col` the
// per-point columns (COL_*) at byte col_at, or none (col_at < 0).
__device__ __forceinline__ FwdSmem fwd_smem(unsigned char* sb, int col_at) {
  return FwdSmem{reinterpret_cast<bf16*>(sb + FB_ACT), reinterpret_cast<bf16*>(sb + FB_ACT2),
                 reinterpret_cast<bf16*>(sb + FB_PENC), reinterpret_cast<bf16*>(sb + FB_DENC),
                 reinterpret_cast<bf16*>(sb + FB_WST), reinterpret_cast<float*>(sb + FB_SIG),
                 col_at < 0 ? nullptr : reinterpret_cast<float*>(sb + col_at)};
}

// One hidden layer of the chunk in blocks of NB columns: out = act(in W (+
// penc W6p, the skip input) + bias) rounded to bf16, W (K x H) from its
// first column. `out` may be `in` when one block covers the layer.
template <int K, bool SKIP>
__device__ __forceinline__ void layer_tc(const bf16* in, int lda, const bf16* __restrict__ w,
                                         const bf16* __restrict__ w6p,
                                         const float* __restrict__ bias, bool relu,
                                         const FwdSmem& sm, bf16* out) {
  for (int nb = 0; nb < H; nb += NB) {
    float acc[MT_F][4][4];
    zero_acc(acc);
    gemm_fwd<K, NB>(acc, in, lda, w + nb, sm.wst, H);
    if constexpr (SKIP) gemm_fwd<PP, NB>(acc, sm.penc, LDP, w6p + nb, sm.wst, H);
    store_act<4>(acc, bias, relu, out, nb);
  }
}

// The forward of one chunk whose inputs `load()` puts in shared memory (the
// encodings, and the ray loader's t and delta columns; it ends past a
// barrier). STASH (the train pass): every activation to the stash `st` at
// rows l0.., sigma_pre and rgb to its per-point columns (`cap` long). Else
// (the forward render and the field forward): sigma (after the ReLU) and
// rgb to the shared-memory columns sm.col (COL_*), nothing to device
// memory. Each product runs in blocks of NB output columns (the rgb head's
// in blocks of 128), from one activation tile into the other (the same
// tile at hidden 256). Ends past a barrier.
template <bool STASH, typename Load>
__device__ void forward_chain_tc(Load load, const float* __restrict__ vec,
                                 const bf16* __restrict__ wmat, const FwdSmem& sm,
                                 const TcStash& st, size_t l0, int cap) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load();
  if constexpr (STASH) {
    tile_out(sm.penc, LDP, PP, st.penc, l0);
    tile_out(sm.denc, LDD, DP, st.denc, l0);
  }
  bf16* cur = sm.act;      // the layer's input tile
  bf16* nxt = sm.act2;     // its output tile
  // the train pass's copy of the output tile to the stash, then the swap
  auto done = [&](int ncols, bf16* dst) {
    if constexpr (STASH) {
      __syncthreads();
      tile_out(nxt, LDS, ncols, dst, l0);
    }
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  };
  const bf16* none = nullptr;
  // ---- block1 ----
  layer_tc<PP, false>(sm.penc, LDP, wmat + OFF_W1, none, vec + 0 * H, true, sm, nxt);
  done(H, st.h[0]);
  layer_tc<H, false>(cur, LDS, wmat + OFF_W2, none, vec + 1 * H, true, sm, nxt);
  done(H, st.h[1]);
  layer_tc<H, false>(cur, LDS, wmat + OFF_W3, none, vec + 2 * H, true, sm, nxt);
  done(H, st.h[2]);
  layer_tc<H, false>(cur, LDS, wmat + OFF_W4, none, vec + 3 * H, true, sm, nxt);
  done(H, st.h[3]);
  layer_tc<H, false>(cur, LDS, wmat + OFF_W5, none, vec + 4 * H, true, sm, nxt);
  done(H, st.h[4]);
  // ---- block2: the skip input, then 3 more layers ----
  layer_tc<H, true>(cur, LDS, wmat + OFF_W6H, wmat + OFF_W6P, vec + 5 * H, true, sm, nxt);
  done(H, st.h[5]);
  layer_tc<H, false>(cur, LDS, wmat + OFF_W7, none, vec + 6 * H, true, sm, nxt);
  done(H, st.h[6]);
  layer_tc<H, false>(cur, LDS, wmat + OFF_W8, none, vec + 7 * H, true, sm, nxt);
  done(H, st.h[7]);
  // h9 = relu(acc + b9), rounded to the next product (and float32 to the
  // stash); sigma_pre the float32 reduction of the UNROUNDED h9 against
  // w10s: each thread over its columns of every block, the 4 lanes of a row
  // by shuffle, the 8 warps in order through shared memory.
  {
    float sp[MT_F][2] = {};
    for (int nb = 0; nb < H; nb += NB) {
      float acc[MT_F][4][4];
      zero_acc(acc);
      gemm_fwd<H, NB>(acc, cur, LDS, wmat + OFF_W9 + nb, sm.wst, H);
      each_pair<4>(acc, nb + warp * 32,
                   [&](int mt, int, int h, int row, int col, float& v0, float& v1) {
                     const float x0 = fmaxf(v0 + __ldg(vec + 8 * H + col), 0.f);
                     const float x1 = fmaxf(v1 + __ldg(vec + 8 * H + col + 1), 0.f);
                     sp[mt][h] = fmaf(x0, __ldg(vec + OFF_W10S + col), sp[mt][h]);
                     sp[mt][h] = fmaf(x1, __ldg(vec + OFF_W10S + col + 1), sp[mt][h]);
                     if constexpr (STASH)
                       *reinterpret_cast<float2*>(st.h9f + (l0 + row) * H + col) =
                           make_float2(x0, x1);
                     put2(nxt + row * LDS + col, x0, x1);
                   });
    }
#pragma unroll
    for (int mt = 0; mt < MT_F; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = sp[mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) sm.sig[warp * TC_P + mt * 16 + (lane >> 2) + 8 * h] = v;
      }
  }
  __syncthreads();
  if (tid < TC_P) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sm.sig[w * TC_P + tid];
    if constexpr (STASH)
      st.cols[C_SIGP * static_cast<size_t>(cap) + l0 + tid] = s + __ldg(vec + OFF_B10S);
    else
      sm.col[COL_SIGMA * TC_P + tid] = fmaxf(s + __ldg(vec + OFF_B10S), 0.f);
  }
  if constexpr (STASH) tile_out(nxt, LDS, H, st.h9b, l0);
  {
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  // feature head: no activation
  layer_tc<H, false>(cur, LDS, wmat + OFF_W10F, none, vec + OFF_B10F, false, sm, nxt);
  done(H, st.feat);
  // ---- rgb head ----
  for (int nb = 0; nb < HR; nb += 128) {
    float acc2[MT_F][2][4];
    zero_acc(acc2);
    gemm_fwd<H, 128>(acc2, cur, LDS, wmat + OFF_WR0F + nb, sm.wst, HR);
    gemm_fwd<DP, 128>(acc2, sm.denc, LDD, wmat + OFF_WR0D + nb, sm.wst, HR);
    store_act<2>(acc2, vec + OFF_BR0, true, nxt, nb);
  }
  __syncthreads();
  if constexpr (STASH) tile_out(nxt, LDS, HR, st.y, l0);
  if (tid < 3 * TC_P) {
    const int c = tid / TC_P, p = tid % TC_P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(__bfloat162float(nxt[p * LDS + k]), __bfloat162float(wmat[OFF_WR1 + k * 8 + c]),
               z);
    z += __ldg(vec + OFF_BR1 + c);
    const float r = 1.f / (1.f + expf(-z));
    if constexpr (STASH)
      st.cols[(C_RGB + c) * static_cast<size_t>(cap) + l0 + p] = r;
    else
      sm.col[(COL_RGB + c) * TC_P + p] = r;
  }
  __syncthreads();
}

// The forward of ray samples [chunk0, chunk0 + nvalid): forward_chain_tc
// with the ray loader (the forward render's also fills the t and delta
// columns).
template <bool STASH>
__device__ void forward_chunk_tc(const RayInputs& in, const bf16* __restrict__ wmat, int chunk0,
                                 int nvalid, const FwdSmem& sm, const TcStash& st, size_t l0,
                                 int cap) {
  forward_chain_tc<STASH>([&] { encode_chunk<!STASH>(in, chunk0, nvalid, sm); }, in.vec, wmat,
                          sm, st, l0, cap);
}

// ---------------------------------------------------------------- backward
// The MLP backward of the bfloat16 train pass (fused_render_train_tc.cu),
// shared with the bfloat16 field backward (fused_nerf_bwd_tc.cu), which
// adds the three input products through the hooks. Each dz W^T is a
// tensor-core product chunk by chunk against the packed W itself (no
// transposed copy), with the chunk's dz and ReLU mask staged into shared
// memory; its epilogue adds dsig w10s where due, applies the mask, sums the
// unrounded dz by column (the bias gradient; with h9 dsig, the w10s
// gradient) and stores dz rounded to bf16. Each weight gradient A^T dz is
// one tensor-core product over all the CTA's points (dweight_tc), written
// once per CTA.

// Shared memory (bytes) of the backward kernel: two activation tiles (a dz
// chunk of every column, [TC_PB][LDS]; a block's staged output,
// [TC_PB][LDN]), a mask tile (a block's ReLU masks, float32 [TC_PB][LDM]
// or bf16 [TC_PB][LDN]), the weight stages of a dz W^T product, a chunk's
// per-point cotangent columns, a reduction buffer. The weight gradients'
// stages overlay the activation and mask tiles (which the plan makes at
// least as large); the per-ray losses of the train pass's compositing the
// second activation tile.
constexpr int LDM = NB + 8;                    // row stride (floats) of the mask
constexpr int BB_ACT0 = 0;
constexpr int BB_ACT1 = BB_ACT0 + TC_PB * LDS * 2;
constexpr int BB_MASK = BB_ACT1 + TC_PB * LDN * 2;
constexpr int BB_TILES = BB_MASK + TC_PB * LDM * 4;
constexpr int BB_WST = BB_TILES > DW_STAGE_BYTES ? BB_TILES : DW_STAGE_BYTES;
constexpr int BB_COL = BB_WST + WST_DACT_BYTES;
constexpr int BB_RED = BB_COL + 4 * TC_PB * 4;
constexpr int SMEM_BWD = BB_RED + 4 * THREADS * 4;
static_assert(SMEM_BWD <= 232448, "exceeds the per-block shared memory");
static_assert(TC_PB * LDN * 2 >= TC_PB * (PP + 4) * 4, "encoding cotangents fit a tile");

// Bytes a point of the stash (TcStash), `cap` rows each.
constexpr int TC_BYTES_PER_POINT = 2 * (12 * H + HR + PP + DP) + 4 * (H + N_COLS);
static_assert(TC_BYTES_PER_POINT % 16 == 0, "stash rows must stay 16-byte aligned");

__device__ inline TcStash carve_tc_stash(unsigned char* p, int cap) {
  TcStash s;
  const size_t c = static_cast<size_t>(cap);
  auto take = [&](int cols) {
    bf16* r = reinterpret_cast<bf16*>(p);
    p += c * cols * 2;
    return r;
  };
  for (int i = 0; i < 8; ++i) s.h[i] = take(H);
  s.h9b = take(H);
  s.feat = take(H);
  s.dz[0] = take(H);
  s.dz[1] = take(H);
  s.y = take(HR);
  s.penc = take(PP);
  s.denc = take(DP);
  s.h9f = reinterpret_cast<float*>(p);
  p += c * H * 4;
  s.cols = reinterpret_cast<float*>(p);
  return s;
}

struct BwdSmem {
  bf16* act0;
  bf16* act1;
  void* mask;
  bf16* wst;
  float* col;
  float* red;
};

enum class Mask { None, Bf16, F32 };

// dz_out = EPI(dz_in W^T (+ dsig w10s)) over the CTA's points l < cap_c,
// block by block of NB columns and chunk by chunk of TC_PB points: dz_in (KP
// columns) and dz_out (H) bf16 with stride LDZ, W (H x KP) the packed
// matrix; EPI the ReLU mask of mref > 0 (bf16 or float32, H columns). Each
// chunk's dz, the block's mask and dsig are staged into shared memory with
// its first weight tiles. The unrounded values are summed by column into
// colsum (H), in a fixed order; dz_out gets them rounded. DSIG (the feature
// head, whose mask is h9 in float32) also sums h9 dsig by column into
// w10s_out (the w10s gradient). Ends past a barrier.
template <int KP, Mask MK, bool DSIG>
__device__ void dact_tc(const bf16* __restrict__ dz_in, const bf16* __restrict__ w,
                        const void* mref, const float* __restrict__ dsig,
                        const float* __restrict__ wsig, bf16* __restrict__ dz_out,
                        float* __restrict__ colsum, float* __restrict__ w10s_out, int cap_c,
                        const BwdSmem& sm) {
  static_assert(!DSIG || MK == Mask::F32, "the w10s sums read h9 in float32");
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = (tid >> 5) * 32;
  const bf16* mask_b = static_cast<const bf16*>(sm.mask);
  const float* mask_f = static_cast<const float*>(sm.mask);
  for (int nb = 0; nb < H; nb += NB) {
    float cs[4][2] = {}, ws[4][2] = {};
    for (int l0 = 0; l0 < cap_c; l0 += TC_PB) {
      constexpr int CPR = KP / 8;
      for (int e = tid; e < TC_PB * CPR; e += THREADS) {
        const int r = e / CPR, q = (e % CPR) * 8;
        cp_async16(sm.act0 + r * LDS + q, dz_in + static_cast<size_t>(l0 + r) * LDZ + q);
      }
      if constexpr (MK == Mask::Bf16) {
        const bf16* m = static_cast<const bf16*>(mref);
        for (int e = tid; e < TC_PB * (NB / 8); e += THREADS) {
          const int r = e / (NB / 8), q = (e % (NB / 8)) * 8;
          cp_async16(static_cast<bf16*>(sm.mask) + r * LDN + q,
                     m + static_cast<size_t>(l0 + r) * H + nb + q);
        }
      } else if constexpr (MK == Mask::F32) {
        const float* m = static_cast<const float*>(mref);
        for (int e = tid; e < TC_PB * (NB / 4); e += THREADS) {
          const int r = e / (NB / 4), q = (e % (NB / 4)) * 4;
          cp_async16(static_cast<float*>(sm.mask) + r * LDM + q,
                     m + static_cast<size_t>(l0 + r) * H + nb + q);
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
          x0 = x0 + ds * __ldg(wsig + nb + col);
          x1 = x1 + ds * __ldg(wsig + nb + col + 1);
        }
        if constexpr (MK == Mask::Bf16) {
          const __nv_bfloat162 m =
              *reinterpret_cast<const __nv_bfloat162*>(mask_b + row * LDN + col);
          x0 = __low2float(m) > 0.f ? x0 : 0.f;
          x1 = __high2float(m) > 0.f ? x1 : 0.f;
        } else if constexpr (MK == Mask::F32) {
          const float2 m = *reinterpret_cast<const float2*>(mask_f + row * LDM + col);
          x0 = m.x > 0.f ? x0 : 0.f;
          x1 = m.y > 0.f ? x1 : 0.f;
          if constexpr (DSIG) {
            const float ds = sm.col[row];
            ws[j][0] = fmaf(m.x, ds, ws[j][0]);
            ws[j][1] = fmaf(m.y, ds, ws[j][1]);
          }
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
        float v = cs[j][u], x = ws[j][u];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
          x += __shfl_xor_sync(0xffffffffu, x, off);
        }
        if (lane < 4) {
          colsum[nb + n0 + j * 8 + 2 * lane + u] = v;
          if constexpr (DSIG) w10s_out[nb + n0 + j * 8 + 2 * lane + u] = x;
        }
      }
    __syncthreads();
  }
}

// The packed offset of hidden layer i's matrix (i = 2..9).
__device__ __forceinline__ int hidden_off(int i) {
  switch (i) {
    case 2: return OFF_W2;
    case 3: return OFF_W3;
    case 4: return OFF_W4;
    case 5: return OFF_W5;
    case 6: return OFF_W6H;
    case 7: return OFF_W7;
    case 8: return OFF_W8;
    default: return OFF_W9;
  }
}

// The train pass's backward takes no input product.
struct NoBwdHooks {
  __device__ void on_dzr0(const bf16*) const {}
  __device__ void on_dz6(const bf16*) const {}
  __device__ void on_dz1(const bf16*) const {}
};

// The MLP backward (fused_nerf.py::_mlp_bwd_core) over the CTA's points l <
// cap_c from the stash and the cotangent columns dzr1 and dsig, into the
// CTA's partial (offsets of the packed layout, the vectors from N_W). The
// input products are the hooks': hk.on_dzr0(dzr0) once dzr0 is complete
// (st.dz[0], HR columns), hk.on_dz6(dz6) and hk.on_dz1(dz1) once those
// are (H columns); each may use the activation tiles and the weight
// stages, and ends past a barrier. The train pass takes NoBwdHooks.
template <typename Hooks>
__device__ void backward(const TcStash& st, int cap, const float* __restrict__ vec,
                         const bf16* __restrict__ wmat, float* __restrict__ part, int cap_c,
                         const BwdSmem& sm, const Hooks& hk) {
  const int tid = threadIdx.x;
  const size_t cz = static_cast<size_t>(cap);
  const float* dsig = st.cols + C_DSIG * cz;
  const float* dzr1 = st.cols + C_DZR1 * cz;
  float* pvec = part + N_W;
  // rgb output layer (CUDA cores), chunk by chunk, in blocks of 128 of the
  // HR columns: dzr0 = (r(dzr1) wr1^T) * (y > 0) to dz[0] (HR columns),
  // with its column sums (br0) and wr1 = r(y)^T r(dzr1) in two halves of
  // each chunk's points; br1 and b10s (the sums of dzr1 and dsig) by four
  // threads over the staged columns, in the first block
  for (int kb = 0; kb < HR; kb += THREADS / 2) {
    const int k = kb + (tid & (THREADS / 2 - 1)), half = tid / (THREADS / 2);
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
      float yv[TC_PB / 2];
#pragma unroll
      for (int j = 0; j < TC_PB / 2; ++j)
        yv[j] = __bfloat162float(y[static_cast<size_t>(l0 + half + 2 * j) * HR + k]);
#pragma unroll
      for (int j = 0; j < TC_PB / 2; ++j) {
        const int p = half + 2 * j;
        const float d0 = round_bf16(col_s[p]), d1 = round_bf16(col_s[TC_PB + p]),
                    d2 = round_bf16(col_s[2 * TC_PB + p]);
        float dy = fmaf(d0, w0, 0.f);
        dy = fmaf(d1, w1, dy);
        dy = fmaf(d2, w2, dy);
        const float v = yv[j] > 0.f ? dy : 0.f;
        dz0[static_cast<size_t>(l0 + p) * LDZ + k] = __float2bfloat16_rn(v);
        sb += v;
        s0 = fmaf(yv[j], d0, s0);
        s1 = fmaf(yv[j], d1, s1);
        s2 = fmaf(yv[j], d2, s2);
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
    constexpr int HB = THREADS / 2;
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
      if (tid == 3) pvec[OFF_B10S] = sx;
    }
  }
  hk.on_dzr0(st.dz[0]);
  // rgb hidden layer: wr0f, wr0d; dfeat = dzr0 wr0f^T (b10f)
  dweight_tc<NB, NB / 2, 4, 2>(st.feat, H, H, st.dz[0], cap_c, part + OFF_WR0F, sm.act0, HR);
  dweight_tc<32, NB / 2, 1, 8>(st.denc, DP, DP, st.dz[0], cap_c, part + OFF_WR0D, sm.act0, HR);
  dact_tc<HR, Mask::None, false>(st.dz[0], wmat + OFF_WR0F, nullptr, nullptr, nullptr, st.dz[1],
                                 pvec + OFF_B10F, nullptr, cap_c, sm);
  // feature head: w10f; dz9 = (dfeat w10f^T + dsig w10s) * (h9 > 0) (b9),
  // and w10s = h9^T dsig
  dweight_tc<128, NB, 2, 4>(st.h9b, H, H, st.dz[1], cap_c, part + OFF_W10F, sm.act0, H);
  dact_tc<H, Mask::F32, true>(st.dz[1], wmat + OFF_W10F, st.h9f, dsig, vec + OFF_W10S, st.dz[0],
                              pvec + 8 * H, pvec + OFF_W10S, cap_c, sm);
  // block2 and block1: w_i from h_{i-1}; dz_{i-1} = dz_i w_i^T * (h_{i-1} > 0)
  bf16* cur = st.dz[0];
  bf16* nxt = st.dz[1];
  for (int i = 9; i >= 2; --i) {
    const int off = hidden_off(i);
    dweight_tc<128, NB, 2, 4>(st.h[i - 2], H, H, cur, cap_c, part + off, sm.act0, H);
    if (i == 6) dweight_tc<64, NB, 1, 8>(st.penc, PP, PP, cur, cap_c, part + OFF_W6P, sm.act0, H);
    dact_tc<H, Mask::Bf16, false>(cur, wmat + off, st.h[i - 2], nullptr, nullptr, nxt,
                                  pvec + (i - 2) * H, nullptr, cap_c, sm);
    if (i == 6) hk.on_dz6(cur);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  dweight_tc<64, NB, 1, 8>(st.penc, PP, PP, cur, cap_c, part + OFF_W1, sm.act0, H);
  hk.on_dz1(cur);
}

}  // namespace nerf
