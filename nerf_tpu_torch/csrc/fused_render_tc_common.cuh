// The NeRF family's forward chain on Hopper's tensor cores (sm_90a), over
// one 64-point chunk, shared by the bfloat16 train pass
// (fused_render_train_tc.cu, which stashes every activation for its
// backward), the bfloat16 forward render (fused_render_fwd_tc.cu, which
// keeps each point's density and colour in shared memory and composites
// them straight away) and the bfloat16 field forward (fused_nerf_fwd_tc.cu,
// which writes them out in point order). The chunk's input stage is a
// loader policy: ray samples (encode_chunk) or given points and directions
// (encode_point_chunk_tc).
//
// The chain is nerf_tpu/ops/pallas/fused_nerf.py::_mlp_tile in bfloat16:
// the encodings rounded to bf16, the 11 products (mma.sync m16n8k16 on
// render_tc.cuh's gemm_fwd: bf16 operands, float32 sums) with the skip
// input, every activation rounded to bf16 as the next product's operand,
// h9 kept unrounded for the density (its float32 reduction against w10s)
// and rounded for the feature product, the rgb head's last 128 x 3 layer
// and the sigmoid on the CUDA cores.

#pragma once

#include "render_tc.cuh"

namespace nerf {

// Shared memory (bytes) of a forward CTA: one activation tile (each layer's
// output overwrites its input once the product has read it), the two
// encodings, the weight stages, the density partials (FB_END); the forward
// render adds its per-point columns after them. Two CTAs share an SM.
constexpr int FB_ACT = 0;
constexpr int FB_PENC = FB_ACT + TC_P * LDS * 2;
constexpr int FB_DENC = FB_PENC + TC_P * LDP * 2;
constexpr int FB_WST = FB_DENC + TC_P * LDD * 2;
constexpr int FB_SIG = FB_WST + WST_FWD_BYTES;
constexpr int FB_END = FB_SIG + WARPS * TC_P * 4;

// The forward render's per-point columns of a chunk (floats, TC_P each):
// t, delta, sigma (after the ReLU), rgb (3).
constexpr int COL_T = 0, COL_DELTA = 1, COL_SIGMA = 2, COL_RGB = 3, N_FWD_COLS = 6;

// One train CTA's device-memory stash, point-major with the CTA-local point
// as the row: h1..h8, r(h9), feat and the two dz buffers (bf16, 256
// columns), y (128), penc (64), denc (32), then h9 (float32, 256) and the
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

// The forward of one chunk whose inputs `load()` puts in shared memory (the
// encodings, and the ray loader's t and delta columns; it ends past a
// barrier). STASH (the train pass): every activation to the stash `st` at
// rows l0.., sigma_pre and rgb to its per-point columns (`cap` long). Else
// (the forward render and the field forward): sigma (after the ReLU) and
// rgb to the shared-memory columns sm.col (COL_*), nothing to device
// memory. Ends past a barrier.
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
  // the train pass's copy of the activation tile to the stash
  auto stash_act = [&](int ncols, bf16* dst) {
    if constexpr (STASH) {
      __syncthreads();
      tile_out(sm.act, LDS, ncols, dst, l0);
    }
  };
  float acc[4][4][4];
  // one hidden layer: relu(act W + b) rounded, into act (and the stash)
  auto layer = [&](int off_w, int bias, bf16* stash) {
    zero_acc(acc);
    gemm_fwd<H, H>(acc, sm.act, LDS, wmat + off_w, sm.wst);
    store_act<4>(acc, vec + bias, true, sm.act);
    stash_act(H, stash);
  };
  // ---- block1 ----
  zero_acc(acc);
  gemm_fwd<PP, H>(acc, sm.penc, LDP, wmat + OFF_W1, sm.wst);
  store_act<4>(acc, vec + 0 * H, true, sm.act);
  stash_act(H, st.h[0]);
  layer(OFF_W2, 1 * H, st.h[1]);
  layer(OFF_W3, 2 * H, st.h[2]);
  layer(OFF_W4, 3 * H, st.h[3]);
  layer(OFF_W5, 4 * H, st.h[4]);
  // ---- block2: the skip input, then 3 more layers ----
  zero_acc(acc);
  gemm_fwd<H, H>(acc, sm.act, LDS, wmat + OFF_W6H, sm.wst);
  gemm_fwd<PP, H>(acc, sm.penc, LDP, wmat + OFF_W6P, sm.wst);
  store_act<4>(acc, vec + 5 * H, true, sm.act);
  stash_act(H, st.h[5]);
  layer(OFF_W7, 6 * H, st.h[6]);
  layer(OFF_W8, 7 * H, st.h[7]);
  // h9 = relu(acc + b9), rounded to the next product (and float32 to the
  // stash); sigma_pre the float32 reduction of the UNROUNDED h9 against
  // w10s: each thread over its columns, the 4 lanes of a row by shuffle,
  // the 8 warps in order through shared memory.
  zero_acc(acc);
  gemm_fwd<H, H>(acc, sm.act, LDS, wmat + OFF_W9, sm.wst);
  {
    float sp[4][2] = {};
    each_pair<4>(acc, warp * 32, [&](int mt, int, int h, int row, int col, float& v0, float& v1) {
      const float x0 = fmaxf(v0 + __ldg(vec + 8 * H + col), 0.f);
      const float x1 = fmaxf(v1 + __ldg(vec + 8 * H + col + 1), 0.f);
      sp[mt][h] = fmaf(x0, __ldg(vec + OFF_W10S + col), sp[mt][h]);
      sp[mt][h] = fmaf(x1, __ldg(vec + OFF_W10S + col + 1), sp[mt][h]);
      if constexpr (STASH)
        *reinterpret_cast<float2*>(st.h9f + (l0 + row) * H + col) = make_float2(x0, x1);
      put2(sm.act + row * LDS + col, x0, x1);
    });
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
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
  if constexpr (STASH) tile_out(sm.act, LDS, H, st.h9b, l0);
  // feature head: no activation
  zero_acc(acc);
  gemm_fwd<H, H>(acc, sm.act, LDS, wmat + OFF_W10F, sm.wst);
  store_act<4>(acc, vec + OFF_B10F, false, sm.act);
  stash_act(H, st.feat);
  // ---- rgb head ----
  {
    float acc2[4][2][4];
    zero_acc(acc2);
    gemm_fwd<H, HR>(acc2, sm.act, LDS, wmat + OFF_WR0F, sm.wst);
    gemm_fwd<DP, HR>(acc2, sm.denc, LDD, wmat + OFF_WR0D, sm.wst);
    store_act<2>(acc2, vec + OFF_BR0, true, sm.act);
  }
  __syncthreads();
  if constexpr (STASH) tile_out(sm.act, LDS, HR, st.y, l0);
  if (tid < 3 * TC_P) {
    const int c = tid / TC_P, p = tid % TC_P;
    float z = 0.f;
    for (int k = 0; k < HR; ++k)
      z = fmaf(__bfloat162float(sm.act[p * LDS + k]), __bfloat162float(wmat[OFF_WR1 + k * 8 + c]),
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

}  // namespace nerf
