// KiloNeRF field backward in bfloat16 on Hopper's tensor cores (sm_90a):
// the gradient of every network's parameters from the (rgb, sigma)
// cotangent of its points.
//
// Replaces: nerf_tpu/ops/pallas/fused_kilonerf.py::_bwd_kernel_mk (the
// backward of make_fused_kilonerf_apply) in bfloat16, the kilonerf config's
// dtype; float32 stays on the CUDA cores (fused_kilonerf_bwd.cu), as TF32
// would change its results. Same function: recompute each point's forward,
// push the cotangent back through rgb2, rgb1, the trunk and its density
// row and l2 (ReLU masks from the forward), and sum each network's weight
// and bias gradients over its points. Rounding as point_backward in
// fused_kilonerf_bwd.cu and the TPU kernel's `mmT` / `acc_row`: both
// operands of every product bf16 (each cotangent rounded as the next
// product's operand), float32 sums, the bias gradients and the density
// row's (x2 * dsigma, x2 unrounded) float32 sums of the unrounded values.
// Positions and directions get no gradient (the JAX VJP returns zeros for
// them).
//
// What bounds it on this card: operations. Three times the forward's 6,080
// MACs a point less the two input products nobody reads (dz1 W1^T, dzy
// Wr1d^T): 15,360 MACs, 8.1 GFLOP at 262,144 points, 0.0081 ms on the bf16
// tensor cores; the bytes are the points and cotangents in, the weights in
// and the gradients out (30 MB, 9 us). The recompute's 84 precise sines a
// point (22 M of them) set the pace of row 15's forward (0.0985 ms there).
// The CUDA-core kernel it replaced in bf16 took 1.498 ms at 262,144
// points on an NVIDIA H100 80GB HBM3 at 700 W.
//
// Design: row 15's layout (fused_kilonerf_fwd_tc.cu):
//   * a CTA of four warps owns a run of at most 512 sorted points of ONE
//     network (fused_kilonerf_common.cuh::find_run on run_plan's ends) and
//     stages that network's bf16 weights once, in B-fragment order: the
//     forward's 50 fragments and the 28 of the transposes the cotangent
//     chain multiplies by (rgb2^T, the rgb1 feature rows^T, the trunk
//     features^T, l2^T);
//   * per 128-point sub-tile, each warp's 32 points: each lane reads its
//     point's payload row and cotangent through the sort order (no gather
//     outside the kernel), the warp runs row 15's chain
//     (fused_kilonerf_tc_common.cuh::point_chain_tc: the recomputed (rgb,
//     sigma) is row 15's output bit for bit), whose hooks keep the ReLU
//     masks in registers and the bf16 activations in the warp's
//     row-per-point tiles; then the cotangent chain dz W^T for rgb2, rgb1,
//     the trunk (plus dsigma times the density row) and l2 as m16n8
//     products in registers, each cotangent masked, summed by column for
//     its bias, rounded into a tile and packed as the next A fragments;
//   * the weight gradients A^T dz on the tensor cores with K running over
//     the sub-tile's points, in two rounds behind barriers: rgb1's and
//     rgb2's as soon as dzy is known, then (the chain taken on from dzy's
//     fragments in registers, its three cotangents written over rgb1's
//     operands) l1's, l2's and the trunk features'. ldmatrix.trans reads
//     both operands from the row-per-point tiles; each warp owns fixed m16
//     row blocks of the network's gradient (an rgb1 block, an l1 block, an
//     l2 or trunk block, and the rgb2 blocks on warps 0 and 1) in registers
//     across the run, and the bias sums live in shared memory, a row a
//     warp, added in a fixed order;
//   * each CTA writes its partial of its network's gradient;
//     fused_kilonerf_reduce_kernel adds each network's partials in run
//     order and writes exact zeros for a network without points. Nothing
//     is atomic, so two launches give the same bits.
// Shared memory: the fragments 19.5 KB and the four warps' tiles (the
// encodings, x1, x2, the features, y and the cotangents, bf16, the two
// rounds' in 84 KB), 107 KB: two CTAs an SM, so that one CTA's sines and
// products overlap the other's barriers and gradient rounds.
// Two debug outputs, null on every production path, receive the
// recomputed (rgb, sigma) and the ReLU masks of each point, in point order.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_kilonerf_tc_common.cuh"

namespace {

using namespace kilo;

constexpr int WARPS = THREADS / 32;
constexpr int SUBTILES = 4;
constexpr int PIECE = THREADS * SUBTILES;   // points a run

// The transposes' B fragments (B = W^T: k the layer's output, n its input),
// matrix m's fragment (kb, nt) at T_m + kb * 4 + nt.
constexpr int T_WR2 = 0;                 // rgb2^T 16 x 32 (3 rows real): 1 x 4
constexpr int T_WR1F = T_WR2 + 4;        // rgb1 feature rows^T 32 x 32: 2 x 4
constexpr int T_WTF = T_WR1F + 8;        // trunk features^T 32 x 32: 2 x 4
constexpr int T_W2 = T_WTF + 8;          // l2^T 32 x 32: 2 x 4
constexpr int NFRAG_T = T_W2 + 8;        // 28 fragments, 7,168 bytes

// tile strides (bf16): 80- and 48-byte rows put ldmatrix's eight 16-byte
// rows in distinct banks
constexpr int LDA = H + 8;               // the 32-column tiles
constexpr int LDR = 24;                  // the rgb2 cotangent (16 columns read, 3 real)
static_assert(LDD == LDA, "the direction encoding is an A operand beside the 32-column tiles");

// One warp's row-per-point tiles (row p: the warp's point p), in two
// regions. A holds the operands of the gradients taken last (penc^T dz1,
// x1^T dz2, x2^T dfeat) but for the cotangents; B first the operands of
// rgb1's and rgb2's gradients (the direction encoding, the features, y,
// dzy, dzr2), then, once those are taken, the three cotangents dfeat, dz2
// and dz1 (TilesC over the same bytes).
struct TilesA {
  __nv_bfloat16 penc[32][LDP];
  __nv_bfloat16 x1[32][LDA], x2[32][LDA];
};
struct TilesB {
  __nv_bfloat16 denc[32][LDD];
  __nv_bfloat16 feat[32][LDA], y[32][LDA], dzy[32][LDA];
  __nv_bfloat16 dzr2[32][LDR];
};
struct TilesC {
  __nv_bfloat16 dfeat[32][LDA], dz2[32][LDA], dz1[32][LDA];
};
static_assert(sizeof(TilesC) <= sizeof(TilesB), "the cotangents fit where rgb1's operands were");
struct WarpTiles {
  TilesA a;
  TilesB b;
  __device__ TilesC& c() { return *reinterpret_cast<TilesC*>(&b); }
  __device__ const TilesC& c() const { return *reinterpret_cast<const TilesC*>(&b); }
};
static_assert(sizeof(TilesA) % 16 == 0 && sizeof(TilesB) % 16 == 0, "tiles stay 16-byte aligned");
constexpr int TILE_STRIDE = sizeof(WarpTiles) / 2;   // bf16 values a warp

// A warp's column sums: the biases of l1, l2, the trunk features and rgb1,
// the density row (x2 dsigma), rgb2's bias and the density's.
constexpr int CS_B1 = 0, CS_B2 = 32, CS_BTF = 64, CS_BR1 = 96, CS_WTS = 128, CS_BR2 = 160,
              CS_BTS = 163, NCS = 164;

struct BwdSmem {
  uint2 frag[NFRAG][32];
  uint2 fragt[NFRAG_T][32];
  float vec[NV];
  float colsum[WARPS][NCS];
  __align__(16) WarpTiles t[WARPS];
};
constexpr int SMEM_BYTES = sizeof(BwdSmem);
static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two CTAs share an SM");

// The packed-buffer index of element (k, n) of transposed fragment f, -1
// for a pad.
__device__ __forceinline__ int frag_source_t(int f, int k, int n, int P, int D) {
  const int o_b1 = P * H, o_w2 = o_b1 + H, o_b2 = o_w2 + H * H, o_tw = o_b2 + H;
  const int o_tb = o_tw + H * (H + 1), o_r1w = o_tb + H + 1, o_r1b = o_r1w + (H + D) * H;
  const int o_r2w = o_r1b + H;
  if (f < T_WR1F) return k < 3 ? o_r2w + n * 3 + k : -1;
  if (f < T_WTF) return o_r1w + n * H + k;
  if (f < T_W2) return o_tw + n * (H + 1) + k;
  return o_w2 + n * H + k;
}

// The transposes' fragments into shared memory, as stage() the forward's.
__device__ __forceinline__ void stage_t(uint2 (*frag)[32], const __nv_bfloat16* __restrict__ src,
                                        int P, int D) {
  const int tid = threadIdx.x, lane = tid >> 2, q = (tid >> 1) & 1, h = tid & 1;
  const int kq = 2 * (lane & 3) + 8 * q + h, nq = lane >> 2;
  unsigned short v[NFRAG_T];
#pragma unroll
  for (int f = 0; f < NFRAG_T; ++f) {
    const int base = f < T_WR1F ? T_WR2 : f < T_WTF ? T_WR1F : f < T_W2 ? T_WTF : T_W2;
    const int kb = (f - base) / 4, nt = (f - base) % 4;
    const int i = frag_source_t(f, 16 * kb + kq, 8 * nt + nq, P, D);
    v[f] = i >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(src) + i) : 0;
  }
  unsigned short* fr = reinterpret_cast<unsigned short*>(&frag[0][0]);
#pragma unroll
  for (int f = 0; f < NFRAG_T; ++f) fr[f * 128 + tid] = v[f];
}

// Bit (mt * 4 + nt) * 4 + u of the mask: element u of tile (mt, nt) > 0.
__device__ __forceinline__ uint32_t mask_of(const float (&acc)[2][4][4]) {
  uint32_t m = 0u;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (acc[mt][nt][u] > 0.0f) m |= 1u << ((mt * 4 + nt) * 4 + u);
  return m;
}

__device__ __forceinline__ void apply_mask(float (&acc)[2][4][4], uint32_t m) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (!((m >> ((mt * 4 + nt) * 4 + u)) & 1u)) acc[mt][nt][u] = 0.0f;
}

// The accumulators rounded to bf16 into a warp's [32][LDA] tile.
__device__ __forceinline__ void put_tile(__nv_bfloat16 (*tile)[LDA], const float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(&tile[16 * mt + gq + 8 * h][8 * nt + 2 * c]) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// out[col] += the sum over the warp's 32 rows of acc (times w[p] of the
// lane's row p when W), unrounded, in a fixed order: the lane's four rows,
// then the eight lanes of a column by shuffles; lanes 0..3 add.
template <bool W>
__device__ __forceinline__ void add_col_sums(const float (&acc)[2][4][4], const float (&w)[4],
                                             float* out) {
  const int lane = threadIdx.x & 31, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float x = acc[p >> 1][nt][2 * (p & 1) + u];
        s = W ? fmaf(x, w[p], s) : s + x;
      }
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (lane < 4) out[8 * nt + 2 * c + u] += s;
    }
}

// The chain's hooks in the backward: the ReLU masks of x1, x2 and y, the
// bf16 tiles of x1, x2, the features and y, dsigma of the lane's rows (gs
// the sigma cotangent) and the density row's column sums.
struct BwdHooks {
  WarpTiles& t;
  float* cs;
  float gs[4];
  float ds[4];
  uint32_t m1, m2, my;

  __device__ void x1(const float (&acc)[2][4][4]) {
    m1 = mask_of(acc);
    put_tile(t.a.x1, acc);
  }
  __device__ void x2(const float (&acc)[2][4][4], const float (&sig)[4]) {
    m2 = mask_of(acc);
    put_tile(t.a.x2, acc);
#pragma unroll
    for (int p = 0; p < 4; ++p) ds[p] = sig[p] > 0.0f ? gs[p] : 0.0f;
    add_col_sums<true>(acc, ds, cs + CS_WTS);
  }
  __device__ void feat(const float (&acc)[2][4][4]) { put_tile(t.b.feat, acc); }
  __device__ void y(const float (&acc)[2][4][4]) {
    my = mask_of(acc);
    put_tile(t.b.y, acc);
  }
};

// acc (NT n8 tiles of the m16 block from column m0 of A) += A^T B over the
// sub-tile's first nks k16 steps of points: A and B row-per-point tiles
// (warp 0's at a0 / b0, stride lda / ldb; warp w's TILE_STRIDE further),
// both read by ldmatrix.trans.
template <int NT>
__device__ __forceinline__ void grad_block(float (&acc)[NT][4], const __nv_bfloat16* a0, int lda,
                                           int m0, const __nv_bfloat16* b0, int ldb, int nks) {
  const int l = threadIdx.x & 31, i = l >> 3;
  for (int ks = 0; ks < nks; ++ks) {
    const size_t wo = static_cast<size_t>(ks >> 1) * TILE_STRIDE;
    const int k0 = (ks & 1) * 16;
    uint32_t a[4];
    ldsm4t(a, a0 + wo + (k0 + ((i >> 1) << 3) + (l & 7)) * lda + m0 + ((i & 1) << 3));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4t(b, b0 + wo + (k0 + ((i & 1) << 3) + (l & 7)) * ldb + j * 8 + ((i >> 1) << 3));
      mma(acc[j], a, make_uint2(b[0], b[1]));
      if (j + 1 < NT) mma(acc[j + 1], a, make_uint2(b[2], b[3]));
    }
  }
}

// A block's gradient into the partial: rows m0.. of a matrix of `ncols`
// columns at out (columns < cmax written).
template <int NT>
__device__ __forceinline__ void put_block(const float (&acc)[NT][4], float* out, int m0,
                                          int ncols, int cmax) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 8 * j + 2 * c + u;
        if (col < cmax) out[(m0 + gq + 8 * h) * ncols + col] = acc[j][2 * h + u];
      }
}

__global__ void __launch_bounds__(THREADS, 2)
fused_kilonerf_bwd_tc_kernel(const float* __restrict__ pay, const long long* __restrict__ order,
                             const float4* __restrict__ cot, const int* __restrict__ offsets,
                             const int* __restrict__ run_end, int g3,
                             const __nv_bfloat16* __restrict__ wpack, Dims dims,
                             float* __restrict__ partial, float* __restrict__ rec,
                             int* __restrict__ masks) {
  extern __shared__ float4 smem4[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem4);
  int g, start, end;
  if (!find_run(blockIdx.x, run_end, offsets, g3, PIECE, g, start, end)) return;
  const __nv_bfloat16* src = wpack + static_cast<size_t>(g) * dims.R;
  stage(sm.frag, sm.vec, src, dims.P, dims.D);
  stage_t(sm.fragt, src, dims.P, dims.D);
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, c = lane & 3, warp = tid >> 5;
  for (int s = tid; s < WARPS * NCS; s += THREADS) (&sm.colsum[0][0])[s] = 0.0f;
  __syncthreads();
  WarpTiles& t = sm.t[warp];
  float* cs = sm.colsum[warp];
  const float* vec = sm.vec;

  // the warp's gradient blocks (warp-uniform; operands named by warp 0's
  // tiles, grad_block steps to the others'): first an rgb1 block, of
  // feat^T dzy (warps 0, 1) or denc^T dzy (2, 3), and on warps 0 and 1 an
  // rgb2 block of y^T dzr2; then an l1 block of penc^T dz1 and a block of
  // x1^T dz2 (warps 0, 1) or x2^T dfeat (2, 3)
  const WarpTiles& t0 = sm.t[0];
  const int half = 16 * (warp & 1);
  const __nv_bfloat16* r1a = warp < 2 ? &t0.b.feat[0][0] : &t0.b.denc[0][0];
  const __nv_bfloat16* l2a = warp < 2 ? &t0.a.x1[0][0] : &t0.a.x2[0][0];
  const __nv_bfloat16* l2b = warp < 2 ? &t0.c().dz2[0][0] : &t0.c().dfeat[0][0];
  float gr1[4][4], gr2[1][4], gl1[4][4], gl2[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) gr1[j][u] = gl1[j][u] = gl2[j][u] = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) gr2[0][u] = 0.0f;

  const float ones[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  for (int s0 = start; s0 < end; s0 += THREADS) {
    const int nks = 2 * min(WARPS, (end - s0 + 31) / 32);   // k16 steps with points
    const int w0 = s0 + warp * 32;
    const bool live = w0 < end;
    BwdHooks hk{t, cs, {0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}, 0u, 0u, 0u};
    float acc[2][4][4];
    uint32_t a2[2][2][4];
    if (live) {
      // lane p reads point w0 + p through the sort; row gq + 8 h of m-tile
      // mt is point 16 mt + gq + 8 h
      const int i = w0 + lane;
      const long long mine = i < end ? order[i] : -1;
      float loc[3] = {0.f, 0.f, 0.f}, dir[3] = {0.f, 0.f, 0.f};
      if (mine >= 0) {
        const float4 a = *reinterpret_cast<const float4*>(pay + 8 * mine);
        const float4 b = *reinterpret_cast<const float4*>(pay + 8 * mine + 4);
        loc[0] = a.x; loc[1] = a.y; loc[2] = a.z;
        dir[0] = b.x; dir[1] = b.y; dir[2] = b.z;
      }
      long long row[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        row[p] = __shfl_sync(FULL, mine, 16 * (p >> 1) + gq + 8 * (p & 1));
        hk.gs[p] = row[p] >= 0 ? cot[row[p]].w : 0.0f;
      }
      float rgb[4][2], sig[4];
      point_chain_tc(sm.frag, vec, t.a.penc, t.b.denc, loc, dir, dims.P, dims.D, rgb, sig, hk);
      if (rec != nullptr) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float blue = __shfl_down_sync(FULL, rgb[p][0], 1);
          if (c == 0 && row[p] >= 0)
            *reinterpret_cast<float4*>(rec + 4 * row[p]) =
                make_float4(rgb[p][0], rgb[p][1], blue, sig[p]);
        }
      }
      if (masks != nullptr) {
        // a point's ReLU masks (bit k: unit k of x1, x2, y on; then sigma
        // > 0), its columns gathered from the lane quad
        const uint32_t from[3] = {hk.m1, hk.m2, hk.my};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int mt = p >> 1, h = p & 1;
          uint32_t m[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            m[k] = 0u;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int u = 0; u < 2; ++u)
                m[k] |= ((from[k] >> ((mt * 4 + nt) * 4 + 2 * h + u)) & 1u) << (8 * nt + 2 * c + u);
            m[k] |= __shfl_xor_sync(FULL, m[k], 1);
            m[k] |= __shfl_xor_sync(FULL, m[k], 2);
          }
          if (c == 0 && row[p] >= 0)
            *reinterpret_cast<int4*>(masks + 4 * row[p]) =
                make_int4(static_cast<int>(m[0]), static_cast<int>(m[1]), static_cast<int>(m[2]),
                          sig[p] > 0.0f ? 1 : 0);
        }
      }
      // dzr2 = g_rgb rgb (1 - rgb), the lane's columns 2c, 2c + 1 (zero
      // past 2): its tile, its column sums (rgb2's bias) and the density's
      float dr[4][2];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 gv = row[p] >= 0 ? cot[row[p]] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 2 * c + u;
          const float gc = col == 0 ? gv.x : (col == 1 ? gv.y : gv.z);
          dr[p][u] = col < 3 ? gc * rgb[p][u] * (1.0f - rgb[p][u]) : 0.0f;
        }
        *reinterpret_cast<__nv_bfloat162*>(&t.b.dzr2[16 * (p >> 1) + gq + 8 * (p & 1)][2 * c]) =
            __floats2bfloat162_rn(dr[p][0], dr[p][1]);
      }
      {
        float sr[2], sd = hk.ds[0] + hk.ds[1] + hk.ds[2] + hk.ds[3];
#pragma unroll
        for (int u = 0; u < 2; ++u) sr[u] = dr[0][u] + dr[1][u] + dr[2][u] + dr[3][u];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sr[0] += __shfl_xor_sync(FULL, sr[0], off);
          sr[1] += __shfl_xor_sync(FULL, sr[1], off);
          sd += __shfl_xor_sync(FULL, sd, off);
        }
        if (lane < 2) {
          cs[CS_BR2 + 2 * c] += sr[0];
          if (2 * c + 1 < 3) cs[CS_BR2 + 2 * c + 1] += sr[1];
        }
        if (lane == 0) cs[CS_BTS] += sd;
      }
      // through rgb2 (K = 16, 3 real) and the ReLU of y: dzy, kept as the
      // next product's A fragments across the barriers below
      uint32_t ar[2][1][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ar[mt][0][0] = pack2(dr[2 * mt][0], dr[2 * mt][1]);
        ar[mt][0][1] = pack2(dr[2 * mt + 1][0], dr[2 * mt + 1][1]);
        ar[mt][0][2] = ar[mt][0][3] = 0u;
      }
      zero(acc);
      product<1, 4>(acc, ar, sm.fragt + T_WR2);
      apply_mask(acc, hk.my);
      add_col_sums<false>(acc, ones, cs + CS_BR1);
      put_tile(t.b.dzy, acc);
      to_frags<2>(a2, acc, 0);
    }
    __syncthreads();
    // rgb1's and rgb2's gradients over the sub-tile's points
    grad_block<4>(gr1, r1a, LDA, half, &t0.b.dzy[0][0], LDA, nks);
    if (warp < 2) grad_block<1>(gr2, &t0.b.y[0][0], LDA, 16 * warp, &t0.b.dzr2[0][0], LDR, nks);
    __syncthreads();
    if (live) {
      TilesC& tc = t.c();
      // through rgb1's feature rows: dfeat = dzy Wr1f^T
      zero(acc);
      product<2, 4>(acc, a2, sm.fragt + T_WR1F);
      add_col_sums<false>(acc, ones, cs + CS_BTF);
      put_tile(tc.dfeat, acc);
      // through the trunk (features and density row) and the ReLU of x2
      to_frags<2>(a2, acc, 0);
      zero(acc);
      product<2, 4>(acc, a2, sm.fragt + T_WTF);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[mt][nt][u] += hk.ds[2 * mt + (u >> 1)] * vec[V_WTS + 8 * nt + 2 * c + (u & 1)];
      apply_mask(acc, hk.m2);
      add_col_sums<false>(acc, ones, cs + CS_B2);
      put_tile(tc.dz2, acc);
      // through l2 and the ReLU of x1: dz1
      to_frags<2>(a2, acc, 0);
      zero(acc);
      product<2, 4>(acc, a2, sm.fragt + T_W2);
      apply_mask(acc, hk.m1);
      add_col_sums<false>(acc, ones, cs + CS_B1);
      put_tile(tc.dz1, acc);
    }
    __syncthreads();
    // l1's, l2's and the trunk features' gradients
    grad_block<4>(gl1, &t0.a.penc[0][0], LDP, 16 * warp, &t0.c().dz1[0][0], LDA, nks);
    grad_block<4>(gl2, l2a, LDA, half, l2b, LDA, nks);
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * NW;
  put_block<4>(gr1, out + (warp < 2 ? S_WR1F : S_WR1D), half, H, H);
  if (warp < 2) put_block<1>(gr2, out + S_WR2, 16 * warp, 4, 4);
  put_block<4>(gl1, out + S_W1, 16 * warp, H, H);
  put_block<4>(gl2, out + (warp < 2 ? S_W2 : S_WTF), half, H, H);
  // the bias and density-row sums, the warps' rows added in order
  for (int s = tid; s < NCS; s += THREADS) {
    const float v = ((sm.colsum[0][s] + sm.colsum[1][s]) + sm.colsum[2][s]) + sm.colsum[3][s];
    int slot;
    if (s < CS_B2) slot = S_B1 + s;
    else if (s < CS_BTF) slot = S_B2 + s - CS_B2;
    else if (s < CS_BR1) slot = S_BTF + s - CS_BTF;
    else if (s < CS_WTS) slot = S_BR1 + s - CS_BR1;
    else if (s < CS_BR2) slot = S_WTS + s - CS_WTS;
    else if (s < CS_BTS) slot = S_BR2 + s - CS_BR2;
    else slot = S_BTS;
    out[slot] = v;
  }
}

}  // namespace

extern "C" {

// Floats of one run's partial gradient (the shared-memory layout of
// fused_kilonerf_common.cuh, S_*).
int fused_kilonerf_bwd_tc_partial_floats() { return NW; }

// `pay` the (n, 8) float32 payload in point order (cols 0-2 voxel-local
// position, 4-6 direction) and `order` (n,) int64 the stable sort of the
// points by network, as for fused_kilonerf_fwd_tc; `cot` the (n, 4)
// float32 cotangent of (rgb, sigma) in point order; `offsets` the (g3 + 1)
// segment starts in sorted order; `run_end` the running count of
// `run`-point runs over the networks; `wpack` the (g3, R) packed bfloat16
// parameters; `partial` (grid, fused_kilonerf_bwd_tc_partial_floats())
// float32 scratch; `out` the (g3, R) float32 gradient in the packed
// layout; `rec` and `masks`, when not null, the (n, 4) recomputed (rgb,
// sigma) and the (n, 4) int32 ReLU masks of each point's x1, x2 and y (bit
// k: unit k on) and sigma (1: on), in point order (a check's, never a
// production path's). Returns 0 on success, a cudaError_t code after a
// failed launch, or -1 when the widths or shapes do not fit this kernel
// (bf16 must be 1).
int fused_kilonerf_bwd_tc(const float* pay, const long long* order, const float* cot,
                          const int* offsets, const int* run_end, int g3, const void* wpack,
                          int R, int P, int D, int hidden, int bf16, int n, int run, int grid,
                          float* partial, float* out, float* rec, int* masks, void* stream) {
  if (hidden != H || P > PMAX || D > DMAX || P < 3 || D < 3 || R != packed_size(P, D) ||
      bf16 != 1 || g3 <= 0 || n <= 0 || run != PIECE || grid <= 0)
    return -1;
  const Dims dims{P, D, R};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fused_kilonerf_bwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kilonerf_bwd_tc_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      pay, order, reinterpret_cast<const float4*>(cot), offsets, run_end, g3,
      static_cast<const __nv_bfloat16*>(wpack), dims, partial, rec, masks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kilonerf_reduce_kernel<<<g3, 256, 0, s>>>(partial, run_end, dims, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_kilonerf_bwd_tc_error(int code) {
  if (code == -1) return "widths or shapes do not fit the kernel (bfloat16, hidden 32, "
                         "encodings of at most 64 / 32 columns, 512-point runs)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
