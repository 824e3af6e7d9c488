// The KiloNeRF field's tensor-core chain for Hopper (sm_90a), shared by the
// bfloat16 forward (fused_kilonerf_fwd_tc.cu, row 15) and the bfloat16
// backward (fused_kilonerf_bwd_tc.cu, row 16), which recomputes with it the
// forward it differentiates: one chain, so the backward's recomputed (rgb,
// sigma) is the forward's output bit for bit.
//
// A warp takes 32 points of one network, two m16 tiles of mma.sync
// m16n8k16 (bf16 operands, float32 accumulators). The network's weights
// are staged once a CTA into shared memory in the B-fragment layout (a
// lane's two registers of a 16 x 8 tile side by side, so that a fragment
// is one 8-byte load a lane, conflict free): l1 64 x 32 (63 rows real), l2
// and the trunk's features 32 x 32, rgb1 64 x 32 (32 feature rows, then
// the 27 direction rows), rgb2 32 x 8 (3 columns real); 12.8 KB, with the
// biases and the density column in float32. Each lane writes its point's
// encoding columns (enc_value, the cosine as sin(x + pi/2), rounded to
// bfloat16) into the warp's row-per-point tiles, in a short loop: every
// lane decodes the same column at once, and the kernel holds a few copies
// of sinf, not one per fragment element. ldmatrix turns the tiles into A
// fragments; each layer's m16n8 accumulators, biased, activated and packed
// to bfloat16, are the next layer's A fragments in registers. The density
// is a float32 dot of the unrounded x2 with the rounded density row: each
// lane's 8 columns, then the sum over the lane quad by two shuffles.
//
// Accumulator element u of n-tile nt of m-tile mt, in lane (gq, c) = (lane
// / 4, lane % 4), is row 16 mt + gq + 8 (u / 2), column 8 nt + 2c + u % 2;
// p = 2 mt + u / 2 numbers a lane's four rows.

#pragma once

#include "fused_kilonerf_common.cuh"

namespace kilo {

constexpr int THREADS = 128;   // points per run: 32 a warp
constexpr unsigned FULL = 0xffffffffu;

// B fragments in shared memory: matrix m's fragment (kb, nt) at
// F_m + kb * NT_m + nt, each 32 lanes x 2 registers (uint2).
constexpr int F_W1 = 0;                 // 64 x 32: 4 x 4
constexpr int F_W2 = F_W1 + 16;         // 32 x 32: 2 x 4
constexpr int F_WTF = F_W2 + 8;         // 32 x 32: 2 x 4
constexpr int F_WR1 = F_WTF + 8;        // 64 x 32: 4 x 4
constexpr int F_WR2 = F_WR1 + 16;       // 32 x 8: 2 x 1
constexpr int NFRAG = F_WR2 + 2;        // 50 fragments, 12,800 bytes
// float32 vectors after them
constexpr int V_B1 = 0, V_B2 = 32, V_BTF = 64, V_WTS = 96, V_BR1 = 128, V_BR2 = 160,
              V_BTS = 163, NV = 164;

// encoding tile strides (bf16): 144- and 80-byte rows put ldmatrix's eight
// 16-byte rows in distinct banks
constexpr int LDP = PMAX + 8, LDD = DMAX + 8;

// The packed-buffer index of element (k, n) of B fragment f, -1 for a pad.
__device__ __forceinline__ int frag_source(int f, int k, int n, int P, int D) {
  const int o_b1 = P * H, o_w2 = o_b1 + H, o_b2 = o_w2 + H * H, o_tw = o_b2 + H;
  const int o_tb = o_tw + H * (H + 1), o_r1w = o_tb + H + 1, o_r1b = o_r1w + (H + D) * H;
  const int o_r2w = o_r1b + H;
  if (f < F_W2) return k < P ? k * H + n : -1;
  if (f < F_WTF) return o_w2 + k * H + n;
  if (f < F_WR1) return o_tw + k * (H + 1) + n;
  if (f < F_WR2) return k < H + D ? o_r1w + k * H + n : -1;
  return n < 3 ? o_r2w + k * 3 + n : -1;
}

__device__ __forceinline__ int vec_source(int v, int P, int D) {
  const int o_b1 = P * H, o_w2 = o_b1 + H, o_b2 = o_w2 + H * H, o_tw = o_b2 + H;
  const int o_tb = o_tw + H * (H + 1), o_r1w = o_tb + H + 1, o_r1b = o_r1w + (H + D) * H;
  const int o_r2b = o_r1b + H + 3 * H;
  if (v < V_B2) return o_b1 + v;
  if (v < V_BTF) return o_b2 + (v - V_B2);
  if (v < V_WTS) return o_tb + (v - V_BTF);
  if (v < V_BR1) return o_tw + (v - V_WTS) * (H + 1) + H;
  if (v < V_BR2) return o_r1b + (v - V_BR1);
  if (v < V_BTS) return o_r2b + (v - V_BR2);
  return o_tb + H;
}

// Network g's weights into shared memory; every thread takes part, the
// caller synchronises. Thread tid writes, in every fragment f, half tid % 2
// of register tid / 2 % 2 of lane tid / 4: a fragment is 128 bf16 values,
// one a thread. The 50 loads are all issued before the first store, so that
// the CTA waits for one round trip, not 50.
__device__ __forceinline__ void stage(uint2 (*frag)[32], float* vec,
                                      const __nv_bfloat16* __restrict__ src, int P, int D) {
  static_assert(THREADS == 128, "one fragment element a thread");
  const int tid = threadIdx.x, lane = tid >> 2, q = (tid >> 1) & 1, h = tid & 1;
  const int kq = 2 * (lane & 3) + 8 * q + h, nq = lane >> 2;
  unsigned short v[NFRAG];
#pragma unroll
  for (int f = 0; f < NFRAG; ++f) {
    const int nt_count = f < F_WR2 ? 4 : 1;
    const int base = f < F_W2 ? F_W1 : f < F_WTF ? F_W2 : f < F_WR1 ? F_WTF : f < F_WR2 ? F_WR1
                                                                                        : F_WR2;
    const int kb = (f - base) / nt_count, nt = (f - base) % nt_count;
    const int i = frag_source(f, 16 * kb + kq, 8 * nt + nq, P, D);
    v[f] = i >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(src) + i) : 0;
  }
  static_assert(NV <= 2 * THREADS, "two vector values a thread");
  const float b0 = __bfloat162float(src[vec_source(tid, P, D)]);
  const float b1 =
      tid + THREADS < NV ? __bfloat162float(src[vec_source(tid + THREADS, P, D)]) : 0.0f;
  unsigned short* fr = reinterpret_cast<unsigned short*>(&frag[0][0]);
#pragma unroll
  for (int f = 0; f < NFRAG; ++f) fr[f * 128 + tid] = v[f];
  vec[tid] = b0;
  if (tid + THREADS < NV) vec[tid + THREADS] = b1;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The encoding columns of the lane's point, rounded to bfloat16, into row
// `lane` of the warp's tile (columns past `width` zero).
template <int COLS, int LD>
__device__ __forceinline__ void enc_tile(__nv_bfloat16 (*tile)[LD], const float (&x)[3],
                                         int width) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int col = 0; col < COLS; col += 2) {
    const float v0 = col < width ? enc_value(x[0], x[1], x[2], col) : 0.0f;
    const float v1 = col + 1 < width ? enc_value(x[0], x[1], x[2], col + 1) : 0.0f;
    *reinterpret_cast<__nv_bfloat162*>(&tile[lane][col]) = __floats2bfloat162_rn(v0, v1);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The A fragments of k blocks kb0.. of a warp's [32][LD] tile.
template <int KB, int NKB, int LD>
__device__ __forceinline__ void tile_frags(uint32_t (&a)[2][KB][4],
                                           const __nv_bfloat16 (*tile)[LD], int kb0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb)
      ldsm4(a[mt][kb0 + kb], &tile[16 * mt + (l & 15)][16 * kb + ((l >> 4) << 3)]);
}

// acc (two m16 tiles x NT n8 tiles) = A B, A in registers, B fragments
// from F in shared memory.
template <int KB, int NT>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], const uint32_t (&a)[2][KB][4],
                                        const uint2 (*frag)[32], int kb0 = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = frag[(kb0 + kb) * NT + nt][lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], a[mt][kb], b);
    }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0.0f;
}

// x = act(acc + bias[col]) in place (relu or none); column of element u of
// n-tile nt is 8 nt + 2c + (u & 1).
__device__ __forceinline__ void bias_act(float (&acc)[2][4][4], const float* bias, bool relu) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x = acc[mt][nt][u] + bias[8 * nt + 2 * c + (u & 1)];
        acc[mt][nt][u] = relu ? fmaxf(x, 0.0f) : x;
      }
}

// The 32 activation columns of acc as the A fragments (k blocks kb0, kb0 +
// 1) of the next product, rounded to bfloat16: k block kb is n-tiles 2kb
// (columns 2c, 2c + 1) and 2kb + 1 (columns 8 + 2c, 9 + 2c).
template <int KB>
__device__ __forceinline__ void to_frags(uint32_t (&a)[2][KB][4], const float (&acc)[2][4][4],
                                         int kb0) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      a[mt][kb0 + kb][0] = pack2(acc[mt][2 * kb][0], acc[mt][2 * kb][1]);
      a[mt][kb0 + kb][1] = pack2(acc[mt][2 * kb][2], acc[mt][2 * kb][3]);
      a[mt][kb0 + kb][2] = pack2(acc[mt][2 * kb + 1][0], acc[mt][2 * kb + 1][1]);
      a[mt][kb0 + kb][3] = pack2(acc[mt][2 * kb + 1][2], acc[mt][2 * kb + 1][3]);
    }
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The chain's hooks for the forward: none. The backward's keep what its
// cotangent chain and gradient products read: each called with the
// layer's accumulators after the bias and the activation (x2 also with
// the lane's four densities, after the ReLU).
struct NoHooks {
  __device__ void x1(const float (&)[2][4][4]) {}
  __device__ void x2(const float (&)[2][4][4], const float (&)[4]) {}
  __device__ void feat(const float (&)[2][4][4]) {}
  __device__ void y(const float (&)[2][4][4]) {}
};

// The forward of the warp's 32 points (lane p holds point p's voxel-local
// position `loc` and direction `dir`, zero for a lane without a point): the
// encodings into the warp's tiles penc and denc, then l1 -> relu -> l2 ->
// relu -> trunk (features, and the density from the unrounded x2) -> rgb1
// on [features, direction encoding] -> relu -> rgb2 -> sigmoid. Gives the
// lane's rows p its rgb columns 2c, 2c + 1 (zero past 2) in rgb[p] and the
// density after the ReLU in sig[p] (every lane of the quad the same).
template <typename Hooks>
__device__ __forceinline__ void point_chain_tc(const uint2 (*frag)[32], const float* vec,
                                               __nv_bfloat16 (*penc)[LDP],
                                               __nv_bfloat16 (*denc)[LDD],
                                               const float (&loc)[3], const float (&dir)[3],
                                               int P, int D, float (&rgb)[4][2], float (&sig)[4],
                                               Hooks& hk) {
  const int c = threadIdx.x & 3;
  enc_tile<PMAX, LDP>(penc, loc, P);
  enc_tile<DMAX, LDD>(denc, dir, D);
  __syncwarp();
  float acc[2][4][4];
  uint32_t a4[2][4][4], a2[2][2][4];
  // l1 on the position encoding
  tile_frags<4, 4, LDP>(a4, penc, 0);
  zero(acc);
  product<4, 4>(acc, a4, frag + F_W1);
  bias_act(acc, vec + V_B1, true);
  hk.x1(acc);
  // l2
  to_frags<2>(a2, acc, 0);
  zero(acc);
  product<2, 4>(acc, a2, frag + F_W2);
  bias_act(acc, vec + V_B2, true);
  // the density: unrounded x2 . the density row, over the lane quad
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int mt = p >> 1, h = p & 1;
    float s = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        s = fmaf(acc[mt][nt][2 * h + u], vec[V_WTS + 8 * nt + 2 * c + u], s);
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    sig[p] = fmaxf(s + vec[V_BTS], 0.0f);
  }
  hk.x2(acc, sig);
  // trunk features (no activation)
  to_frags<2>(a2, acc, 0);
  zero(acc);
  product<2, 4>(acc, a2, frag + F_WTF);
  bias_act(acc, vec + V_BTF, false);
  hk.feat(acc);
  // rgb1 on [features, direction encoding]
  to_frags<4>(a4, acc, 0);
  tile_frags<4, 2, LDD>(a4, denc, 2);
  zero(acc);
  product<4, 4>(acc, a4, frag + F_WR1);
  bias_act(acc, vec + V_BR1, true);
  hk.y(acc);
  // rgb2 (3 of 8 columns real) and the sigmoid
  to_frags<2>(a2, acc, 0);
  float z[2][1][4];
  zero(z);
  product<2, 1>(z, a2, frag + F_WR2);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int mt = p >> 1, h = p & 1;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = 2 * c + u;
      rgb[p][u] =
          col < 3 ? 1.0f / (1.0f + expf(-(z[mt][0][2 * h + u] + vec[V_BR2 + col]))) : 0.0f;
    }
  }
}

}  // namespace kilo
