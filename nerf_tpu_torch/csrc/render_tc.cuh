// Tensor-core building blocks of the bfloat16 render kernels for Hopper
// (sm_90a): warp-level mma.sync.m16n8k16 (bf16 operands, float32 sums) fed
// from shared memory by ldmatrix, and three block-level products over
// bf16 tiles, each with its operand tiles staged by cp.async in a ring of
// stages of KTC rows (pipeline):
//   * gemm_fwd:  a 64-point chunk's activations (shared memory, point-major)
//                times a weight matrix W (K x N, the packed layout) streamed
//                from device memory (L2: every CTA reads the same weights):
//                a layer of the forward;
//   * gemm_dact: a 64-point chunk of dz (shared memory, point-major) times
//                W^T, read from the same packed W (256 x KP) without a
//                transposed copy: the dz W^T product of the backward;
//   * dweight_tc: A^T dz over all of a CTA's points (both point-major in
//                device memory), in strips of A's columns with the strip's
//                output in registers: a weight gradient.
// Every product rounds nothing itself: its operands are bf16 as stored, and
// its sums are float32 (the tensor cores' accumulation). each_pair walks a
// warp's accumulators with their rows and columns, for the epilogues;
// tile_out copies a chunk's tile to a train pass's stash. The field
// backwards' input products and the encodings' backward over a chunk
// (input_product, encode_bwd_rows, direction_cotangent_tc) close the file.

#pragma once

#include "fused_render_common.cuh"

namespace nerf {

using bf16 = __nv_bfloat16;

#ifndef NERF_TC_P
#define NERF_TC_P 64
#endif
#ifndef NERF_TC_PB
#define NERF_TC_PB NERF_TC_P
#endif
constexpr int TC_P = NERF_TC_P;    // points per chunk of a forward
constexpr int TC_PB = NERF_TC_PB;  // points per chunk of a backward's dz W^T
constexpr int MT_F = TC_P / 16;    // m16 tiles of a forward chunk
constexpr int MT_B = TC_PB / 16;   // of a backward chunk
constexpr int KTC = 32;            // rows a staged k-tile
constexpr int WARPS = THREADS / 32;
constexpr int LDS = H + 8;         // row stride (bf16) of [points][H] tiles
constexpr int LDN = NB + 8;        // of [points][NB] tiles (a block of columns)
constexpr int LDP = PP + 8;        // of the position-encoding tile
constexpr int LDD = DP + 8;        // of the direction-encoding tile
// ldmatrix reads 8 rows of 16 bytes at once: a row stride of 16 mod 128
// bytes puts them in distinct banks
static_assert((LDS * 2) % 128 == 16 && (LDP * 2) % 128 == 16 && (LDN * 2) % 128 == 16,
              "bank-conflicting strides");
static_assert(TC_P % KTC == 0 && TC_P % TC_PB == 0 && TC_PB % 16 == 0, "chunk sizes");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one 16x8 tile, k = 16: a (16x16, row-major fragment), b
// (16x8, column-major fragment), float32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loads (lane l, g = l / 4, c = l % 4; accumulator element 2h + u
// of tile (mt, j) is row mt * 16 + g + 8h, column j * 8 + 2c + u).
// A 16x16 at (m0, k0) of a row-major [m][k] tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(a, s + (m0 + (l & 15)) * ld + k0 + ((l >> 4) << 3));
}
// A 16x16 at (m0, k0) of a tile stored [k][m] (A transposed).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3;
  ldsm4t(a, s + (k0 + ((i >> 1) << 3) + (l & 7)) * ld + m0 + ((i & 1) << 3));
}
// B of two 8-column tiles (n0, n0 + 8) over k0..k0+15 of a tile stored
// [k][n]: b[0], b[1] the first tile, b[2], b[3] the second.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3;
  ldsm4t(b, s + (k0 + ((i & 1) << 3) + (l & 7)) * ld + n0 + ((i >> 1) << 3));
}
// The same from a tile stored [n][k].
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3;
  ldsm4(b, s + (n0 + ((i >> 1) << 3) + (l & 7)) * ld + k0 + ((i & 1) << 3));
}

// Each accumulator element of a warp's (16 MT) x (8 NT) tile from column n0
// with its row and column: f(mt, j, h, row, col, v[col], v[col + 1]) writes
// back through the references.
template <int NT, int MT, typename F>
__device__ __forceinline__ void each_pair(float (&acc)[MT][NT][4], int n0, F f) {
  const int l = threadIdx.x & 31, g = l >> 2, c = l & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mt, j, h, mt * 16 + g + 8 * h, n0 + j * 8 + 2 * c, acc[mt][j][2 * h],
          acc[mt][j][2 * h + 1]);
}

__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// out[row][col] = act(acc + bias[col]) rounded to bf16 (shared memory), the
// warp's columns from nb + warp * 8 NT (nb: the block's first column).
template <int NT, int MT>
__device__ __forceinline__ void store_act(float (&acc)[MT][NT][4], const float* __restrict__ bias,
                                          bool relu, bf16* out, int nb = 0) {
  each_pair<NT>(acc, nb + (threadIdx.x >> 5) * NT * 8,
                [&](int, int, int, int row, int col, float& v0, float& v1) {
                  float x0 = v0 + __ldg(bias + col), x1 = v1 + __ldg(bias + col + 1);
                  if (relu) {
                    x0 = fmaxf(x0, 0.f);
                    x1 = fmaxf(x1, 0.f);
                  }
                  put2(out + row * LDS + col, x0, x1);
                });
}

// Rows l0 .. l0 + rows - 1 of a device array (rows ldg apart; by default
// `ncols` columns) from a [rows][ncols] shared-memory tile of row stride
// lds (16-byte copies).
__device__ __forceinline__ void tile_out(const bf16* s, int lds, int ncols, bf16* g, size_t l0,
                                         int ldg = 0, int rows = TC_P) {
  const int cpr = ncols / 8;
  if (ldg == 0) ldg = ncols;
  for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, q = (e % cpr) * 8;
    *reinterpret_cast<uint4*>(g + (l0 + r) * ldg + q) =
        *reinterpret_cast<const uint4*>(s + r * lds + q);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;
}

// The k-loop of the products: tiles 0..ntiles-1 staged by `stage(kt,
// slot)` (its cp.async copies, uncommitted) into a ring of NS slots, NS - 1
// tiles in flight ahead of the one `compute(kt, slot)` reads. Any cp.async
// group the caller committed before is complete by the first compute.
// Starts with every thread past a barrier where the caller needs it;
// ends with every thread past one.
template <int NS, typename Stage, typename Compute>
__device__ __forceinline__ void pipeline(int ntiles, Stage stage, Compute compute) {
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) stage(t, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const int nx = kt + NS - 1;
    if (nx < ntiles) stage(nx, nx % NS);
    cp_async_commit();
    compute(kt, kt % NS);
  }
  __syncthreads();
}

constexpr int NS_FWD = 2;    // weight stages of a forward product
constexpr int NS_DACT = 3;   // of a dz W^T product
constexpr int NS_DW = 4;     // of a weight gradient

// acc (the warp's (16 MT) x N/8 columns from warp * N/8) += A W over K, A
// the chunk's [16 MT][K] activations in shared memory (stride lda), W (K x
// N, row-major, rows ldw apart: a block of a wider matrix from its first
// column) in device memory, streamed KTC rows at a time through NS_FWD
// stages of KTC x (N + 8) in `wst`.
template <int K, int N, int MT>
__device__ __forceinline__ void gemm_fwd(float (&acc)[MT][N / 64][4], const bf16* a_s, int lda,
                                         const bf16* __restrict__ w, bf16* wst, int ldw = N) {
  constexpr int NT = N / 64, LB = N + 8, STG = KTC * LB, NKT = K / KTC, CPR = N / 8;
  static_assert(NKT * KTC == K && NT % 2 == 0, "K must be a multiple of KTC, N of 128");
  const int n0 = (threadIdx.x >> 5) * (N / 8);
  pipeline<NS_FWD>(
      NKT,
      [&](int kt, int slot) {
        bf16* dst = wst + slot * STG;
        for (int e = threadIdx.x; e < KTC * CPR; e += THREADS) {
          const int r = e / CPR, q = (e % CPR) * 8;
          cp_async16(dst + r * LB + q, w + static_cast<size_t>(kt * KTC + r) * ldw + q);
        }
      },
      [&](int kt, int slot) {
        const bf16* bs = wst + slot * STG;
#pragma unroll
        for (int ks = 0; ks < KTC; ks += 16) {
          uint32_t b[NT][2];
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t r[4];
            load_b_kn(r, bs, LB, n0 + j * 8, ks);
            b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            load_a(a, a_s, lda, mt * 16, kt * KTC + ks);
#pragma unroll
            for (int j = 0; j < NT; ++j) mma16816(acc[mt][j], a, b[j][0], b[j][1]);
          }
        }
      });
}

// acc (the warp's (16 MT) x 32 columns from warp * 32) = dz W^T: dz the
// chunk's [16 MT][KP] in shared memory (stride LDS), W (NB x KP, row-major:
// a block of NB rows of the packed (in, out) matrix) in device memory,
// streamed as [NB][KTC] column slices through NS_DACT stages of NB x (KTC +
// 8) in `wst`.
template <int KP, int MT>
__device__ __forceinline__ void gemm_dact(float (&acc)[MT][4][4], const bf16* a_s,
                                          const bf16* __restrict__ w, bf16* wst) {
  constexpr int LB = KTC + 8, STG = NB * LB, NKT = KP / KTC, CPR = KTC / 8;
  static_assert(NKT * KTC == KP, "KP must be a multiple of KTC");
  const int n0 = (threadIdx.x >> 5) * 32;
  pipeline<NS_DACT>(
      NKT,
      [&](int kt, int slot) {
        bf16* dst = wst + slot * STG;
        for (int e = threadIdx.x; e < NB * CPR; e += THREADS) {
          const int r = e / CPR, q = (e % CPR) * 8;
          cp_async16(dst + r * LB + q, w + static_cast<size_t>(r) * KP + kt * KTC + q);
        }
      },
      [&](int kt, int slot) {
        const bf16* bs = wst + slot * STG;
#pragma unroll
        for (int ks = 0; ks < KTC; ks += 16) {
          uint32_t b[4][2];
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            uint32_t r[4];
            load_b_nk(r, bs, LB, n0 + j * 8, ks);
            b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            load_a(a, a_s, LDS, mt * 16, kt * KTC + ks);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma16816(acc[mt][j], a, b[j][0], b[j][1]);
          }
        }
      });
}

// Bytes of the stages of each product (a block of NB columns).
constexpr int WST_FWD_BYTES = NS_FWD * KTC * LDN * 2;
constexpr int WST_DACT_BYTES = NS_DACT * NB * (KTC + 8) * 2;
constexpr int DW_STAGE_BYTES = NS_DW * KTC * ((NB + 8) + (NB / 2 + 8)) * 2;   // the largest strip

// part[m][n] = sum over the CTA's points l < cap_c of A[l][m] dz[l][n], for
// m < M (A point-major with stride lda, bf16) and n < ntot (dz point-major
// with stride LDZ, bf16; part's rows ntot long), both in device memory.
// Strips of MS columns of A times blocks of N columns of dz; the warps tile
// a strip's MS x N output WM x WN, each warp's tile in registers over all
// the points. `stage` holds the stages of KTC points of the strip of A and
// of the block of dz. Starts and ends with every thread past a barrier.
template <int MS, int N, int WM, int WN>
__device__ void dweight_tc(const bf16* __restrict__ A, int lda, int M,
                           const bf16* __restrict__ dz, int cap_c, float* __restrict__ part,
                           bf16* stage, int ntot = N) {
  static_assert(WM * WN == WARPS, "the warps tile the strip");
  constexpr int WTM = MS / WM, WTN = N / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT * 16 == WTM && NT * 8 == WTN && NT % 2 == 0, "warp tile shape");
  constexpr int LA = MS + 8, LB = N + 8, SA = KTC * LA, SB = KTC * LB;
  constexpr int CA = MS / 8, CB = N / 8;
  bf16* as0 = stage;
  bf16* bs0 = stage + NS_DW * SA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, c = lane & 3;
  for (int m0 = 0; m0 < M; m0 += MS)
  for (int n0 = 0; n0 < ntot; n0 += N) {
    float acc[MT][NT][4];
    zero_acc(acc);
    pipeline<NS_DW>(
        cap_c / KTC,
        [&](int kt, int slot) {
          const size_t r0 = static_cast<size_t>(kt) * KTC;
          for (int e = tid; e < KTC * CA; e += THREADS) {
            const int r = e / CA, q = (e % CA) * 8;
            cp_async16(as0 + slot * SA + r * LA + q, A + (r0 + r) * lda + m0 + q);
          }
          for (int e = tid; e < KTC * CB; e += THREADS) {
            const int r = e / CB, q = (e % CB) * 8;
            cp_async16(bs0 + slot * SB + r * LB + q, dz + (r0 + r) * LDZ + n0 + q);
          }
        },
        [&](int, int slot) {
          const bf16* as = as0 + slot * SA;
          const bf16* bs = bs0 + slot * SB;
#pragma unroll
          for (int ks = 0; ks < KTC; ks += 16) {
            uint32_t b[NT][2];
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
              uint32_t r[4];
              load_b_kn(r, bs, LB, wn * WTN + j * 8, ks);
              b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t a[4];
              load_a_t(a, as, LA, wm * WTM + mt * 16, ks);
#pragma unroll
              for (int j = 0; j < NT; ++j) mma16816(acc[mt][j], a, b[j][0], b[j][1]);
            }
          }
        });
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * WTM + mt * 16 + g + 8 * h;
          const int col = n0 + wn * WTN + j * 8 + 2 * c;
          if (row < M)
            *reinterpret_cast<float2*>(part + static_cast<size_t>(row) * ntot + col) =
                make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
  }
}

// ---------------------------------------------------------------- inputs
// The field backwards' input products and the encodings' backward
// (nerf_tpu/ops/pallas/fused_nerf.py::_encode_bwd): a chunk's cotangent of
// the encoding columns is a narrow product dz W_in^T (64, 32 or 64 live
// columns), taken on gemm_fwd against W_in^T zero-padded to 128 columns.

constexpr int LDG = PP + 4;        // row stride (floats) of an encoding-cotangent tile

// One thread a (row, coordinate) of a chunk whose first point is p0 and
// whose encoding cotangents are the tile g ([TC_PB][LDG] floats, shared
// memory): out = _encode_bwd at x, both (n, 3), for rows < nvalid.
__device__ __forceinline__ void encode_bwd_rows(const float* g, const float* __restrict__ x,
                                                size_t p0, int nvalid, int real,
                                                float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (tid < 3 * TC_PB) {
    const int row = tid / 3, d = tid % 3;
    if (row < nvalid) {
      const size_t at = (p0 + row) * 3 + d;
      out[at] = encode_bwd_at([&](int c) { return g[row * LDG + c]; }, x[at], d, real);
    }
  }
}

// For each TC_PB-point chunk of rows [0, nrows) (a multiple of TC_PB): acc =
// dz W_in^T, dz the chunk's first K columns (bf16, stride LDZ, staged into
// a_s) and W_in^T (K x NI, row-major, bf16) on gemm_fwd; then epi(l0, acc)
// (the warp's TC_PB x 16 accumulators from column warp * 16), a barrier, and
// after(l0). Ends past a barrier.
template <int K, typename Epi, typename After>
__device__ void input_product(const bf16* __restrict__ dz, int nrows,
                              const bf16* __restrict__ w_t, bf16* a_s, bf16* wst, Epi epi,
                              After after) {
  constexpr int CPR = K / 8;
  for (int l0 = 0; l0 < nrows; l0 += TC_PB) {
    for (int e = threadIdx.x; e < TC_PB * CPR; e += THREADS) {
      const int r = e / CPR, q = (e % CPR) * 8;
      cp_async16(a_s + r * LDS + q, dz + static_cast<size_t>(l0 + r) * LDZ + q);
    }
    cp_async_commit();
    float acc[MT_B][NI / 64][4];
    zero_acc(acc);
    gemm_fwd<K, NI>(acc, a_s, LDS, w_t, wst);
    epi(l0, acc);
    __syncthreads();
    after(l0);
  }
  __syncthreads();
}

// The direction cotangent of a field CTA's points [p0, p0 + npts): ddirs =
// _encode_bwd of dzr0 wr0d^T, dzr0 (bf16, HR columns at stride LDZ, rows <
// cap_c) and wr0d_t = wr0d^T zero-padded to HR x NI; the chunk's DP live
// columns go through the float32 tile g_s. Starts and ends past a barrier.
__device__ inline void direction_cotangent_tc(const bf16* __restrict__ dzr0,
                                              const bf16* __restrict__ wr0d_t,
                                              const float* __restrict__ dirs, int p0, int npts,
                                              int cap_c, int real_d, float* __restrict__ ddirs,
                                              bf16* a_s, float* g_s, bf16* wst) {
  input_product<HR>(
      dzr0, cap_c, wr0d_t, a_s, wst,
      [&](int, float (&acc)[MT_B][NI / 64][4]) {
        each_pair<NI / 64>(acc, (threadIdx.x >> 5) * 16,
                     [&](int, int, int, int row, int col, float& v0, float& v1) {
                       if (col < DP) *reinterpret_cast<float2*>(g_s + row * LDG + col) =
                           make_float2(v0, v1);
                     });
      },
      [&](int l0) {
        encode_bwd_rows(g_s, dirs, static_cast<size_t>(p0 + l0), npts - l0, real_d, ddirs);
      });
}

}  // namespace nerf
