// KiloNeRF field backward for Hopper (sm_90a): the gradient of every
// network's parameters from the (rgb, sigma) cotangent of its points.
//
// Replaces: nerf_tpu/ops/pallas/fused_kilonerf.py::_bwd_kernel_mk (the
// backward of make_fused_kilonerf_apply) in float32; bfloat16 runs on the
// tensor cores (fused_kilonerf_bwd_tc.cu), and this entry refuses it. Same
// function: recompute each point's forward, push the cotangent back through
// rgb2, rgb1, the trunk and its density row, l2 and l1 (ReLU masks from the
// forward), and sum each network's weight and bias gradients over its
// points, in float32 (the TPU kernel's `mmT` and `acc_row`). Positions and
// directions get no gradient (the JAX VJP returns zeros for them).
//
// What bounds it on this card: operations. Three times the forward's 6,080
// MACs a point (the recompute, the cotangent products dz W^T, the gradient
// products A^T dz), 9.6 GFLOP at 262,144 points: 0.14 ms on the float32
// CUDA cores; the bytes are the payload and cotangent in, the weights in
// and the gradients out (38 MB, 11 us).
//
// Design:
//   * no float atomics, so a step is deterministic (chip_smoke.py checks a
//     bit-identical resume): a CTA owns a piece of at most 512 sorted points
//     of one network and writes its own partial of that network's
//     gradients; a second kernel adds each network's partials in piece
//     order and writes zeros for a network without points
//     (fused_kilonerf_common.cuh::fused_kilonerf_reduce_kernel);
//   * per 128-point sub-tile, phase A takes one point per thread: the
//     forward and the cotangent chain in registers, the activations (A) and
//     cotangents (Z) the gradient products need into that point's rows of
//     shared memory; phase B forms the gradient products over the
//     sub-tile, each thread owning fixed (row, column) entries of the
//     network's gradient in registers across the piece (a lane per column,
//     a warp per block of rows: the A values are warp broadcasts, four per
//     load; the Z values one per lane);
//   * weights 25.8 KB + A and Z rows 184 KB: 210 KB of shared memory, one
//     CTA of 4 warps per SM. A skewed scene makes more pieces of one
//     network, each a CTA; its partials add in the second kernel.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_kilonerf_common.cuh"

namespace {

using namespace kilo;

constexpr int THREADS = 128;          // points per sub-tile: one per thread
constexpr int WARPS = THREADS / 32;
constexpr int SUBTILES = 4;
constexpr int PIECE = THREADS * SUBTILES;

// One point's cotangent row in shared memory (floats), unrounded.
constexpr int Z_DZ1 = 0;
constexpr int Z_DZ2 = 32;
constexpr int Z_DFEAT = 64;
constexpr int Z_DZY = 96;
constexpr int Z_DZR2 = 128;           // 3
constexpr int Z_DSIG = 131;
constexpr int Z_STRIDE = 132;         // 33 float4s: distinct banks per row

constexpr int SMEM_FLOATS = NW + THREADS * (A_STRIDE + Z_STRIDE);
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;  // 210,080

// Rows of the gradient each warp owns, by block: l1 (PMAX/WARPS), then
// l2, trunk features, rgb1 feature rows, rgb1 direction rows (H/WARPS
// each). The biases, the density row, rgb2 and its bias are spread over
// the warps (`extra`).
constexpr int R1 = PMAX / WARPS;      // 16
constexpr int RH = H / WARPS;         // 8

// Phase A: one point through the forward and back to dz1, its A and Z rows
// written. `g` is its (rgb, sigma) cotangent.
__device__ __forceinline__ void point_backward(const float* __restrict__ w, const float* loc,
                                               const float* dir, float4 g, const Dims& dims,
                                               float* arow, float* zrow) {
  float rgb[3], sigma_pre;
  unsigned mask_x1, mask_y;
  point_forward<true>(w, loc, dir, dims, arow, rgb, sigma_pre, mask_x1, mask_y);
  const float gr[3] = {g.x, g.y, g.z};
  float dzr2[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) dzr2[m] = gr[m] * rgb[m] * (1.0f - rgb[m]);
  const float dsig = sigma_pre > 0.0f ? g.w : 0.0f;
  store4(zrow + Z_DZR2, dzr2[0], dzr2[1], dzr2[2], dsig);
  const float r0 = dzr2[0], r1 = dzr2[1], r2 = dzr2[2];

  float dz[H], rz[H];
  // through rgb2 and the ReLU of y
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float4 wr = *reinterpret_cast<const float4*>(w + S_WR2 + 4 * k);
    const float dy = fmaf(r2, wr.z, fmaf(r1, wr.y, r0 * wr.x));
    dz[k] = (mask_y >> k) & 1u ? dy : 0.0f;
  }
  store32(zrow + Z_DZY, dz);
  // through rgb1's feature rows: dfeat = dzy Wr1f^T
#pragma unroll
  for (int j = 0; j < H; ++j) rz[j] = dz[j];
#pragma unroll
  for (int k = 0; k < H; ++k) dz[k] = dot_row(rz, w + S_WR1F + k * H);
  store32(zrow + Z_DFEAT, dz);
  // through the trunk (features and density row) and the ReLU of x2
#pragma unroll
  for (int j = 0; j < H; ++j) rz[j] = dz[j];
#pragma unroll
  for (int k = 0; k < H; k += 4) {
    const float4 x2 = *reinterpret_cast<const float4*>(arow + A_X2 + k);
    const float xs[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float dx2 = dot_row(rz, w + S_WTF + (k + u) * H) + dsig * w[S_WTS + k + u];
      dz[k + u] = xs[u] > 0.0f ? dx2 : 0.0f;
    }
  }
  store32(zrow + Z_DZ2, dz);
  // through l2 and the ReLU of x1
#pragma unroll
  for (int j = 0; j < H; ++j) rz[j] = dz[j];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float dx1 = dot_row(rz, w + S_W2 + k * H);
    dz[k] = (mask_x1 >> k) & 1u ? dx1 : 0.0f;
  }
  store32(zrow + Z_DZ1, dz);
}

// acc[0..4*N4-1] += a[0..4*N4-1] * z, with `a` a float4-aligned row of
// shared memory read as a warp broadcast.
template <int N4>
__device__ __forceinline__ void gemm_rows(float* acc, const float* a, float z) {
#pragma unroll
  for (int q = 0; q < N4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(a + 4 * q);
    acc[4 * q + 0] = fmaf(v.x, z, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v.y, z, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v.z, z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v.w, z, acc[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_kilonerf_bwd_kernel(const float4* __restrict__ pay, const float4* __restrict__ cot,
                          const int* __restrict__ offsets, const int* __restrict__ run_end,
                          int g3, const float* __restrict__ wpack, Dims dims,
                          float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  float* sA = w + NW;
  float* sZ = sA + THREADS * A_STRIDE;
  int g, start, end;
  if (!find_run(blockIdx.x, run_end, offsets, g3, PIECE, g, start, end)) return;
  stage_weights(w, wpack + static_cast<size_t>(g) * dims.R, dims);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float a1[R1], a2[RH], atf[RH], ar1f[RH], ar1d[RH], ex[3];
#pragma unroll
  for (int i = 0; i < R1; ++i) a1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < RH; ++i) a2[i] = atf[i] = ar1f[i] = ar1d[i] = 0.0f;
  ex[0] = ex[1] = ex[2] = 0.0f;
  // warp 3's rgb2 entries e = row * 32 + lane: matrix row e / 3, column e % 3
  int wr2_k[3], wr2_m[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    wr2_k[r] = (r * 32 + lane) / 3;
    wr2_m[r] = (r * 32 + lane) % 3;
  }

  for (int s0 = start; s0 < end; s0 += THREADS) {
    const int nt = min(THREADS, end - s0);
    if (tid < nt) {
      const int i = s0 + tid;
      const float4 a = pay[2 * i], b = pay[2 * i + 1];
      const float loc[3] = {a.x, a.y, a.z};
      const float dir[3] = {b.x, b.y, b.z};
      point_backward(w, loc, dir, cot[i], dims, sA + tid * A_STRIDE,
                           sZ + tid * Z_STRIDE);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float* A = sA + t * A_STRIDE;
      const float* Z = sZ + t * Z_STRIDE;
      const float dz1 = Z[Z_DZ1 + lane], dz2 = Z[Z_DZ2 + lane];
      const float dfeat = Z[Z_DFEAT + lane], dzy = Z[Z_DZY + lane];
      gemm_rows<R1 / 4>(a1, A + A_PENC + R1 * warp, dz1);
      gemm_rows<RH / 4>(a2, A + A_X1 + RH * warp, dz2);
      gemm_rows<RH / 4>(atf, A + A_X2 + RH * warp, dfeat);
      gemm_rows<RH / 4>(ar1f, A + A_FEAT + RH * warp, dzy);
      gemm_rows<RH / 4>(ar1d, A + A_DENC + RH * warp, dzy);
      if (warp == 0) {          // b1, b2
        ex[0] += dz1;
        ex[1] += dz2;
      } else if (warp == 1) {   // btf, br1
        ex[0] += dfeat;
        ex[1] += dzy;
      } else if (warp == 2) {   // density row (unrounded x2 * dsigma); br2, bts
        const float dsig = Z[Z_DSIG];
        ex[0] = fmaf(A[A_X2 + lane], dsig, ex[0]);
        ex[1] += lane < 3 ? Z[Z_DZR2 + lane] : (lane == 3 ? dsig : 0.0f);
      } else {                  // rgb2
#pragma unroll
        for (int r = 0; r < 3; ++r)
          ex[r] = fmaf(A[A_Y + wr2_k[r]], Z[Z_DZR2 + wr2_m[r]], ex[r]);
      }
    }
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * NW;
#pragma unroll
  for (int i = 0; i < R1; ++i) out[S_W1 + (R1 * warp + i) * H + lane] = a1[i];
#pragma unroll
  for (int i = 0; i < RH; ++i) {
    const int row = RH * warp + i;
    out[S_W2 + row * H + lane] = a2[i];
    out[S_WTF + row * H + lane] = atf[i];
    out[S_WR1F + row * H + lane] = ar1f[i];
    out[S_WR1D + row * H + lane] = ar1d[i];
  }
  if (warp == 0) {
    out[S_B1 + lane] = ex[0];
    out[S_B2 + lane] = ex[1];
  } else if (warp == 1) {
    out[S_BTF + lane] = ex[0];
    out[S_BR1 + lane] = ex[1];
  } else if (warp == 2) {
    out[S_WTS + lane] = ex[0];
    if (lane < 3) out[S_BR2 + lane] = ex[1];
    if (lane == 3) out[S_BTS] = ex[1];
  } else {
#pragma unroll
    for (int r = 0; r < 3; ++r) out[S_WR2 + 4 * wr2_k[r] + wr2_m[r]] = ex[r];
  }
}

int launch(const float* pay, const float* cot, const int* offsets, const int* run_end,
           int g3, const void* wpack, const Dims& dims, int grid, float* partial,
           float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_kilonerf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kilonerf_bwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      reinterpret_cast<const float4*>(pay), reinterpret_cast<const float4*>(cot),
      offsets, run_end, g3, static_cast<const float*>(wpack), dims, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kilonerf_reduce_kernel<<<g3, 256, 0, stream>>>(partial, run_end, dims, out);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// Floats of one piece's partial gradient (the shared-memory layout).
int fused_kilonerf_partial_floats() { return NW; }

// `pay` and `offsets` as for fused_kilonerf_fwd; `cot` the sorted (n, 4)
// float32 cotangent of (rgb, sigma); `run_end` the running count of
// `run`-point pieces; `partial` (grid, fused_kilonerf_partial_floats())
// float32 scratch; `out` the (g3, R) float32 gradient in the packed
// layout. Returns 0 on success, a cudaError_t code after a failed launch,
// -1 when the widths or shapes do not fit this kernel, or -2 for bfloat16
// (`bf16` 1), which runs on the tensor cores (fused_kilonerf_bwd_tc.cu).
int fused_kilonerf_bwd(const float* pay, const float* cot, const int* offsets,
                       const int* run_end, int g3, const void* wpack, int R, int P, int D,
                       int hidden, int bf16, int n, int run, int grid, float* partial,
                       float* out, void* stream) {
  if (hidden != H || P > PMAX || D > DMAX || P < 3 || D < 3 ||
      R != packed_size(P, D) || g3 <= 0 || n <= 0 || run != PIECE || grid <= 0)
    return -1;
  if (bf16) return -2;
  const Dims dims{P, D, R};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(pay, cot, offsets, run_end, g3, wpack, dims, grid, partial, out, s);
}

const char* fused_kilonerf_bwd_error(int code) {
  if (code == -1) return "widths or shapes do not fit the kernel (hidden 32, encodings "
                         "of at most 64 / 32 columns, 512-point pieces)";
  if (code == -2) return "bfloat16 runs on the tensor cores (fused_kilonerf_bwd_tc)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
