// NeRF field backward for Hopper (sm_90a): the vector-Jacobian product of
// fused_nerf_fwd.cu's function, in one kernel and an in-order sum.
//
// Replaces: nerf_tpu/ops/pallas/fused_nerf.py::_bwd_kernel (the custom VJP
// of make_fused_nerf_apply's apply: a NeRF distillation student's
// gradient). Same function: from the cotangent of (rgb, sigma) of every
// point, recompute the forward (_forward_tile), run _mlp_bwd_core with its
// input gradients, then _encode_bwd: the 28 float32 weight and bias
// gradients of the packed layout (fused_render_common.cuh), and the point
// and direction cotangents (N, 3) each. _encode_bwd takes the EXACT cosine
// in both modes (cosf here), as the TPU kernel does.
//
// What bounds it on this card: operations. A point costs three times the
// forward's 658,944 MACs (the recomputed forward, the dz W^T products with
// the three input products dz1 w1^T, dz6 w6p^T and dzr0 wr0d^T, and the
// A^T dz gradient products), against 40 bytes in and 24 out a point plus
// the weights and their float32 gradients. float32 runs on the CUDA cores
// (67 TFLOP/s); bfloat16's bound is the tensor cores' 989 TFLOP/s, which
// this first version, on the CUDA cores too, stays far from.
//
// Design (that of fused_render_train.cu, without the compositing):
//   1. A CTA owns a run of points (the wrapper gives about one run an SM,
//      a multiple of the 64-point chunk) and runs their forward chunk by
//      chunk (encode_point_chunk + mlp_chunk), stashing every activation
//      point-major in its scratch area in device memory (~14 KB a point).
//   2. One thread a point: the sigmoid's and the density ReLU's backward
//      from the given cotangent into the per-point columns.
//   3. The MLP backward over all the CTA's points, the render train
//      kernels' own (fused_render_common.cuh::mlp_backward), with its
//      input products: dz6 w6p^T and dzr0 wr0d^T into a third dz buffer,
//      dz1 w1^T into a free one, on the same register-tiled gemm against
//      transposed, zero-padded matrices.
//   4. One thread a coordinate: the encodings' backward, dx = g_x +
//      sum_c g_c cos(2^j x + phase) 2^j over the coordinate's columns.
//   5. A second small kernel adds the per-CTA gradient partials in CTA
//      order. Nothing is atomic, so a step is deterministic from run to run.
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_render_common.cuh"

namespace {

using namespace nerf;

constexpr int FLOATS_PER_POINT = floats_per_point<3>();

template <bool BF16, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
fused_nerf_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                      const float* __restrict__ cot, const float* __restrict__ vec,
                      const WT* __restrict__ wmat, const WT* __restrict__ wmat_t,
                      const WT* __restrict__ wt_in, int n, int pts_per_cta, int cap,
                      int real_p, int real_d, float* __restrict__ scratch,
                      float* __restrict__ partial, float* __restrict__ dpts,
                      float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int p_begin = blockIdx.x * pts_per_cta;
  const int p_end = min(p_begin + pts_per_cta, n);
  if (p_begin >= p_end) return;
  const int npts = p_end - p_begin;
  const int cap_c = (npts + P - 1) / P * P;
  const size_t cz = static_cast<size_t>(cap);
  Scratch sc = carve<3>(scratch + static_cast<size_t>(blockIdx.x) * cz * FLOATS_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = sc.cols;

  // ---- 1. forward, stashing every activation ----
  for (int c0 = 0; c0 < npts; c0 += P) {
    encode_point_chunk<BF16>(pts, dirs, p_begin + c0, min(P, npts - c0), real_p, real_d,
                             smem);
    mlp_chunk<BF16, true>(vec, wmat, smem, sc.st, static_cast<size_t>(c0));
  }

  // ---- 2. the heads' backward: dzr1 = g_rgb r (1 - r), dsig = g_sigma
  //      where sigma_pre > 0; zero on the rows past the CTA's points ----
  for (int l = tid; l < cap_c; l += THREADS) {
    float dz[3] = {0.f, 0.f, 0.f};
    float ds = 0.f;
    if (l < npts) {
      const float* g = cot + static_cast<size_t>(p_begin + l) * 4;
      for (int c = 0; c < 3; ++c) {
        const float r = cols[(C_RGB + c) * cz + l];
        dz[c] = (g[c] * r) * (1.f - r);
      }
      ds = cols[C_SIGP * cz + l] > 0.f ? g[3] : 0.f;
    }
    for (int c = 0; c < 3; ++c) cols[(C_DZR1 + c) * cz + l] = dz[c];
    cols[C_DSIG * cz + l] = ds;
  }
  if (tid == 0) part[N_TOT] = 0.f;
  __syncthreads();

  // ---- 3. MLP backward with the input products ----
  mlp_backward<BF16, true>(sc, cz, vec, wmat, wmat_t, wt_in, part, cap_c, smem);

  // ---- 4. the encodings' backward (_encode_bwd, exact cosine) ----
  const float* dx6 = sc.dz[2];        // dz6 w6p^T | dzr0 wr0d^T
  const float* dx1 = sc.dz[1];        // dz1 w1^T
  for (int idx = tid; idx < npts * 6; idx += THREADS) {
    const int l = idx / 6, k = idx % 6;
    const bool pos = k < 3;
    const int d = pos ? k : k - 3;
    const size_t row = static_cast<size_t>(l) * LDZ;
    const size_t at = static_cast<size_t>(p_begin + l) * 3 + d;
    const float x = pos ? pts[at] : dirs[at];
    // the cotangent of encoding column c: dpenc = dz6 w6p^T + dz1 w1^T
    auto g = [&](int c) { return pos ? dx6[row + c] + dx1[row + c] : dx6[row + HR + c]; };
    float s = 0.f;
    for (int c = 3 + d; c < (pos ? real_p : real_d); c += 3) {
      const int j = (c - 3) / 6;
      const float phase = (((c - 3) / 3) & 1) ? HALF_PI : 0.f;
      const float scale = static_cast<float>(1 << j);
      const float arg = __fadd_rn(__fmul_rn(x, scale), phase);
      s = fmaf(g(c) * cosf(arg), scale, s);
    }
    (pos ? dpts : ddirs)[at] = g(d) + s;
  }
}

template <bool BF16, typename WT>
int launch(const float* pts, const float* dirs, const float* cot, const float* vec,
           const void* wmat, const void* wmat_t, const void* wt_in, int n,
           int pts_per_cta, int cap, int real_p, int real_d, float* scratch,
           float* partial, float* out, float* dpts, float* ddirs, cudaStream_t stream) {
  auto kernel = fused_nerf_bwd_kernel<BF16, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + pts_per_cta - 1) / pts_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      pts, dirs, cot, vec, static_cast<const WT*>(wmat), static_cast<const WT*>(wmat_t),
      static_cast<const WT*>(wt_in), n, pts_per_cta, cap, real_p, real_d, scratch,
      partial, dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, stream>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the caller allocates: scratch floats per stashed point, floats per
// CTA partial, floats of the output (the gradients, then a zero), and the
// length of the input-product matrix buffer.
void fused_nerf_bwd_sizes(int* per_point, int* npart, int* n_out, int* n_t_in) {
  *per_point = FLOATS_PER_POINT;
  *npart = NPART;
  *n_out = N_TOT + 1;
  *n_t_in = N_T_IN;
}

// `cot` is the (n, 4) cotangent [g_rgb, g_sigma]; `wmat_t` the packed
// matrices transposed (same offsets), `wt_in` w1^T, w6p^T and wr0d^T each
// zero-padded to 128 columns. `scratch` holds grid * cap * per_point floats,
// `partial` grid * npart, `out` n_out, where grid = ceil(n / pts_per_cta)
// and cap >= ceil(pts_per_cta / 64) * 64 is a multiple of 64. Writes the
// gradients to `out` and the point and direction cotangents (n, 3) each.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_nerf_bwd(const float* pts, const float* dirs, const float* cot,
                   const void* wmat, const void* wmat_t, const void* wt_in,
                   const float* vec, int n_w, int n_b, int n_t, int bf16, int n,
                   int pts_per_cta, int cap, int real_p, int real_d, float* scratch,
                   float* partial, float* out, float* dpts, float* ddirs,
                   void* stream) {
  if (n_w != N_W || n_b != N_B || n_t != N_T_IN || n <= 0 || pts_per_cta <= 0 ||
      cap % P != 0 || cap < (pts_per_cta + P - 1) / P * P || real_p < 3 ||
      real_p > PP || real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, __nv_bfloat16>(pts, dirs, cot, vec, wmat, wmat_t, wt_in, n,
                                       pts_per_cta, cap, real_p, real_d, scratch,
                                       partial, out, dpts, ddirs, s);
  return launch<false, float>(pts, dirs, cot, vec, wmat, wmat_t, wt_in, n, pts_per_cta,
                              cap, real_p, real_d, scratch, partial, out, dpts, ddirs, s);
}

const char* fused_nerf_bwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
