// SIREN field backward for Hopper (sm_90a): the vector-Jacobian product of
// fused_siren_fwd.cu's function, in one kernel and an in-order sum.
//
// Replaces: nerf_tpu/ops/pallas/fused_siren.py::_bwd_kernel (the custom
// VJP of make_fused_siren_apply's apply: a SIREN distillation student's
// gradient). Same function: from the cotangent of (rgb, sigma) of every
// point, recompute the forward, run _mlp_bwd_core with its input gradients,
// then _encode_bwd: the 25 float32 weight and bias gradients of the packed
// layout (fused_render_siren_common.cuh), the point cotangent dz1 w1^T (the
// rows of the three coordinates) and the direction cotangent, _encode_bwd
// of dzr0 wr0d^T with the EXACT cosine (cosf) in both modes.
//
// What bounds it on this card: operations. A point costs three times the
// forward's 561,920 MACs (the recomputed forward, the dz W^T products with
// the two input products, and the A^T dz gradient products) and 2,176
// sines and as many cosines, against 40 bytes in and 24 out a point plus
// the weights and their float32 gradients. float32 runs on the CUDA cores
// (67 TFLOP/s); bfloat16's bound is the tensor cores' 989 TFLOP/s, which
// this first version, on the CUDA cores too, stays far from.
//
// Design (that of fused_render_siren_train.cu, without the compositing):
//   1. A CTA owns a run of points (the wrapper gives about one run an SM,
//      a multiple of the 64-point chunk) and runs their forward chunk by
//      chunk (load_point_chunk + mlp_chunk), stashing per point in its
//      scratch area in device memory each layer's output and cos(w0 z) (the
//      sine's derivative, from the forward's own argument: the TPU kernel
//      keeps the eight pre-activations and takes sin and cos again), feat,
//      y, denc, sigma_pre, rgb and the rounded points (~20.8 KB a point).
//   2. One thread a point: the sigmoid's and the density ReLU's backward
//      from the given cotangent into the per-point columns.
//   3. The MLP backward over all the CTA's points, the SIREN train kernel's
//      own (fused_render_siren_common.cuh::mlp_backward); once dzr0 is
//      complete, one thread a (point, coordinate) takes the direction
//      cotangent: the encoding columns' cotangents dzr0 wr0d^T (dzr0
//      rounded to bf16 in bfloat16 mode, float32 sums over the 128 columns)
//      and dx = g_x + sum_c g_c cos(2^j x + phase) 2^j.
//   4. One thread a (point, coordinate): the point cotangent dz1 w1^T over
//      the 256 columns (dz1 rounded in bfloat16 mode).
//   5. A second small kernel adds the per-CTA gradient partials in CTA
//      order. Nothing is atomic, so a step is deterministic from run to run.
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_render_siren_common.cuh"

namespace {

using namespace siren;

template <bool BF16, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
siren_field_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ cot, const float* __restrict__ vec,
                       const WT* __restrict__ wmat, const WT* __restrict__ wmat_t,
                       Siren sp, int n, int pts_per_cta, int cap, int real_d,
                       float* __restrict__ scratch, float* __restrict__ partial,
                       float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int p_begin = blockIdx.x * pts_per_cta;
  const int p_end = min(p_begin + pts_per_cta, n);
  if (p_begin >= p_end) return;
  const int npts = p_end - p_begin;
  const int cap_c = (npts + P - 1) / P * P;
  const size_t cz = static_cast<size_t>(cap);
  Scratch sc = carve(scratch + static_cast<size_t>(blockIdx.x) * cz * FLOATS_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = sc.cols;

  // ---- 1. forward, stashing what the backward needs ----
  for (int c0 = 0; c0 < npts; c0 += P) {
    load_point_chunk<BF16>(pts, dirs, p_begin + c0, min(P, npts - c0), real_d, smem);
    mlp_chunk<BF16, true>(vec, wmat, sp, smem, sc.st, static_cast<size_t>(c0));
  }

  // ---- 2. the heads' backward: dzr1 = ((g_rgb r) (1 - r)) rgb_mul, dsig =
  //      g_sigma sigma_mul where sigma_pre > 0; zero past the CTA's points ----
  for (int l = tid; l < cap_c; l += THREADS) {
    float dz[3] = {0.f, 0.f, 0.f};
    float ds = 0.f;
    if (l < npts) {
      const float* g = cot + static_cast<size_t>(p_begin + l) * 4;
      for (int c = 0; c < 3; ++c) {
        const float r = cols[(C_RGB + c) * cz + l];
        dz[c] = ((g[c] * r) * (1.f - r)) * sp.rgb_mul;
      }
      ds = cols[C_SIGP * cz + l] > 0.f ? g[3] * sp.sigma_mul : 0.f;
    }
    for (int c = 0; c < 3; ++c) cols[(C_DZR1 + c) * cz + l] = dz[c];
    cols[C_DSIG * cz + l] = ds;
  }
  if (tid == 0) part[N_TOT] = 0.f;
  __syncthreads();

  // ---- 3. MLP backward; the direction cotangent from dzr0 ----
  auto direction = [&](const float* dzr0) {
    direction_cotangent<BF16>(dzr0, wmat + OFF_WR0D, dirs, p_begin, npts, real_d, ddirs);
  };
  const float* dz1 =
      mlp_backward<BF16>(sc, cz, vec, wmat, wmat_t, sp, part, cap_c, smem,
                         direction);

  // ---- 4. the point cotangent dz1 w1^T ----
  for (int idx = tid; idx < npts * 3; idx += THREADS) {
    const int l = idx / 3, k = idx % 3;
    const float* row = dz1 + static_cast<size_t>(l) * LDZ;
    float s = 0.f;
    for (int c = 0; c < H; ++c) {
      const float v = BF16 ? round_bf16(row[c]) : row[c];
      s = fmaf(v, load1(wmat + OFF_W1 + k * H + c), s);
    }
    dpts[static_cast<size_t>(p_begin + l) * 3 + k] = s;
  }
}

template <bool BF16, typename WT>
int launch(const float* pts, const float* dirs, const float* cot, const float* vec,
           const void* wmat, const void* wmat_t, const Siren& sp, int n,
           int pts_per_cta, int cap, int real_d, float* scratch, float* partial,
           float* out, float* dpts, float* ddirs, cudaStream_t stream) {
  auto kernel = siren_field_bwd_kernel<BF16, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + pts_per_cta - 1) / pts_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      pts, dirs, cot, vec, static_cast<const WT*>(wmat), static_cast<const WT*>(wmat_t),
      sp, n, pts_per_cta, cap, real_d, scratch, partial, dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, stream>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the caller allocates: scratch floats per stashed point, floats per
// CTA partial, floats of the output (the gradients, then a zero).
void siren_field_bwd_sizes(int* per_point, int* npart, int* n_out) {
  *per_point = FLOATS_PER_POINT;
  *npart = NPART;
  *n_out = N_TOT + 1;
}

// `cot` is the (n, 4) cotangent [g_rgb, g_sigma]; `wmat_t` the packed
// matrices transposed (same offsets). `scratch` holds grid * cap *
// per_point floats, `partial` grid * npart, `out` n_out, where grid =
// ceil(n / pts_per_cta) and cap >= ceil(pts_per_cta / 64) * 64 is a
// multiple of 64. Writes the gradients to `out` and the point and direction
// cotangents (n, 3) each. Returns 0 on success, a cudaError_t code after a
// failed launch, or -1 when the packed buffers or the shapes do not fit
// this kernel.
int siren_field_bwd(const float* pts, const float* dirs, const float* cot,
                    const void* wmat, const void* wmat_t, const float* vec, int n_w,
                    int n_b, int bf16, int n, int pts_per_cta, int cap, int real_d,
                    float w0, float w0h, float sigma_mul, float rgb_mul,
                    float* scratch, float* partial, float* out, float* dpts,
                    float* ddirs, void* stream) {
  if (n_w != N_W || n_b != N_B || n <= 0 || pts_per_cta <= 0 || cap % P != 0 ||
      cap < (pts_per_cta + P - 1) / P * P || real_d < 3 || real_d > DP)
    return -1;
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, __nv_bfloat16>(pts, dirs, cot, vec, wmat, wmat_t, sp, n,
                                       pts_per_cta, cap, real_d, scratch, partial, out,
                                       dpts, ddirs, s);
  return launch<false, float>(pts, dirs, cot, vec, wmat, wmat_t, sp, n, pts_per_cta,
                              cap, real_d, scratch, partial, out, dpts, ddirs, s);
}

const char* siren_field_bwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
