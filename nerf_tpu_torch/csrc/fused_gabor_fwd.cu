// GaborNet field forward for Hopper (sm_90a): the filter banks evaluated at
// given points and the multiplicative filter network, in one kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_gabor.py::_fwd_kernel (the forward of
// make_fused_gabor_apply's apply: the occupancy bake of a served GaborNet, a
// GaborNet distillation teacher and student) in float32 mode; its bfloat16
// mode is fused_gabor_fwd_tc.cu, on the tensor cores. Same function: for every
// point x and stage i the filters
//   g_i = sin(x . omega_i + phi_i) * exp(-gamma_i/2 (|x|^2 - 2 x . mu_i + |mu_i|^2))
// (_filters_from_points: the expansion, with |x|^2 from the unrounded point
// and x rounded to bf16 in bfloat16 mode as _mm rounds pts8; the banks stay
// float32, as _cast_weights casts only the w* matrices), then
// z_1 = g_1, z_{i+1} = (z_i W_i + b_i) * g_{i+1}, the density
// relu(z_8 . ws + bs) * sigma_mul in float32 from the unrounded z_8, the
// remap, and the relu rgb head on [feat, denc] with denc the frequency
// encoding of the direction through the exact sine. The TPU packs rgb and
// sigma into an (N, 8) row; here rgb (N, 3) and sigma (N,) leave the kernel.
//
// What bounds it on this card: operations. A point costs 573,440 MACs at
// hidden 256 (the render's 561,152 plus the filters' two 3-long products a
// filter element) and 4,096 transcendentals (a sine and an exponential a
// filter element), against 24 bytes in and 16 out, so 65,536 points (one
// chunk of the occupancy bake) are 75 GFLOP against 2.6 MB. float32 runs
// on the CUDA cores (67 TFLOP/s).
//
// Design: one CTA of 256 threads per 64-point chunk; the last chunk is
// ragged and its missing points get zero filters. load_point_chunk puts the
// chunk's rounded points, their |x|^2 and the direction encoding in shared
// memory; the network is the GaborNet render kernels' own
// (fused_render_gabor_common.cuh::mlp_chunk: activations feature-major in
// two shared buffers, weights streamed from L2 through a double-buffered
// cp.async stage, an 8 x 8 register tile a thread), with each stage's
// filters evaluated in its gemm's epilogue from the point itself
// (PointFilters: two 3-long products, expf and the sine a filter element;
// the banks are 72 KB and stay in L1/L2) instead of from per-ray
// coefficients. Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a
// shared library with a plain C interface (loaded by ctypes).
//
// At other widths and depths (hidden 512-1024, d_pad 64, any number of
// stages) the plan of ops/cuda/gabor_plan.py comes as -D flags and sets
// the chunks, the activation tiles and the CTAs an SM
// (fused_render_gabor_common.cuh, fused_render_gabor_tc_common.cuh); the
// figures above are the default shape's (hidden 256, 8 stages).

#include "fused_render_gabor_common.cuh"

namespace {

using namespace gabor;

__global__ void __launch_bounds__(THREADS, 1)
gabor_field_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ vec, const float* __restrict__ wmat,
                       const float* __restrict__ fpack, float sigma_mul,
                       float rgb_mul, int n, int real_d, float* __restrict__ rgb_out,
                       float* __restrict__ sigma_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* sig_s = smem + SM_SIGMA;
  const float* rgb_s = smem + SM_RGB;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const int nvalid = min(P, n - p0);
  const Stash none{};

  load_point_chunk<false>(pts, dirs, p0, nvalid, real_d, smem);
  const PointFilters<false> filt{fpack, smem + SM_X, nvalid};
  mlp_chunk<false, false>(vec, wmat, sigma_mul, rgb_mul, filt, smem, none, 0);
  if (tid < nvalid) sigma_out[p0 + tid] = sig_s[tid];
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    if (p < nvalid) rgb_out[static_cast<size_t>(p0 + p) * 3 + c] = rgb_s[c * P + p];
  }
}

int launch(const float* pts, const float* dirs, const float* vec, const void* wmat,
           const float* fpack, float sigma_mul, float rgb_mul, int n, int real_d,
           float* rgb, float* sigma, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gabor_field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  gabor_field_fwd_kernel<<<(n + P - 1) / P, THREADS, SMEM_BYTES, stream>>>(
      pts, dirs, vec, static_cast<const float*>(wmat), fpack, sigma_mul, rgb_mul, n,
      real_d, rgb, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rgb (n, 3) and sigma (n,) of the points (n, 3) and directions (n, 3);
// `fpack` holds the filter banks (N_F floats, F_* layout). Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 when the packed
// buffers or the shapes do not fit this kernel. float32 only: the bfloat16
// forward is fused_gabor_fwd_tc.cu's.
int gabor_field_fwd(const float* pts, const float* dirs, const void* wmat,
                    const float* vec, const float* fpack, int n_w, int n_b, int n_f,
                    int n, int real_d, float sigma_mul, float rgb_mul,
                    float* rgb, float* sigma, void* stream) {
  if (n_w != N_W || n_b != N_B || n_f != N_F || n <= 0 || real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(pts, dirs, vec, wmat, fpack, sigma_mul, rgb_mul, n, real_d, rgb, sigma, s);
}

const char* gabor_field_fwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
