// Fused GaborNet forward render for Hopper (sm_90a): the Gabor filters from
// per-ray coefficients, the 8-stage multiplicative filter network and volume
// compositing in one kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_render_gabor.py::_fwd_kernel (the
// forward route of FusedGaborRender.__call__) in float32 mode; its bfloat16
// mode is fused_render_gabor_fwd_tc.cu, on the tensor cores. Same
// function: for every
// sample t of a ray, the filters g_i = sin(A_i + t B_i) exp(P_i + t Q_i +
// t^2 R_i) from the ray's coefficients (the prep, outside the kernel), the
// network of _mlp_tile on them and on the L_dir frequency encoding of the
// view direction, deltas from t with the 1e10 tail, one_m =
// exp(-sigma*delta), exclusive-cumprod transmittance, w = T*(1-one_m), and
// per ray rgb = sum w*c, acc = sum w, depth = sum w*t. The weights (R,S)
// leave the kernel; the filters and the (points x 256) activations never do.
//
// What bounds it on this card: operations. One sample costs 561,152 MACs at
// the real widths (7 x 256x256, 256 for the density, 256x256, 283x128,
// 128x3) and 4,096 transcendentals (a sine and an exponential per filter
// element, 8 x 256). A 1024-ray x 256-sample launch is 0.29 TFLOP of
// products; its inputs are the coefficients (40 KB per ray, 42 MB per
// launch) and t. float32 mode must be true float32 with the exact sinf
// (|A + t B| reaches hundreds of radians), so it runs on the CUDA cores
// (67 TFLOP/s).
//
// Design: as the SIREN forward (fused_render_siren_fwd.cu). A CTA owns
// whole rays and walks their samples in chunks of 64 points, activations in
// shared memory (feature-major, ping-ponged between two 256 x 68 float
// buffers), weights from L2 through a double-buffered cp.async stage, an
// 8-point x 8-column register tile per thread. A chunk of points at S = 256
// lies in one ray, at another S it may span rays: each point keeps its own
// coefficient row. A (64 x 256) filter tile would not fit in shared memory
// beside the two activation buffers, so each stage's filters are evaluated
// in that stage's gemm epilogue, in registers, from the coefficients
// (float4 loads of four columns; one ray's 40 KB stay in L1 across its
// chunks). The last stage's epilogue also sums the density row in float32
// on the unrounded z (warp shuffles). Thread 0 then runs the transmittance
// scan over the chunk in sample order, carrying T from chunk to chunk
// (render_common.cuh).
//
// The layout, the shared-memory plan, the filters and the chunk forward are
// in fused_render_gabor_common.cuh (shared with fused_render_gabor_train.cu).
// At other widths and depths (hidden 512-1024, d_pad 64, any number of
// stages) the plan of ops/cuda/gabor_plan.py comes as -D flags and sets
// the chunks, the activation tiles and the CTAs an SM
// (fused_render_gabor_common.cuh, fused_render_gabor_tc_common.cuh); the
// figures above are the default shape's (hidden 256, 8 stages).
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_render_gabor_common.cuh"

namespace {

using namespace gabor;

__global__ void __launch_bounds__(THREADS, 1)
fused_gabor_fwd_kernel(RayInputs in, Gabor gp, const float* __restrict__ wmat,
                       int rays_per_cta, float* __restrict__ rgb_out,
                       float* __restrict__ acc_out, float* __restrict__ depth_out,
                       float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* t_s = smem + SM_T;
  const float* delta_s = smem + SM_DELTA;
  const float* sig_s = smem + SM_SIGMA;
  const float* rgb_s = smem + SM_RGB;

  const int tid = threadIdx.x;
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int pt_end = ray1 * S;
  const Stash none{};
  RaySums sums;             // compositing carry (thread 0 only)

  for (int chunk0 = ray0 * S; chunk0 < pt_end; chunk0 += P) {
    const int nvalid = min(P, pt_end - chunk0);
    forward_chunk<false>(in, gp, wmat, chunk0, nvalid, smem, none, 0);
    if (tid == 0)
      composite_chunk(sums, t_s, delta_s, sig_s, rgb_s, chunk0, nvalid, S,
                      rgb_out, acc_out, depth_out, weights_out);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// `coef` holds the (5, num_rays, 8 x 256) float32 coefficients A, B, P, Q,
// R. Returns 0 on success, a cudaError_t code after a failed launch, -1
// when the packed buffers or the shapes do not fit this kernel, or -2 for
// bfloat16 (fused_render_gabor_fwd_tc.cu runs it).
int fused_gabor_fwd(const float* coef, const float* viewdirs, const float* t,
                    const void* wmat, const float* vec, int n_w, int n_b, int bf16,
                    int num_rays, int S, int rays_per_cta, int real_d,
                    float sigma_mul, float rgb_mul, float* rgb, float* acc,
                    float* depth, float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || real_d > DP)
    return -1;
  if (bf16) return -2;
  const RayInputs in{nullptr, nullptr, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Gabor gp{coef, static_cast<size_t>(num_rays) * NH, sigma_mul, rgb_mul};
  cudaError_t err = cudaFuncSetAttribute(
      fused_gabor_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_gabor_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      in, gp, static_cast<const float*>(wmat), rays_per_cta, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_gabor_fwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  if (code == -2) return "the bfloat16 forward render runs in fused_render_gabor_fwd_tc";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
