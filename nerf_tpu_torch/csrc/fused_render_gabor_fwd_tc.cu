// Fused GaborNet forward render in bfloat16 on Hopper's tensor cores
// (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render_gabor.py::_fwd_kernel (the
// forward route of FusedGaborRender.__call__) in bfloat16 mode. Same
// function as fused_render_gabor_fwd.cu, which keeps the float32 mode: for
// every sample t of a ray, the filters g_i = sin(A_i + t B_i) exp(P_i + t
// Q_i + t^2 R_i) from the ray's coefficients (the prep, outside the
// kernel), the network of _mlp_tile on them and on the L_dir frequency
// encoding of the view direction, then compositing: deltas from t with the
// 1e10 tail, one_m = exp(-sigma*delta), exclusive-cumprod transmittance,
// w = T*(1-one_m), and per ray rgb = sum w*c, acc = sum w, depth = sum w*t.
// The weights (R,S) leave the kernel; the filters and the (points x 256)
// activations never do.
//
// What bounds it on this card: operations. One sample costs 561,152 MACs
// (0.297 ms at 1024 rays x 256 samples on the tensor cores' 989 TFLOP/s in
// bf16) and 4,096 transcendentals, a sine and an exponential per filter
// element (about 20 CUDA-core instructions each, with the filter's own
// arithmetic: about as long again as the products, at the CUDA cores'
// instruction rate). The kernel it replaced in bf16
// (fused_render_gabor_fwd.cu, every product an fp32 FMA on the CUDA cores)
// took 10.264 ms there on an NVIDIA H100 80GB HBM3 at 700 W, 0.029 of the
// bound.
//
// Design: a CTA owns whole rays and walks their samples in chunks of 64
// points; two CTAs share an SM, so that one CTA's filter epilogues and
// compositing (CUDA cores) overlap the other's products (tensor cores).
// Each chunk runs the GaborNet chain on the tensor cores
// (fused_render_gabor_tc_common.cuh::forward_chunk_gabor_tc, shared with the
// bf16 train pass, fused_render_gabor_train_tc.cu, so the two give the same
// rgb, acc and weights bit for bit): every product on render_tc.cuh's
// gemm_fwd, the filters evaluated in its epilogue from the ray's
// coefficients. After a chunk the density and colour of its points sit in
// shared-memory columns, and thread 0 runs the compositing scan over them in
// sample order, carrying T from chunk to chunk
// (render_common.cuh::composite_chunk).
//
// At other widths and depths (hidden 512-1024, d_pad 64, any number of
// stages) the plan of ops/cuda/gabor_plan.py comes as -D flags and sets
// the chunks, the activation tiles and the CTAs an SM
// (fused_render_gabor_common.cuh, fused_render_gabor_tc_common.cuh); the
// figures above are the default shape's (hidden 256, 8 stages).
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_gabor_tc_common.cuh"

namespace gabor {
namespace {

__global__ void __launch_bounds__(THREADS, 2)
fused_gabor_fwd_tc_kernel(RayInputs in, Gabor gp, const bf16* __restrict__ wmat, int rays_per_cta,
                          float* __restrict__ rgb_out, float* __restrict__ acc_out,
                          float* __restrict__ depth_out, float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  const GSmem sm = carve_gsmem(reinterpret_cast<unsigned char*>(smem4));
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash none{};
  RaySums sums;             // compositing carry (thread 0 only)
  for (int c0 = 0; c0 < npts; c0 += TC_P) {
    const int chunk0 = ray0 * S + c0, nvalid = min(TC_P, npts - c0);
    forward_chunk_gabor_tc<false>(in, gp, wmat, chunk0, nvalid, sm, none, 0, 0);
    if (threadIdx.x == 0)
      composite_chunk(sums, sm.col + GC_T * TC_P, sm.col + GC_DELTA * TC_P,
                      sm.col + GC_SIGMA * TC_P, sm.col + GC_RGB * TC_P, chunk0, nvalid, S,
                      rgb_out, acc_out, depth_out, weights_out, TC_P);
    __syncthreads();
  }
}

int launch_fwd_tc(const float* coef, const float* viewdirs, const float* t, const void* wmat,
                  const float* vec, int n_w, int n_b, int is_bf16, int num_rays, int S,
                  int rays_per_cta, int real_d, float sigma_mul, float rgb_mul, float* rgb,
                  float* acc, float* depth, float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || is_bf16 != 1 || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || real_d > DP)
    return -1;
  const RayInputs in{nullptr, nullptr, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Gabor gp{coef, static_cast<size_t>(num_rays) * NH, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gabor_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_GABOR_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_gabor_fwd_tc_kernel<<<grid, THREADS, SMEM_GABOR_TC, s>>>(
      in, gp, static_cast<const bf16*>(wmat), rays_per_cta, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gabor

extern "C" {

// The bf16 forward render. `coef` holds the (5, num_rays, 8 x 256) float32
// coefficients A, B, P, Q, R; the arguments are those of fused_gabor_fwd,
// and `is_bf16` must be 1. Returns 0 on success, a cudaError_t code after a
// failed launch, or -1 when the packed buffers or the shapes do not fit
// this kernel.
int fused_gabor_fwd_tc(const float* coef, const float* viewdirs, const float* t,
                       const void* wmat, const float* vec, int n_w, int n_b, int is_bf16,
                       int num_rays, int S, int rays_per_cta, int real_d, float sigma_mul,
                       float rgb_mul, float* rgb, float* acc, float* depth, float* weights,
                       void* stream) {
  return gabor::launch_fwd_tc(coef, viewdirs, t, wmat, vec, n_w, n_b, is_bf16, num_rays, S,
                              rays_per_cta, real_d, sigma_mul, rgb_mul, rgb, acc, depth,
                              weights, stream);
}

const char* fused_gabor_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
