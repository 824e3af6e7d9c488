// Fused SIREN forward render in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render_siren.py::_fwd_kernel (the
// forward route of FusedSirenRender.__call__) in bfloat16 mode. Same
// function as fused_render_siren_fwd.cu, which keeps the float32 mode: for
// every sample p = o_aff + t * d_aff (o_aff/d_aff already carry the
// [near,far]->[-1,1] map), the MLP of
// nerf_tpu/ops/pallas/fused_siren.py::_mlp_tile on p and on the L_dir
// frequency encoding of the view direction, deltas from t with the 1e10
// tail, one_m = exp(-sigma*delta), exclusive-cumprod transmittance,
// w = T*(1-one_m), and per ray rgb = sum w*c, acc = sum w, depth = sum w*t.
// The weights (R,S) leave the kernel; positions and the (points x 256)
// activations never do.
//
// What bounds it on this card: operations. One sample costs 561,920 MACs
// (0.298 ms at 1024 rays x 256 samples on the tensor cores' 989 TFLOP/s in
// bf16) and 2,176 sines (8 x 256 + 128, the degree-11 fast_sin: about 15
// CUDA-core instructions each, 0.57 G sines a launch), against a few MB of
// device-memory traffic. The kernel it replaced in bf16
// (fused_render_siren_fwd.cu, every product an fp32 FMA on the CUDA cores)
// took 8.977 ms there on an NVIDIA H100 80GB HBM3 at 700 W, 0.033 of the
// bound.
//
// Design: row 11's (fused_render_gabor_fwd_tc.cu) on row 8's bf16 chain
// (fused_render_siren_tc_common.cuh::forward_chunk_siren_tc, shared with
// fused_render_siren_train_tc.cu, so the two give the same rgb, acc and
// weights bit for bit). A CTA owns whole rays and walks their samples in
// chunks of TC_P points (64 up to hidden 512, 32 wider); two CTAs share an
// SM at hidden 256 with a 32-column direction encoding (about 110 KB of
// shared memory each), so that one CTA's sine epilogues and compositing
// (CUDA cores) overlap the other's products (tensor cores); wider shapes
// take one (siren_plan.py). Layer 1 (K = 3) runs on the
// CUDA cores straight into the accumulator layout; every other product is
// render_tc.cuh's gemm_fwd (mma.sync m16n8k16, bf16 operands, float32
// sums) against the weights streamed through a ring of cp.async stages,
// each sine in its epilogue; the near ties of hidden layers 2..8 are
// recomputed in the plain version's sequential k order, so that every
// activation rounds to the plain version's bf16 (the chain's header says
// why). After a chunk the density and colour of its
// points sit in shared-memory columns, and thread 0 runs the compositing
// scan over them in sample order, carrying T from chunk to chunk
// (render_common.cuh::composite_chunk). Chunks span rays at any S, a CTA's
// last chunk may be short (zero inputs past its points), and a ragged ray
// count leaves the last CTA fewer rays.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_siren_tc_common.cuh"

namespace siren {
namespace {

__global__ void __launch_bounds__(THREADS, 2)
fused_siren_fwd_tc_kernel(RayInputs in, Siren sp, const bf16* __restrict__ wmat, int rays_per_cta,
                          float* __restrict__ rgb_out, float* __restrict__ acc_out,
                          float* __restrict__ depth_out, float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  const TcSmem sm = carve_smem(reinterpret_cast<unsigned char*>(smem4));
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash none{};
  RaySums sums;             // compositing carry (thread 0 only)
  for (int c0 = 0; c0 < npts; c0 += TC_P) {
    const int chunk0 = ray0 * S + c0, nvalid = min(TC_P, npts - c0);
    forward_chunk_siren_tc<false>(in, sp, wmat, chunk0, nvalid, sm, none, 0, 0);
    if (threadIdx.x == 0)
      composite_chunk(sums, sm.col + SC_T * TC_P, sm.col + SC_DELTA * TC_P,
                      sm.col + SC_SIGMA * TC_P, sm.col + SC_RGB * TC_P, chunk0, nvalid, S,
                      rgb_out, acc_out, depth_out, weights_out, TC_P);
    __syncthreads();
  }
}

int launch_fwd_tc(const float* o_aff, const float* d_aff, const float* viewdirs, const float* t,
                  const void* wmat, const float* vec, int n_w, int n_b, int is_bf16,
                  int num_rays, int S, int rays_per_cta, int real_d, float w0, float w0h,
                  float sigma_mul, float rgb_mul, float* rgb, float* acc, float* depth,
                  float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || is_bf16 != 1 || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || real_d > DP)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_siren_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SB_END);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_siren_fwd_tc_kernel<<<grid, THREADS, SB_END, s>>>(
      in, sp, static_cast<const bf16*>(wmat), rays_per_cta, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace siren

extern "C" {

// The bf16 forward render: `wmat` the packed bf16 matrices, `vec` the
// float32 vectors; rgb (R, 3), acc (R,), depth (R,) and weights (R, S) are
// written. The arguments are those of fused_siren_fwd; `is_bf16` must be 1.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_siren_fwd_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                       const float* t, const void* wmat, const float* vec, int n_w, int n_b,
                       int is_bf16, int num_rays, int S, int rays_per_cta, int real_d, float w0,
                       float w0h, float sigma_mul, float rgb_mul, float* rgb, float* acc,
                       float* depth, float* weights, void* stream) {
  return siren::launch_fwd_tc(o_aff, d_aff, viewdirs, t, wmat, vec, n_w, n_b, is_bf16, num_rays,
                              S, rays_per_cta, real_d, w0, w0h, sigma_mul, rgb_mul, rgb, acc,
                              depth, weights, stream);
}

const char* fused_siren_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
