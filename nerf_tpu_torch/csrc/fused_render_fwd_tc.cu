// Fused NeRF forward render in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render.py::_fwd_kernel (the forward
// route of FusedNerfRender.__call__) in bfloat16 mode. Same function as
// fused_render_fwd.cu, which keeps the float32 mode: for every sample p =
// o_aff + t * d_aff, PE(p) with L_pos frequencies (the degree-11 sine),
// PE(viewdir) with L_dir (the exact sine), the MLP of
// nerf_tpu/ops/pallas/fused_nerf.py::_mlp_tile, deltas from t with the 1e10
// tail, one_m = exp(-sigma*delta), exclusive-cumprod transmittance,
// w = T*(1-one_m), and per ray rgb = sum w*c, acc = sum w, depth = sum w*t.
// The weights (R,S) leave the kernel; positions, encodings and the
// (points x 256) activations never do.
//
// What bounds it on this card: operations. One sample costs 658,944 MACs
// at hidden 256: 0.70 / 2.10 ms at 8192 rays x 64 / 192 samples on the
// tensor cores' 989 TFLOP/s in bf16, against a few MB of device-memory
// traffic. The kernel it replaced in bf16 (fused_render_fwd.cu, every
// product an fp32 FMA on the CUDA cores) took 21.164 / 62.040 ms on an
// NVIDIA H100 80GB HBM3 at 700 W, 0.033 of that bound.
//
// Design: the forward chain of the bf16 train pass
// (fused_render_tc_common.cuh::forward_chunk_tc, on render_tc.cuh's
// mma.sync m16n8k16 products with the weights streamed through a ring of
// cp.async stages), with the same rounding points: the encodings rounded
// to bf16, bf16 operands and float32 sums in every product, h9 unrounded
// for the density and rounded for the feature product. It writes no stash:
// after each 64-point chunk the density and colour of its points sit in
// shared-memory columns, and thread 0 runs the compositing scan over them
// in sample order, carrying T from chunk to chunk
// (render_common.cuh::composite_chunk, as fused_render_fwd.cu). A CTA owns
// whole rays, so compositing needs nothing from another CTA; two CTAs share
// an SM (one composites while the other multiplies), so the wrapper gives
// each ceil(R / (2 x SMs)) rays. Chunks span rays at any S, a CTA's last
// chunk may be short (zero encodings past its points), and a ragged ray
// count leaves the last CTA fewer rays.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_tc_common.cuh"

namespace {

using namespace nerf;

// Shared memory (bytes): the train pass's forward plan, then the chunk's
// per-point columns (COL_*).
constexpr int FB_COL = FB_END;
constexpr int SMEM_FWD_TC = FB_COL + N_FWD_COLS * TC_P * 4;
static_assert(SMEM_FWD_TC <= 232448 && (!ONE_TILE || 2 * (SMEM_FWD_TC + 1024) <= 233472),
              "two forward CTAs share an SM at hidden 256, one fits wider");

__global__ void __launch_bounds__(THREADS, 2)
fused_render_fwd_tc_kernel(RayInputs in, const bf16* __restrict__ wmat, int rays_per_cta,
                           float* __restrict__ rgb_out, float* __restrict__ acc_out,
                           float* __restrict__ depth_out, float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const FwdSmem sm = fwd_smem(sb, FB_COL);
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash none{};
  RaySums sums;             // compositing carry (thread 0 only)
  for (int c0 = 0; c0 < npts; c0 += TC_P) {
    const int chunk0 = ray0 * S + c0, nvalid = min(TC_P, npts - c0);
    forward_chunk_tc<false>(in, wmat, chunk0, nvalid, sm, none, 0, 0);
    if (threadIdx.x == 0)
      composite_chunk(sums, sm.col + COL_T * TC_P, sm.col + COL_DELTA * TC_P,
                      sm.col + COL_SIGMA * TC_P, sm.col + COL_RGB * TC_P, chunk0, nvalid, S,
                      rgb_out, acc_out, depth_out, weights_out, TC_P);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// The bf16 forward render: `wmat` the packed bf16 matrices, `vec` the
// float32 vectors; rgb (R, 3), acc (R,), depth (R,) and weights (R, S) are
// written. The arguments are those of fused_render_fwd; `is_bf16` must be 1.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_render_fwd_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                        const float* t, const void* wmat, const float* vec, int n_w, int n_b,
                        int is_bf16, int num_rays, int S, int rays_per_cta, int real_p,
                        int real_d, float* rgb, float* acc, float* depth, float* weights,
                        void* stream) {
  if (n_w != N_W || n_b != N_B || is_bf16 != 1 || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || real_p > PP || real_d > DP)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, real_p, real_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_render_fwd_tc_kernel<<<grid, THREADS, SMEM_FWD_TC, s>>>(
      in, static_cast<const bf16*>(wmat), rays_per_cta, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_render_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
