// Fused SIREN train pass and render backward in bfloat16 on Hopper's tensor
// cores (sm_90a).
//
// Replaces two TPU kernels of nerf_tpu/ops/pallas/fused_render_siren.py in
// bfloat16 mode:
//   * _train_kernel (FusedSirenRender.train): the forward of the SIREN MLP
//     over a (rays, samples) batch, white-background MSE (loss partial and
//     its per-ray cotangent, fused_render.py::_mse_cotangent), the backward
//     through compositing (_composite_bwd) and the MLP backward
//     (fused_siren.py::_mlp_bwd_core without input gradients), in one pass;
//   * _bwd_kernel (the custom VJP of FusedSirenRender.__call__): the same,
//     with the per-ray cotangent [g_rgb, g_acc, g_depth] given instead of
//     the MSE head, and the depth cotangent reaching dL/dw as g_depth * t.
// Both give the 25 float32 weight gradients of the packed layout
// (fused_render_siren_common.cuh), the train pass also the loss, rgb, acc
// and the compositing weights. One forward kernel and one backward
// template, two entry points (fused_siren_train_tc,
// fused_siren_render_bwd_tc). The forward is row 6's chain (the bf16
// forward render, fused_render_siren_fwd_tc.cu), so the render backward
// takes its gradient at the very forward that the render returned: the
// weights it recomputes equal the render's bit for bit. The float32 modes
// stay in fused_render_siren_train.cu.
//
// What bounds it on this card: operations. A sample costs the forward's
// 561,920 MACs plus twice that for the backward, less the two input
// products (dz1 w1^T, dzr0 wr0d^T): 1,681,536 MACs on the tensor cores'
// 989 TFLOP/s in bf16 (0.891 ms at 1024 rays x 256 samples), and 2,176
// sines and as many cosines on the CUDA cores. Next come the bytes of the
// stash below. The kernels it replaced in bf16 (the train and backward
// entries of fused_render_siren_train.cu, every product an fp32 FMA on the
// CUDA cores) took 38.388 ms (train pass) and 38.406 ms (render backward)
// at 1024 x 256 on an NVIDIA H100 80GB HBM3 at 700 W, 0.023 of the bound.
//
// Design: row 5's split (fused_render_train_tc.cu), on render_tc.cuh's
// products:
//   1. Forward kernel, two CTAs a backward CTA's rays, each every other
//      64-point chunk of them (two CTAs share an SM): row 6's chain
//      (fused_render_siren_tc_common.cuh::forward_chunk_siren_tc<true>,
//      the forward render's bit for bit), stashing per point.
//   2. Backward kernel, a CTA a group of whole rays: one thread per ray for
//      compositing, the cotangent (the MSE head's, or the given one) and
//      the compositing backward (render_common.cuh::composite_rays, with
//      sigma_mul and rgb_mul); the rgb output layer's 128 x 3 products on
//      the CUDA cores, chunk by chunk, with dzr0 = (dy w0h) cr0.
//   3. Then the MLP backward layer by layer over all of the CTA's points
//      (fused_render_siren_tc_common.cuh::backward, shared with the bf16
//      field backward, fused_siren_bwd_tc.cu, which adds the input products):
//      each dz W^T is a tensor-core product chunk by chunk against the
//      packed W itself (gemm_dact), with the chunk's dz and its stashed
//      cosines staged into shared memory; its epilogue adds dsig ws where
//      due, multiplies by w0 and the cosine, sums the unrounded dz by
//      column (the bias gradient) and stores dz rounded to bf16. Each
//      weight gradient A^T dz is one tensor-core product over all the
//      CTA's points (dweight_tc), its strip's output in registers, written
//      once per CTA. The first layer's gradient (K = 3: the rounded
//      positions^T dz1) and the ws and bs gradients are column loops on
//      the CUDA cores.
//   4. reduce_partials adds the per-CTA partials (and loss terms) in CTA
//      order. Nothing is atomic, so a step gives the same bits every run.
// Rounding follows _mlp_bwd_core (nerf_tpu/ops/pallas/fused_siren.py:147):
// dzr0 = dy w0h cos(w0h zr0) and dz_l = dh w0_l cos(w0_l z_l) in float32,
// the cosine fast_sin(arg + pi/2) of the forward's own argument; dz rounded
// to bf16 as the operand of its weight gradient and of its dz W^T; the bias
// sums and the ws and bs gradients float32 sums of the unrounded values;
// h8 and sigma_pre read in float32.
//
// Stash: option (a), as row 5. Per point: h1..h8 rounded, feat, y, denc and
// the two dz buffers in bf16 (each is read only as a product's bf16
// operand), h8 in float32 (the ws gradient), c1..c8 and cr0 in float32
// (the derivative factors: a bf16 copy would move a rounding point), and
// 16 per-point float32 columns: 15,744 bytes a point (the CUDA-core
// kernel's float32 stash took 20,800), 4.1 GB at 1024 x 256, written once
// and read about once (about 2.5 ms at 3.35 TB/s). Option (b), recomputing
// z_l in the backward, would save the 8 KB of cosines a point for 27% more
// products, 2,048 more sines a point and two accumulator sets live per
// thread; it waits until the stash's bytes are shown to set the pace.
// The stash grows with the width (siren_plan.py's tc_bytes_per_point):
// 31,360 bytes a point at hidden 512 and 62,592 at 1024, 8.2 / 16.4 GB at
// 1024 x 256, which an 80 GB card holds.
//
// Widths: hidden 256 to 1024 and the direction encoding padded to 32 or 64
// columns, each shape built with its plan's -D flags
// (fused_render_siren_tc_common.cuh says how the chain and the backward
// take them).
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_siren_tc_common.cuh"

namespace siren {
namespace {

constexpr int FWD_SPLIT = 2;       // forward CTAs a backward CTA's points
constexpr int MAX_RAYS_PER_CTA = TC_PB * LDN * 2 / 4;   // per-ray losses in ACT1

// Step 1: the forward of FWD_SPLIT CTAs a backward CTA's rays, each every
// FWD_SPLIT-th 64-point chunk of them, into that CTA's stash.
__global__ void __launch_bounds__(THREADS, 2)
fused_siren_grad_tc_fwd(RayInputs in, Siren sp, const bf16* __restrict__ wmat, int rays_per_cta,
                        int cap, unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  const TcSmem sm = carve_smem(reinterpret_cast<unsigned char*>(smem4));
  const int b = blockIdx.x / FWD_SPLIT, part = blockIdx.x % FWD_SPLIT;
  const int S = in.S;
  const int ray0 = b * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash st =
      carve_stash(scratch + static_cast<size_t>(b) * cap * TC_BYTES_PER_POINT, cap);
  for (int c0 = part * TC_P; c0 < npts; c0 += FWD_SPLIT * TC_P)
    forward_chunk_siren_tc<true>(in, sp, wmat, ray0 * S + c0, min(TC_P, npts - c0), sm, st,
                                 static_cast<size_t>(c0), cap);
}

// Steps 2 and 3: compositing, the cotangent (TRAIN: the MSE head on the
// (R, 3) target `given`; else the given (R, 8) [g_rgb, g_acc, g_depth, 0..])
// and the compositing backward (a thread a ray), then the MLP backward over
// the CTA's points. The render backward writes no loss (0) and no rgb or
// acc, and the compositing weights only where `weights_out` is not null.
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
fused_siren_grad_tc_bwd(RayInputs in, Siren sp, const bf16* __restrict__ wmat,
                        const float* __restrict__ given, float white_bg, float scale,
                        int rays_per_cta, int cap, unsigned char* __restrict__ scratch,
                        float* __restrict__ partial, float* __restrict__ rgb_out,
                        float* __restrict__ acc_out, float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const BwdSmem sm{reinterpret_cast<bf16*>(sb + BB_ACT0), reinterpret_cast<bf16*>(sb + BB_ACT1),
                   reinterpret_cast<float*>(sb + BB_COS), reinterpret_cast<bf16*>(sb + BB_WST),
                   reinterpret_cast<float*>(sb + BB_COL), reinterpret_cast<float*>(sb + BB_RED)};
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int nr = ray1 - ray0;
  const int cap_c = (nr * S + TC_P - 1) / TC_P * TC_P;
  const TcStash st =
      carve_stash(scratch + static_cast<size_t>(blockIdx.x) * cap * TC_BYTES_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* lossr = reinterpret_cast<float*>(sm.act1);
  composite_rays<TRAIN>(in, ray0, nr, cap_c, st.cols, static_cast<size_t>(cap), sp.sigma_mul,
                        sp.rgb_mul, given, white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (threadIdx.x == 0) {
    float s = 0.f;
    if (TRAIN)
      for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }
  __syncthreads();
  backward(st, cap, sp, in.vec, wmat, part, cap_c, sm, NoBwdHooks{});
}

// The stashing forward, then the backward of TRAIN's kind, then the sum of
// the per-CTA partials.
template <bool TRAIN>
int launch(const RayInputs& in, const Siren& sp, const void* wmat, const float* given,
           float white_bg, float scale, int rays_per_cta, int cap, void* scratch,
           float* partial, float* out, float* rgb, float* acc, float* weights,
           cudaStream_t s) {
  if (in.num_rays <= 0 || in.S <= 0 || rays_per_cta <= 0 || rays_per_cta > MAX_RAYS_PER_CTA ||
      in.real_d > DP || cap % TC_P != 0 ||
      cap < (rays_per_cta * in.S + TC_P - 1) / TC_P * TC_P)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(fused_siren_grad_tc_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SB_END);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_siren_grad_tc_bwd<TRAIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (in.num_rays + rays_per_cta - 1) / rays_per_cta;
  const bf16* w = static_cast<const bf16*>(wmat);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  fused_siren_grad_tc_fwd<<<grid * FWD_SPLIT, THREADS, SB_END, s>>>(in, sp, w, rays_per_cta, cap,
                                                                    sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_siren_grad_tc_bwd<TRAIN><<<grid, THREADS, SMEM_BWD, s>>>(
      in, sp, w, given, white_bg, scale, rays_per_cta, cap, sc, partial, rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, s>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace siren

extern "C" {

// Sizes the caller allocates: stash bytes per point, floats per CTA
// partial, floats of the output (the gradients, then the loss).
void fused_siren_train_tc_sizes(int* bytes_per_point, int* npart, int* n_out) {
  *bytes_per_point = siren::TC_BYTES_PER_POINT;
  *npart = siren::NPART;
  *n_out = siren::N_TOT + 1;
}

// The bf16 train pass: `wmat` the packed bf16 matrices, `vec` the float32
// vectors, `target` (R, 3); rgb (R, 3), acc (R,), weights (R, S) and the
// gradients and loss (`out`) are written. `scratch` holds grid * cap *
// bytes_per_point bytes, `partial` grid * npart floats, `out` n_out, where
// grid = ceil(num_rays / rays_per_cta) and cap >= ceil(rays_per_cta * S /
// 64) * 64. Returns 0 on success, a cudaError_t code after a failed launch,
// or -1 when the packed buffers or the shapes do not fit this kernel.
int fused_siren_train_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                         const float* t, const void* wmat, const float* vec, int n_w, int n_b,
                         const float* target, float white_bg, float scale, int num_rays, int S,
                         int rays_per_cta, int cap, int real_d, float w0, float w0h,
                         float sigma_mul, float rgb_mul, void* scratch, float* partial,
                         float* out, float* rgb, float* acc, float* weights, void* stream) {
  if (n_w != siren::N_W || n_b != siren::N_B) return -1;
  const siren::RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, 0, real_d};
  const siren::Siren sp{w0, w0h, sigma_mul, rgb_mul};
  return siren::launch<true>(in, sp, wmat, target, white_bg, scale, rays_per_cta, cap, scratch,
                             partial, out, rgb, acc, weights, static_cast<cudaStream_t>(stream));
}

// The bf16 render backward (the replaced CUDA-core kernel's
// fused_siren_grad with train = 0): the gradients of the forward render
// from the given (R, 8) cotangent [g_rgb, g_acc, g_depth, 0..], into `out`
// (its loss slot 0); buffers and sizes as fused_siren_train_tc's. Its
// forward is row 6's chain (fused_render_siren_fwd_tc.cu), so with
// `weights_dbg` not null the compositing weights it recomputes, (R, S), are
// written there for a check against the forward render's; pass null
// otherwise. Returns as fused_siren_train_tc.
int fused_siren_render_bwd_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                              const float* t, const void* wmat, const float* vec, int n_w,
                              int n_b, const float* given, int num_rays, int S, int rays_per_cta,
                              int cap, int real_d, float w0, float w0h, float sigma_mul,
                              float rgb_mul, void* scratch, float* partial, float* out,
                              float* weights_dbg, void* stream) {
  if (n_w != siren::N_W || n_b != siren::N_B) return -1;
  const siren::RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, 0, real_d};
  const siren::Siren sp{w0, w0h, sigma_mul, rgb_mul};
  return siren::launch<false>(in, sp, wmat, given, 0.f, 0.f, rays_per_cta, cap, scratch, partial,
                              out, nullptr, nullptr, weights_dbg,
                              static_cast<cudaStream_t>(stream));
}

const char* fused_siren_train_tc_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
