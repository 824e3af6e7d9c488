// Fused NeRF train pass and render backward in bfloat16 on Hopper's tensor
// cores (sm_90a).
//
// Replaces two TPU kernels of nerf_tpu/ops/pallas/fused_render.py in
// bfloat16 mode:
//   * _train_kernel (FusedNerfRender.train): the forward of the NeRF MLP
//     over a (rays, samples) batch, white-background MSE (loss partial and
//     its per-ray cotangent, _mse_cotangent), the backward through
//     compositing (_composite_bwd) and the MLP backward
//     (fused_nerf.py::_mlp_bwd_core without input gradients), in one pass;
//   * _bwd_kernel (the custom VJP of FusedNerfRender.__call__): the same,
//     with the per-ray cotangent [g_rgb, g_acc, g_depth] given instead of
//     the MSE head, and the depth cotangent reaching dL/dw as g_depth * t.
// Both give the 28 float32 weight gradients of the packed layout
// (fused_render_common.cuh), the train pass also the loss, rgb, acc and the
// compositing weights. One forward kernel and one backward template, two
// entry points (fused_render_train_tc, fused_render_bwd_tc). The forward is
// row 3's chain (the bf16 forward render, fused_render_fwd_tc.cu), so the
// render backward takes its gradient at the very forward that the render
// returned: the weights it recomputes equal the render's bit for bit. The
// float32 modes stay in fused_render_train.cu. The render backward's
// CUDA-core kernel took 10.811 / 30.558 / 40.304 ms at 1024 rays x 64 / 192
// / 256 samples (NVIDIA H100 80GB HBM3, 700 W).
//
// What bounds it on this card: operations. A sample costs the forward's
// 658,944 MACs plus twice that for the backward, less the three input
// products (dz1 w1^T, dz6 w6p^T, dzr0 wr0d^T): about 1.94M MACs, on the
// tensor cores' 989 TFLOP/s in bf16 (1.029 ms at 1024 rays x 256 samples).
// Next come the bytes of the activations kept for the backward.
//
// The time it replaced (NVIDIA H100 80GB HBM3, 700 W): 10.851 / 30.608 /
// 40.164 ms at 1024 rays x 64 / 192 / 256 samples, every product an fp32
// FMA on the CUDA cores with the bf16 roundings on top (0.024-0.026 of the
// bound), a float32 stash of 13,360 bytes a point (3.5 GB at 1024 x 256).
//
// Design (render_tc.cuh holds the products, fused_render_tc_common.cuh the
// forward chain, shared with the bf16 forward render and field forward, and
// step 3's backward, shared with the bf16 field backward):
//   1. Forward kernel, two CTAs a backward CTA's rays, each every other
//      64-point chunk of them (two CTAs share an SM): the encodings and the
//      activations are bf16 tiles in shared memory (one tile: each layer
//      overwrites its input), each layer one tensor-core product (mma.sync
//      m16n8k16, bf16 operands, float32 sums) against the weights streamed
//      through a ring of cp.async stages of 32 rows, and every activation
//      goes to the stash. h9 is kept in float32 (the density is its float32
//      reduction against w10s, and the backward reads it), the rgb head's
//      last 128 x 3 layer and the sigmoid run on the CUDA cores.
//   2. Backward kernel, a CTA a group of whole rays: one thread per ray for
//      compositing, the MSE cotangent and the compositing backward
//      (render_common.cuh::composite_rays); the rgb output layer's 128 x 3
//      products on the CUDA cores, chunk by chunk.
//   3. Then the MLP backward layer by layer over all of the CTA's points:
//      each dz W^T is a tensor-core product chunk by chunk, against the
//      packed W itself (no transposed copy), with the chunk's dz and ReLU
//      mask staged into shared memory; its epilogue adds dsig w10s where
//      due, applies the mask, sums the unrounded dz by column (the bias
//      gradient; with h9 dsig, the w10s gradient) and stores dz rounded to
//      bf16. Each weight gradient A^T dz is one tensor-core product over
//      all the CTA's points, in strips of 128 rows of A with the strip's
//      128 x 256 output in registers, written once per CTA.
//   4. reduce_partials adds the per-CTA partials (and loss terms) in CTA
//      order. Nothing is atomic, so a step gives the same bits every run.
// Stash: option (a) of a bf16 stash. Every activation the backward reads
// only as a bf16 operand or for its sign is kept in bf16 (h1..h8, r(h9),
// feat, y, the encodings; their ReLU masks are those of the same rounded
// values, as in _mlp_bwd_core), h9 in float32, and the two dz buffers in
// bf16 (their unrounded values are needed only for the bias sums, taken in
// the epilogue): 7,664 bytes a point (the float32 stash took 13,360), about
// 2.0 GB at 1024 x 256. A recompute (option b) would move fewer bytes but
// leave each weight gradient a sum over 64-point chunks in device memory.
// Rounding follows _mlp_bwd_core exactly: both operands of every product
// are bf16 and sums are float32; only the summation order differs from the
// CUDA-core kernel.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_tc_common.cuh"

namespace {

using namespace nerf;

// Shared memory (bytes) of the forward kernel (fused_render_tc_common.cuh's
// plan without the forward render's columns). Two CTAs share an SM.
constexpr int SMEM_FWD = FB_END;
static_assert(SMEM_FWD <= 232448 && (!ONE_TILE || 2 * (SMEM_FWD + 1024) <= 233472),
              "two forward CTAs share an SM at hidden 256, one fits wider");
constexpr int FWD_SPLIT = 2;       // forward CTAs a backward CTA's points
// The backward kernel's plan is fused_render_tc_common.cuh's (SMEM_BWD);
// the compositing pass keeps its per-ray losses in the second activation
// tile.
constexpr int MAX_RAYS_PER_CTA = TC_PB * LDN * 2 / 4;

// Step 1: the forward of FWD_SPLIT CTAs a backward CTA's rays, each every
// FWD_SPLIT-th TC_P-point chunk of them, into that CTA's stash (every row
// the backward reads: its points rounded up to a chunk).
__global__ void __launch_bounds__(THREADS, 2)
fused_render_train_tc_fwd(RayInputs in, const bf16* __restrict__ wmat, int rays_per_cta, int cap,
                 unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const FwdSmem sm = fwd_smem(sb, -1);
  const int b = blockIdx.x / FWD_SPLIT, part = blockIdx.x % FWD_SPLIT;
  const int S = in.S;
  const int ray0 = b * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash st =
      carve_tc_stash(scratch + static_cast<size_t>(b) * cap * TC_BYTES_PER_POINT, cap);
  for (int c0 = part * TC_P; c0 < npts; c0 += FWD_SPLIT * TC_P)
    forward_chunk_tc<true>(in, wmat, ray0 * S + c0, min(TC_P, npts - c0), sm, st,
                           static_cast<size_t>(c0), cap);
}

// Steps 2 and 3: compositing, the cotangent (TRAIN: the MSE head on the
// (R, 3) target `given`; else the given (R, 8) [g_rgb, g_acc, g_depth, 0..])
// and the compositing backward (a thread a ray), then the MLP backward over
// the CTA's points. The render backward writes no loss (0) and no rgb or
// acc, and the compositing weights only where `weights_out` is not null.
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
fused_render_train_tc_bwd(RayInputs in, const bf16* __restrict__ wmat, const float* __restrict__ given,
                 float white_bg, float scale, int rays_per_cta, int cap,
                 unsigned char* __restrict__ scratch, float* __restrict__ partial,
                 float* __restrict__ rgb_out, float* __restrict__ acc_out,
                 float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const BwdSmem sm{reinterpret_cast<bf16*>(sb + BB_ACT0), reinterpret_cast<bf16*>(sb + BB_ACT1),
                   sb + BB_MASK, reinterpret_cast<bf16*>(sb + BB_WST),
                   reinterpret_cast<float*>(sb + BB_COL), reinterpret_cast<float*>(sb + BB_RED)};
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int nr = ray1 - ray0;
  const int cap_c = (nr * S + TC_P - 1) / TC_P * TC_P;
  const TcStash st =
      carve_tc_stash(scratch + static_cast<size_t>(blockIdx.x) * cap * TC_BYTES_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* lossr = reinterpret_cast<float*>(sm.act1);
  composite_rays<TRAIN>(in, ray0, nr, cap_c, st.cols, static_cast<size_t>(cap), 1.f, 1.f, given,
                        white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (threadIdx.x == 0) {
    float s = 0.f;
    if (TRAIN)
      for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }
  __syncthreads();
  backward(st, cap, in.vec, wmat, part, cap_c, sm, NoBwdHooks{});
}

// The stashing forward, then the backward of TRAIN's kind, then the sum of
// the per-CTA partials.
template <bool TRAIN>
int launch(const RayInputs& in, const void* wmat, const float* given, float white_bg,
           float scale, int rays_per_cta, int cap, void* scratch, float* partial, float* out,
           float* rgb, float* acc, float* weights, cudaStream_t s) {
  if (in.num_rays <= 0 || in.S <= 0 || rays_per_cta <= 0 || rays_per_cta > MAX_RAYS_PER_CTA ||
      in.real_p > PP || in.real_d > DP || cap % TC_P != 0 ||
      cap < (rays_per_cta * in.S + TC_P - 1) / TC_P * TC_P)
    return -1;
  cudaError_t err =
      cudaFuncSetAttribute(fused_render_train_tc_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_render_train_tc_bwd<TRAIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (in.num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_render_train_tc_fwd<<<grid * FWD_SPLIT, THREADS, SMEM_FWD, s>>>(
      in, static_cast<const bf16*>(wmat), rays_per_cta, cap, static_cast<unsigned char*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_render_train_tc_bwd<TRAIN><<<grid, THREADS, SMEM_BWD, s>>>(
      in, static_cast<const bf16*>(wmat), given, white_bg, scale, rays_per_cta, cap,
      static_cast<unsigned char*>(scratch), partial, rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, s>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the caller allocates: stash bytes per point, floats per CTA
// partial, floats of the output (the gradients, then the loss).
void fused_render_train_tc_sizes(int* bytes_per_point, int* npart, int* n_out) {
  *bytes_per_point = TC_BYTES_PER_POINT;
  *npart = NPART;
  *n_out = N_TOT + 1;
}

// The bf16 train pass: `wmat` the packed bf16 matrices, `vec` the float32
// vectors, `target` (R, 3); rgb (R, 3), acc (R,), weights (R, S) and the
// gradients and loss (`out`) are written. `scratch` holds grid * cap *
// bytes_per_point bytes, `partial` grid * npart floats, `out` n_out, where
// grid = ceil(num_rays / rays_per_cta) and cap >= ceil(rays_per_cta * S /
// 64) * 64. Returns 0 on success, a cudaError_t code after a failed launch,
// or -1 when the packed buffers or the shapes do not fit this kernel.
int fused_render_train_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                          const float* t, const void* wmat, const float* vec, int n_w, int n_b,
                          const float* target, float white_bg, float scale, int num_rays, int S,
                          int rays_per_cta, int cap, int real_p, int real_d, void* scratch,
                          float* partial, float* out, float* rgb, float* acc, float* weights,
                          void* stream) {
  if (n_w != N_W || n_b != N_B) return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, real_p, real_d};
  return launch<true>(in, wmat, target, white_bg, scale, rays_per_cta, cap, scratch, partial,
                      out, rgb, acc, weights, static_cast<cudaStream_t>(stream));
}

// The bf16 render backward (the replaced CUDA-core kernel's
// fused_render_grad with train = 0): the gradients of the forward render
// from the given (R, 8) cotangent [g_rgb, g_acc, g_depth, 0..], into `out`
// (its loss slot 0); buffers and sizes as fused_render_train_tc's. Its
// forward is row 3's chain (fused_render_fwd_tc.cu), so with `weights_dbg`
// not null the compositing weights it recomputes, (R, S), are written there
// for a check against the forward render's; pass null otherwise. Returns as
// fused_render_train_tc.
int fused_render_bwd_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                        const float* t, const void* wmat, const float* vec, int n_w, int n_b,
                        const float* given, int num_rays, int S, int rays_per_cta, int cap,
                        int real_p, int real_d, void* scratch, float* partial, float* out,
                        float* weights_dbg, void* stream) {
  if (n_w != N_W || n_b != N_B) return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, real_p, real_d};
  return launch<false>(in, wmat, given, 0.f, 0.f, rays_per_cta, cap, scratch, partial, out,
                       nullptr, nullptr, weights_dbg, static_cast<cudaStream_t>(stream));
}

const char* fused_render_train_tc_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
