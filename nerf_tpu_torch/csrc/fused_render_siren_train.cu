// Fused SIREN train pass and render backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of nerf_tpu/ops/pallas/fused_render_siren.py in
// float32 mode (their bfloat16 modes are fused_render_siren_train_tc.cu's):
//   * _train_kernel (FusedSirenRender.train): forward, white-background MSE
//     (loss partial and its analytic per-ray cotangent,
//     fused_render.py::_mse_cotangent), the backward through compositing
//     (fused_render.py::_composite_bwd) and the MLP backward
//     (fused_siren.py::_mlp_bwd_core without input gradients), one pass
//     over the rays;
//   * _bwd_kernel (the custom VJP of FusedSirenRender.__call__): the same,
//     with the per-ray cotangent [g_rgb, g_acc, g_depth] given instead of
//     the MSE head.
// Both give the 25 float32 weight gradients of the packed layout
// (fused_render_siren_common.cuh), the train pass also the loss, rgb, acc
// and the compositing weights. One template body, two entry points.
//
// What bounds it on this card: operations. A sample costs the forward's
// 561,920 MACs plus twice that for the backward, less the two products the
// TPU kernel also skips (dz1 w1^T and dzr0 wr0d^T: input gradients are not
// wanted): 1,681,536 MACs, and 2,176 sines and as many cosines, on the CUDA
// cores (67 TFLOP/s in float32).
//
// Design: the NeRF train kernel's (fused_render_train.cu), for the same
// reasons: a chunk's activations do not fit on chip, a ray's cotangent
// needs the whole ray, and CTAs run in no order.
//   1. Forward chunk by chunk over the CTA's whole rays, stashing per
//      point, in a per-CTA scratch area in device memory: each sine layer's
//      output h_l and its derivative factor cos(w0_l z_l) (computed in the
//      forward epilogue, from the same argument), feat, y, cos(w0h zr0),
//      denc, sigma_pre, rgb and the raw positions (~20.8 KB per point in
//      float32). Stashing the cosines instead of the pre-activations keeps
//      every transcendental out of the backward and recomputes nothing: the
//      TPU kernel keeps the eight pre-activations in VMEM and takes sin and
//      cos again in its backward; here the same values are evaluated once.
//   2. One thread per ray: transmittance, weights and ray sums, the
//      cotangent, then the compositing backward in reverse sample order
//      (render_common.cuh::composite_rays, with sigma_mul and rgb_mul).
//   3. The MLP backward layer by layer over all of the CTA's points: each
//      dz (points x 256, float32, unrounded) chunk by chunk into the next
//      scratch buffer (dz W^T on the forward's register-tiled gemm against
//      transposed weights, its epilogue multiplying by w0 and the stashed
//      cosine), and each weight gradient as one product A^T dz over the
//      CTA's points with its 64 x 256 output strip in registers. The first
//      layer's gradient (K = 3) is a plain column loop. Bias, ws and bs
//      gradients are column sums.
//   4. A second small kernel adds the per-CTA partials (and loss terms) in
//      CTA order. Nothing is atomic, so a step is deterministic from run to
//      run.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_render_siren_common.cuh"

namespace {

using namespace siren;

template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
fused_siren_grad_kernel(RayInputs in, Siren sp, const float* __restrict__ wmat,
                        const float* __restrict__ wmat_t,
                        const float* __restrict__ given, float white_bg,
                        float scale, int rays_per_cta, int cap,
                        float* __restrict__ scratch, float* __restrict__ partial,
                        float* __restrict__ rgb_out, float* __restrict__ acc_out,
                        float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int nr = ray1 - ray0;
  const int npts = nr * S;
  const int cap_c = (npts + P - 1) / P * P;
  const size_t cz = static_cast<size_t>(cap);
  Scratch sc = carve(scratch + static_cast<size_t>(blockIdx.x) * cz * FLOATS_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = sc.cols;
  const float* vec = in.vec;

  // ---- 1. forward, stashing what the backward needs ----
  for (int c0 = 0; c0 < npts; c0 += P)
    forward_chunk<false, true>(in, wmat, sp, ray0 * S + c0, min(P, npts - c0), smem,
                               sc.st, static_cast<size_t>(c0));

  // ---- 2. compositing, cotangent, compositing backward (thread per ray) ----
  float* lossr = smem + SM_ACT1;
  composite_rays<TRAIN>(in, ray0, nr, cap_c, cols, cz, sp.sigma_mul, sp.rgb_mul,
                        given, white_bg, scale, rgb_out, acc_out,
                        TRAIN ? weights_out : nullptr, lossr);
  if (tid == 0) {
    float s = 0.f;
    if (TRAIN)
      for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }

  // ---- 3. MLP backward, layer by layer over the CTA's points ----
  mlp_backward<false>(sc, cz, vec, wmat, wmat_t, sp, part, cap_c, smem,
                      [](const float*) {});
}

template <bool TRAIN>
int launch(const RayInputs& in, const Siren& sp, const void* wmat,
           const void* wmat_t, const float* given, float white_bg, float scale,
           int rays_per_cta, int cap, float* scratch, float* partial, float* out,
           float* rgb, float* acc, float* weights, cudaStream_t stream) {
  auto kernel = fused_siren_grad_kernel<TRAIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (in.num_rays + rays_per_cta - 1) / rays_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      in, sp, static_cast<const float*>(wmat), static_cast<const float*>(wmat_t), given,
      white_bg, scale, rays_per_cta, cap, scratch, partial, rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, stream>>>(
      partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the caller allocates: scratch floats per stashed point, floats per
// CTA partial, floats of the output (the gradients, then the loss).
void fused_siren_grad_sizes(int* floats_per_point, int* npart, int* n_out) {
  *floats_per_point = FLOATS_PER_POINT;
  *npart = NPART;
  *n_out = N_TOT + 1;
}

// float32 only (fused_render_siren_train_tc.cu has both in bfloat16).
// train != 0: `given` is the (R, 3) target and rgb/acc/weights are written;
// train == 0: `given` is the (R, 8) cotangent [g_rgb, g_acc, g_depth, 0..]
// and only the gradients are. `scratch` holds grid * cap *
// floats_per_point floats, `partial` grid * npart, `out` n_out, where grid
// = ceil(num_rays / rays_per_cta) and cap >= ceil(rays_per_cta * S / 64) *
// 64. Returns 0 on success, a cudaError_t code after a failed launch, -1
// when the packed buffers or the shapes do not fit this kernel, or -2 for
// bfloat16 (both runs are fused_render_siren_train_tc.cu's).
int fused_siren_grad(const float* o_aff, const float* d_aff,
                     const float* viewdirs, const float* t, const void* wmat,
                     const void* wmat_t, const float* vec, int n_w, int n_b,
                     int bf16, int train, const float* given, float white_bg,
                     float scale, int num_rays, int S, int rays_per_cta, int cap,
                     int real_d, float w0, float w0h, float sigma_mul,
                     float rgb_mul, float* scratch, float* partial, float* out,
                     float* rgb, float* acc, float* weights, void* stream) {
  if (bf16) return -2;   // fused_render_siren_train_tc.cu runs both in bf16
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || rays_per_cta > H * LDA || real_d > DP ||
      cap % P != 0 || cap < (rays_per_cta * S + P - 1) / P * P)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (train)
    return launch<true>(in, sp, wmat, wmat_t, given, white_bg, scale, rays_per_cta,
                        cap, scratch, partial, out, rgb, acc, weights, s);
  return launch<false>(in, sp, wmat, wmat_t, given, white_bg, scale, rays_per_cta,
                       cap, scratch, partial, out, rgb, acc, weights, s);
}

const char* fused_siren_grad_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  if (code == -2)
    return "bfloat16 runs on the tensor cores: the train pass in fused_siren_train_tc, the "
           "render backward in fused_siren_render_bwd_tc (both in the "
           "fused_render_siren_train_tc library)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
