// Fused GaborNet train pass for Hopper (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render_gabor.py::_train_kernel
// (FusedGaborRender.train) in float32 mode; its bfloat16 mode is
// fused_render_gabor_train_tc.cu, on the tensor cores. Forward, white-background MSE (loss partial and
// its analytic per-ray cotangent, fused_render.py::_mse_cotangent), the
// backward through compositing (fused_render.py::_composite_bwd) and the
// network backward, one pass over the rays. It gives the 23 float32 weight
// gradients of the packed layout (fused_render_gabor_common.cuh), the loss,
// rgb, acc and the compositing weights, and the per-ray cotangents of the
// filter coefficients dA..dR (5 x (R, 8 x 256)): for each ray and stage the
// float32 sum over the ray's samples of
//   dA = dsinarg, dB = dsinarg t, dP = de, dQ = de t, dR = de t^2,
// with dsinarg = (dg cos(sinarg)) E and de = (dg sin(sinarg)) E, dg the
// cotangent of the filter value. Autograd carries them through the prep to
// omega, phi, mu and gamma. (The JAX forward render has no VJP; neither has
// this port's, so there is no render-backward kernel.)
//
// What bounds it on this card: operations. A sample costs the forward's
// 561,152 MACs plus twice that for the backward, less the product the TPU
// kernel also skips (dzr0 wr0d^T: input gradients are not wanted):
// 1,680,000 MACs, and 8,192 transcendentals (the forward's sine and
// exponential of each filter element, the backward's sine and cosine).
// float32 mode runs on the CUDA cores (67 TFLOP/s).
//
// Design: the SIREN train kernel's (fused_render_siren_train.cu), for the
// same reasons (a chunk's activations do not fit on chip, a ray's cotangent
// needs the whole ray, CTAs run in no order), with the filters' part added.
//   1. Forward chunk by chunk over the CTA's whole rays, stashing per point
//      in a per-CTA scratch area in device memory each stage's z (rounded
//      as the products read it) and u = z W + b, feat, y, denc, sigma_pre
//      and rgb: 19.2 KB per point in float32 (5.0 GB at 1024 x 256). The
//      TPU kernel keeps gs, sinargs and Es in VMEM as well; stashing them
//      would add 24 KB per point. Instead the backward evaluates each filter
//      again from the ray's coefficients (two FMA chains, expf, sin and cos
//      per element), rounded as the forward rounded it, so it gets the same
//      g bit for bit.
//   2. One thread per ray: transmittance, weights and ray sums, the MSE
//      cotangent, then the compositing backward in reverse sample order
//      (render_common.cuh::composite_rays, with sigma_mul and rgb_mul).
//   3. The heads' backward as in the NeRF train kernel (relu rgb head, no
//      activation on the remap), then stage by stage, 8 down to 1, over all
//      of the CTA's points: a per-ray pass (one thread per column, the
//      ray's samples in order) takes dz_i to the filter cotangent dg_i =
//      dz_i * u_i and, in place, to du_i = dz_i * g_i, and sums the ray's
//      five coefficient cotangents of stage i; the CTA owns whole rays, so
//      these sums need no atomics and come out in the same order every run.
//      Then dW_{i-1} = z_{i-1}^T du_i (one product over the CTA's points
//      with its 64 x 256 output strip in registers), db_{i-1} a column sum,
//      and dz_{i-1} = du_i W_{i-1}^T on the forward's gemm against
//      transposed weights. Stage 1 has dg_1 = dz_1.
//   4. A second small kernel adds the per-CTA partials (and loss terms) in
//      CTA order. Nothing is atomic, so a step is deterministic from run to
//      run.
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

constexpr int NPART = (N_TOT + 1 + 3) / 4 * 4;   // per-CTA: gradients, loss
constexpr int FLOATS_PER_POINT = floats_per_point<2>();

// The per-ray pass of stage `stage` (0-based), thread = column: for each of
// the CTA's rays (rows from 0) and its samples in order, the filter again
// from the coefficients, dg = dz * u (stage > 0; else dg = dz) and, for
// stage > 0, dz replaced in place by du = dz * g; the ray's sums of the five
// coefficient cotangents go to dcoef. Rows past the CTA's points are left
// alone (their dz is zero).
__device__ void filter_cotangents(const RayInputs& in, const Gabor& gp, int ray0,
                                  int nr, int stage, float* dz, const float* u,
                                  float* __restrict__ dcoef) {
  const int S = in.S;
  for (int c = threadIdx.x; c < H; c += THREADS)
  for (int r = 0; r < nr; ++r) {
    const int ray = ray0 + r;
    const size_t at = static_cast<size_t>(ray) * NH + stage * H + c;
    const float a = gp.coef[at], b = gp.coef[at + gp.plane];
    const float p = gp.coef[at + 2 * gp.plane], q = gp.coef[at + 3 * gp.plane];
    const float rr = gp.coef[at + 4 * gp.plane];
    float sa = 0.f, sb = 0.f, sp = 0.f, sq = 0.f, sr = 0.f;
    for (int i = 0; i < S; ++i) {
      const size_t l = static_cast<size_t>(r) * S + i;
      const float tv = in.t[ray * S + i];
      const float t2 = __fmul_rn(tv, tv);
      const Filter f = filter_at<false>(a, b, p, q, rr, tv, t2);
      const float d = dz[l * LDZ + c];
      float dg = d;
      if (stage > 0) {
        dg = __fmul_rn(d, u[l * H + c]);
        dz[l * LDZ + c] = __fmul_rn(d, __fmul_rn(f.sn, f.E));
      }
      const float dsa = __fmul_rn(__fmul_rn(dg, cosine<false>(f.sinarg)), f.E);
      const float de = __fmul_rn(__fmul_rn(dg, f.sn), f.E);
      sa = __fadd_rn(sa, dsa);
      sb = __fadd_rn(sb, __fmul_rn(dsa, tv));
      sp = __fadd_rn(sp, de);
      sq = __fadd_rn(sq, __fmul_rn(de, tv));
      sr = __fadd_rn(sr, __fmul_rn(de, t2));
    }
    dcoef[at] = sa;
    dcoef[at + gp.plane] = sb;
    dcoef[at + 2 * gp.plane] = sp;
    dcoef[at + 3 * gp.plane] = sq;
    dcoef[at + 4 * gp.plane] = sr;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_gabor_train_kernel(RayInputs in, Gabor gp, const float* __restrict__ wmat,
                         const float* __restrict__ wmat_t,
                         const float* __restrict__ target, float white_bg,
                         float scale, int rays_per_cta, int cap,
                         float* __restrict__ scratch, float* __restrict__ partial,
                         float* __restrict__ dcoef, float* __restrict__ rgb_out,
                         float* __restrict__ acc_out,
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
  Scratch sc = carve<2>(scratch + static_cast<size_t>(blockIdx.x) * cz * FLOATS_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = sc.cols;
  const float* vec = in.vec;

  // ---- 1. forward, stashing what the backward needs ----
  for (int c0 = 0; c0 < npts; c0 += P)
    forward_chunk<true>(in, gp, wmat, ray0 * S + c0, min(P, npts - c0), smem,
                              sc.st, static_cast<size_t>(c0));

  // ---- 2. compositing, cotangent, compositing backward (thread per ray) ----
  float* lossr = smem + SM_ACT1;
  composite_rays<true>(in, ray0, nr, cap_c, cols, cz, gp.sigma_mul, gp.rgb_mul,
                       target, white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }

  // ---- 3. backward: the heads, then stage by stage, each stage's filter
  //      cotangents per ray ----
  net_backward<false>(sc, cz, vec, wmat, wmat_t, part, cap_c, smem,
                      [](const float*) {},
                      [&](int stage, float* dz, const float* u) {
                        filter_cotangents(in, gp, ray0, nr, stage, dz, u, dcoef);
                        __syncthreads();
                      });
}

int launch(const RayInputs& in, const Gabor& gp, const void* wmat, const void* wmat_t,
           const float* target, float white_bg, float scale, int rays_per_cta,
           int cap, float* scratch, float* partial, float* out, float* dcoef,
           float* rgb, float* acc, float* weights, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_gabor_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (in.num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_gabor_train_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      in, gp, static_cast<const float*>(wmat), static_cast<const float*>(wmat_t), target,
      white_bg, scale, rays_per_cta, cap, scratch, partial, dcoef, rgb, acc, weights);
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
void fused_gabor_train_sizes(int* floats_per_point, int* npart, int* n_out) {
  *floats_per_point = FLOATS_PER_POINT;
  *npart = NPART;
  *n_out = N_TOT + 1;
}

// `coef` holds the (5, num_rays, 8 x 256) float32 coefficients A, B, P, Q,
// R and `dcoef` receives their cotangents in the same layout; `target` is
// (R, 3). `scratch` holds grid * cap * floats_per_point floats, `partial`
// grid * npart, `out` n_out, where grid = ceil(num_rays / rays_per_cta) and
// cap >= ceil(rays_per_cta * S / 64) * 64. Returns 0 on success, a
// cudaError_t code after a failed launch, or -1 when the packed buffers or
// the shapes do not fit this kernel. float32 only: the bfloat16 pass is
// fused_render_gabor_train_tc.cu's.
int fused_gabor_train(const float* coef, const float* viewdirs, const float* t,
                      const void* wmat, const void* wmat_t, const float* vec,
                      int n_w, int n_b, const float* target,
                      float white_bg, float scale, int num_rays, int S,
                      int rays_per_cta, int cap, int real_d, float sigma_mul,
                      float rgb_mul, float* scratch, float* partial, float* out,
                      float* dcoef, float* rgb, float* acc, float* weights,
                      void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || rays_per_cta > H * LDA || real_d > DP ||
      cap % P != 0 || cap < (rays_per_cta * S + P - 1) / P * P)
    return -1;
  const RayInputs in{nullptr, nullptr, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Gabor gp{coef, static_cast<size_t>(num_rays) * NH, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(in, gp, wmat, wmat_t, target, white_bg, scale, rays_per_cta, cap, scratch,
                partial, out, dcoef, rgb, acc, weights, s);
}

const char* fused_gabor_train_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
