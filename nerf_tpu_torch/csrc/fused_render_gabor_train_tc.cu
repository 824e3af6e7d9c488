// Fused GaborNet train pass in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render_gabor.py::_train_kernel
// (FusedGaborRender.train) in bfloat16 mode: the forward of the GaborNet
// over a (rays, samples) batch from the per-ray filter coefficients,
// white-background MSE (loss partial and its per-ray cotangent,
// fused_render.py::_mse_cotangent), the backward through compositing
// (_composite_bwd) and the network backward, in one pass. It gives the 23
// float32 weight gradients of the packed layout
// (fused_render_gabor_common.cuh), the loss, rgb, acc and the compositing
// weights, and the per-ray cotangents of the coefficients dA..dR (5 x (R,
// 8 x 256)): for each ray and stage the float32 sum over the ray's samples
// of dA = dsinarg, dB = dsinarg t, dP = de, dQ = de t, dR = de t^2, with
// dsinarg = (dg cos(sinarg)) E and de = (dg sin(sinarg)) E, dg the cotangent
// of the filter value. The float32 mode stays in fused_render_gabor_train.cu.
//
// What bounds it on this card: operations. A sample costs the forward's
// 561,152 MACs plus twice that for the backward, less the product the TPU
// kernel also skips (dzr0 wr0d^T): 1,680,000 MACs on the tensor cores' 989
// TFLOP/s in bf16 (0.891 ms at 1024 rays x 256 samples), and 8,192
// transcendentals (the forward's sine and exponential of each filter
// element, the backward's again with the cosine) on the CUDA cores. Next
// come the bytes of the stash below. The kernel it replaced in bf16
// (fused_render_gabor_train.cu, every product an fp32 FMA on the CUDA
// cores, the coefficient cotangents a thread a column walking each ray's
// samples) took 41.833 ms at 1024 x 256 on an NVIDIA H100 80GB HBM3 at 700
// W, 0.021 of the bound.
//
// Design: rows 5 and 8's split (fused_render_train_tc.cu,
// fused_render_siren_train_tc.cu), on render_tc.cuh's products; the network
// backward of step 3 is fused_render_gabor_tc_common.cuh's, shared with the
// bf16 field backward (fused_gabor_bwd_tc.cu), this file's RayStages its
// filter epilogue:
//   1. Forward kernel, two CTAs a backward CTA's rays, each every other
//      64-point chunk of them (two CTAs share an SM): row 11's chain
//      (fused_render_gabor_tc_common.cuh::forward_chunk_gabor_tc<true>,
//      the forward render's bit for bit), stashing per point.
//   2. Backward kernel, a CTA a group of whole rays: one thread per ray for
//      compositing, the MSE cotangent and the compositing backward
//      (render_common.cuh::composite_rays, with sigma_mul and rgb_mul); the
//      rgb output layer's 128 x 3 products on the CUDA cores, chunk by
//      chunk, with dzr0 = dy (y > 0).
//   3. Then the network backward over all of the CTA's points: the heads
//      (relu rgb head, the remap with no activation), then the
//      multiplicative chain stage by stage, 8 down to 1. Each dz W^T is a
//      tensor-core product chunk by chunk against the packed W itself
//      (gemm_dact), the chunk's dz and its stashed u staged into shared
//      memory. Its epilogue takes each element's dz (plus dsig ws at stage
//      8) to dg = dz u and du = dz g in float32, the filter evaluated again
//      from the ray's coefficients; sums the unrounded du by column (the
//      bias gradient) and stores it rounded to bf16 (the next product's and
//      the weight gradient's operand); and takes the filter cotangents
//      dsinarg and de to the five coefficient cotangents, summed over the
//      thread's rows, then across the warp's 8 row groups by shuffles (each
//      warp holds all 64 rows of its 32 columns), into a per-ray running sum
//      in shared memory (a lane a column pair) that is written once the
//      ray's last sample has passed. A chunk that spans rays (S = 37, a
//      ragged last CTA) splits its sums at the rays' boundaries, a ray at a
//      time. Each weight gradient A^T du is one tensor-core product over all
//      the CTA's points (dweight_tc), written once per CTA. The ws and bs
//      gradients and the rgb output layer's are column loops on the CUDA
//      cores.
//   4. reduce_partials adds the per-CTA partials (and loss terms) in CTA
//      order. Nothing is atomic, and every sum runs in a fixed order, so a
//      step gives the same bits every run.
// Rounding follows _train_kernel (:237-289): both operands of every dW
// product and the dz of every dz W^T are bf16 (mmT_acc, dact), sums are
// float32; u_i, z_8, sigma_pre and the rgb sigmoid are read in float32; the
// bias, ws and bs gradients and dA..dR are float32 sums of unrounded
// values.
//
// Stash: per point, z_1..z_8 rounded, feat, y, denc and the two dz buffers
// in bf16 (each is read only as a product's bf16 operand), u_2..u_8 and z_8
// in float32 (the factors dg = dz u and the ws gradient: a bf16 copy would
// move a rounding point), and 16 per-point float32 columns: 14,208 bytes a
// point (the CUDA-core kernel's float32 stash took 19,264), 3.7 GB at 1024
// x 256, written once and read about once (about 2.2 ms at 3.35 TB/s). The
// filters are not stashed: g, sin and cos in float32 would add 24 KB a point
// (6.3 GB more at 1024 x 256, about 3.8 ms of traffic), while evaluating
// them again in the backward's epilogue costs the forward's filter work once
// more on the CUDA cores, hidden behind the products of the other warps.
// The backward's evaluation is filter_at<true> on the same coefficients and
// t, so it gives the forward's g bit for bit.
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

constexpr int FWD_SPLIT = 2;                      // forward CTAs a backward CTA's points
// The backward kernel's plan is fused_render_gabor_tc_common.cuh's
// (SMEM_BWD); the compositing pass keeps its per-ray losses in the second
// activation tile.
constexpr int MAX_RAYS_PER_CTA = TC_PB * LDN * 2 / 4;

// A backward CTA's rays: their samples' t, coefficients and coefficient
// cotangents from its first ray, and its points (whole rays).
struct RaySpan {
  const float* t;
  const float* coef;
  float* dcoef;
  size_t plane;
  int S, npts;
};

// The epilogue of filter stage `stage` (0-based) over a chunk from l0, the
// warp's TC_PB x 32 tile of dz = acc (+ dsig ws: DSIG) in the block of
// columns from nb. FIRST (stage 0): dg =
// dz. Else dg = dz u and du = dz g (float32), du rounded to the output tile
// act1 and summed unrounded into cs. Then the coefficient cotangents of
// each element into its ray's running sums (sm.run), a ray at a time from
// r_first to r_last (local rays); a ray whose last sample lies in the chunk
// is written to dcoef and its sums reset. UNIFORM: the whole chunk lies in
// ray r_first.
template <bool FIRST, bool DSIG, bool UNIFORM>
__device__ __forceinline__ void filter_chunk(float (&acc)[MT_B][4][4], int nb, int stage, int l0,
                                             int r_first, int r_last,
                                             const float* __restrict__ wsig, const RaySpan& rs,
                                             const BwdSmem& sm, float (&cs)[4][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
  const float* t_s = sm.col + BC_T * TC_PB;
  const float* t2_s = sm.col + BC_T2 * TC_PB;
  const int* ray_s = reinterpret_cast<const int*>(sm.col + BC_RAY * TC_PB);
  const float* coef = rs.coef + stage * H;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int lc = n0 + j * 8 + 2 * c, col = nb + lc;   // in the block, in the layer
    float ws0 = 0.f, ws1 = 0.f;
    if constexpr (DSIG) {
      ws0 = __ldg(wsig + col);
      ws1 = __ldg(wsig + col + 1);
    }
    float2 k[NCOEF];
    if constexpr (UNIFORM) load_coef(k, coef + static_cast<size_t>(r_first) * NH + col, rs.plane);
    float va[MT_B][2][2], ve[MT_B][2][2];   // dsinarg and de by (mt, h, column)
#pragma unroll
    for (int mt = 0; mt < MT_B; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        float x0 = acc[mt][j][2 * h], x1 = acc[mt][j][2 * h + 1];
        if constexpr (DSIG) {
          const float ds = sm.col[BC_DSIG * TC_PB + row];
          x0 = __fadd_rn(x0, __fmul_rn(ds, ws0));
          x1 = __fadd_rn(x1, __fmul_rn(ds, ws1));
        }
        const int rr = UNIFORM ? r_first : ray_s[row];
        float a0 = 0.f, a1 = 0.f, e0 = 0.f, e1 = 0.f, du0 = 0.f, du1 = 0.f;
        if (UNIFORM || rr >= 0) {
          if constexpr (!UNIFORM) load_coef(k, coef + static_cast<size_t>(rr) * NH + col, rs.plane);
          const float tv = t_s[row], t2 = t2_s[row];
          const Filter f0 = filter_at<true>(k[0].x, k[1].x, k[2].x, k[3].x, k[4].x, tv, t2);
          const Filter f1 = filter_at<true>(k[0].y, k[1].y, k[2].y, k[3].y, k[4].y, tv, t2);
          float dg0 = x0, dg1 = x1;
          if constexpr (!FIRST) {
            const float2 um = *reinterpret_cast<const float2*>(sm.u + row * LDU + lc);
            dg0 = __fmul_rn(x0, um.x);
            dg1 = __fmul_rn(x1, um.y);
            du0 = __fmul_rn(x0, __fmul_rn(f0.sn, f0.E));
            du1 = __fmul_rn(x1, __fmul_rn(f1.sn, f1.E));
          }
          a0 = __fmul_rn(__fmul_rn(dg0, cosine<true>(f0.sinarg)), f0.E);
          a1 = __fmul_rn(__fmul_rn(dg1, cosine<true>(f1.sinarg)), f1.E);
          e0 = __fmul_rn(__fmul_rn(dg0, f0.sn), f0.E);
          e1 = __fmul_rn(__fmul_rn(dg1, f1.sn), f1.E);
        }
        if constexpr (!FIRST) {
          cs[j][0] += du0;
          cs[j][1] += du1;
          put2(sm.act1 + row * LDN + lc, du0, du1);
        }
        va[mt][h][0] = a0;
        va[mt][h][1] = a1;
        ve[mt][h][0] = e0;
        ve[mt][h][1] = e1;
      }
    // the five sums of each ray over the thread's rows, then the warp's
    const int r_end = UNIFORM ? r_first : r_last;
    for (int r = r_first; r <= r_end; ++r) {
      float s[NCOEF][2] = {};
#pragma unroll
      for (int mt = 0; mt < MT_B; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + g + 8 * h;
          if (UNIFORM || ray_s[row] == r) {
            const float tv = t_s[row], t2 = t2_s[row];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float a = va[mt][h][u], e = ve[mt][h][u];
              s[0][u] += a;
              s[1][u] = fmaf(a, tv, s[1][u]);
              s[2][u] += e;
              s[3][u] = fmaf(e, tv, s[3][u]);
              s[4][u] = fmaf(e, t2, s[4][u]);
            }
          }
        }
#pragma unroll
      for (int q = 0; q < NCOEF; ++q)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            s[q][u] += __shfl_xor_sync(0xffffffffu, s[q][u], off);
        }
      if (g == 0) {
        const bool ends = (r + 1) * rs.S <= l0 + TC_PB;
        const size_t at = static_cast<size_t>(r) * NH + stage * H + col;
#pragma unroll
        for (int q = 0; q < NCOEF; ++q)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float* run = sm.run + q * H + col + u;
            const float tot = *run + s[q][u];
            if (ends) {
              rs.dcoef[q * rs.plane + at + u] = tot;
              *run = 0.f;
            } else {
              *run = tot;
            }
          }
      }
    }
  }
}

// The train pass's filter stages (the backward's policy): each chunk's t,
// t^2 and local ray columns, then filter_chunk; nothing after a chunk or a
// stage (a ray's sums are written as its last sample passes).
struct RayStages {
  RaySpan rs;

  __device__ void on_dzr0(const bf16*) const {}
  __device__ __forceinline__ void columns(int l0, const BwdSmem& sm) const {
    const int tid = threadIdx.x, l = l0 + tid;
    const bool valid = l < rs.npts;
    const float tv = valid ? rs.t[l] : 0.f;
    sm.col[BC_T * TC_PB + tid] = tv;
    sm.col[BC_T2 * TC_PB + tid] = __fmul_rn(tv, tv);
    reinterpret_cast<int*>(sm.col + BC_RAY * TC_PB)[tid] = valid ? l / rs.S : -1;
  }
  template <bool FIRST, bool DSIG>
  __device__ __forceinline__ void chunk(float (&acc)[MT_B][4][4], int nb, int stage, int l0,
                                        const float* __restrict__ wsig, const BwdSmem& sm,
                                        float (&cs)[4][2]) const {
    const int r_first = l0 / rs.S;
    const int r_last = (min(l0 + TC_PB, rs.npts) - 1) / rs.S;
    if (l0 + TC_PB <= rs.npts && r_first == r_last)
      filter_chunk<FIRST, DSIG, true>(acc, nb, stage, l0, r_first, r_last, wsig, rs, sm, cs);
    else
      filter_chunk<FIRST, DSIG, false>(acc, nb, stage, l0, r_first, r_last, wsig, rs, sm, cs);
  }
  __device__ void after_chunk(int, const BwdSmem&) const {}
  __device__ void end_stage(int, const BwdSmem&) const {}
};

// Step 1: the forward of FWD_SPLIT CTAs a backward CTA's rays, each every
// FWD_SPLIT-th 64-point chunk of them, into that CTA's stash.
__global__ void __launch_bounds__(THREADS, 2)
fused_gabor_train_tc_fwd(RayInputs in, Gabor gp, const bf16* __restrict__ wmat, int rays_per_cta,
                         int cap, unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  const GSmem sm = carve_gsmem(reinterpret_cast<unsigned char*>(smem4));
  const int b = blockIdx.x / FWD_SPLIT, part = blockIdx.x % FWD_SPLIT;
  const int S = in.S;
  const int ray0 = b * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash st =
      carve_tc_stash(scratch + static_cast<size_t>(b) * cap * TC_BYTES_PER_POINT, cap);
  for (int c0 = part * TC_P; c0 < npts; c0 += FWD_SPLIT * TC_P)
    forward_chunk_gabor_tc<true>(in, gp, wmat, ray0 * S + c0, min(TC_P, npts - c0), sm, st,
                                 static_cast<size_t>(c0), cap);
}

// Steps 2 and 3: compositing, the MSE cotangent and the compositing
// backward (a thread a ray), then the network backward over the CTA's
// points.
__global__ void __launch_bounds__(THREADS, 1)
fused_gabor_train_tc_bwd(RayInputs in, Gabor gp, const bf16* __restrict__ wmat,
                         const float* __restrict__ target, float white_bg, float scale,
                         int rays_per_cta, int cap, unsigned char* __restrict__ scratch,
                         float* __restrict__ partial, float* __restrict__ dcoef,
                         float* __restrict__ rgb_out, float* __restrict__ acc_out,
                         float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const BwdSmem sm{reinterpret_cast<bf16*>(sb + BB_ACT0), reinterpret_cast<bf16*>(sb + BB_ACT1),
                   reinterpret_cast<float*>(sb + BB_U),   reinterpret_cast<bf16*>(sb + BB_WST),
                   reinterpret_cast<float*>(sb + BB_COL), reinterpret_cast<float*>(sb + BB_RED),
                   reinterpret_cast<float*>(sb + BB_RUN)};
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int nr = ray1 - ray0;
  const int cap_c = (nr * S + TC_P - 1) / TC_P * TC_P;
  const TcStash st =
      carve_tc_stash(scratch + static_cast<size_t>(blockIdx.x) * cap * TC_BYTES_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  for (int i = threadIdx.x; i < NCOEF * H; i += THREADS) sm.run[i] = 0.f;
  float* lossr = reinterpret_cast<float*>(sm.act1);
  composite_rays<true>(in, ray0, nr, cap_c, st.cols, static_cast<size_t>(cap), gp.sigma_mul,
                       gp.rgb_mul, target, white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }
  __syncthreads();
  const size_t first = static_cast<size_t>(ray0) * NH;
  const RaySpan rs{in.t + static_cast<size_t>(ray0) * S, gp.coef + first, dcoef + first, gp.plane,
                   S, nr * S};
  backward(st, cap, in.vec, wmat, part, cap_c, sm, RayStages{rs});
}

int launch_train_tc(const float* coef, const float* viewdirs, const float* t, const void* wmat,
                    const float* vec, int n_w, int n_b, const float* target, float white_bg,
                    float scale, int num_rays, int S, int rays_per_cta, int cap, int real_d,
                    float sigma_mul, float rgb_mul, void* scratch, float* partial, float* out,
                    float* dcoef, float* rgb, float* acc, float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 || rays_per_cta <= 0 ||
      rays_per_cta > MAX_RAYS_PER_CTA || real_d > DP || cap % TC_P != 0 ||
      cap < (rays_per_cta * S + TC_P - 1) / TC_P * TC_P)
    return -1;
  const RayInputs in{nullptr, nullptr, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Gabor gp{coef, static_cast<size_t>(num_rays) * NH, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fused_gabor_train_tc_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_GABOR_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_gabor_train_tc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  const bf16* w = static_cast<const bf16*>(wmat);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  fused_gabor_train_tc_fwd<<<grid * FWD_SPLIT, THREADS, SMEM_GABOR_TC, s>>>(in, gp, w,
                                                                            rays_per_cta, cap, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gabor_train_tc_bwd<<<grid, THREADS, SMEM_BWD, s>>>(in, gp, w, target, white_bg, scale,
                                                           rays_per_cta, cap, sc, partial, dcoef,
                                                           rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, s>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gabor

extern "C" {

// Sizes the caller allocates: stash bytes per point, floats per CTA
// partial, floats of the output (the gradients, then the loss).
void fused_gabor_train_tc_sizes(int* bytes_per_point, int* npart, int* n_out) {
  *bytes_per_point = gabor::TC_BYTES_PER_POINT;
  *npart = gabor::NPART;
  *n_out = gabor::N_TOT + 1;
}

// The bf16 train pass. `coef` holds the (5, num_rays, 8 x 256) float32
// coefficients A, B, P, Q, R and `dcoef` receives their cotangents in the
// same layout; `wmat` the packed bf16 matrices, `vec` the float32 vectors,
// `target` (R, 3); rgb (R, 3), acc (R,), weights (R, S) and the gradients
// and loss (`out`) are written. `scratch` holds grid * cap *
// bytes_per_point bytes, `partial` grid * npart floats, `out` n_out, where
// grid = ceil(num_rays / rays_per_cta) and cap >= ceil(rays_per_cta * S /
// 64) * 64. Returns 0 on success, a cudaError_t code after a failed launch,
// or -1 when the packed buffers or the shapes do not fit this kernel.
int fused_gabor_train_tc(const float* coef, const float* viewdirs, const float* t,
                         const void* wmat, const float* vec, int n_w, int n_b,
                         const float* target, float white_bg, float scale, int num_rays, int S,
                         int rays_per_cta, int cap, int real_d, float sigma_mul, float rgb_mul,
                         void* scratch, float* partial, float* out, float* dcoef, float* rgb,
                         float* acc, float* weights, void* stream) {
  return gabor::launch_train_tc(coef, viewdirs, t, wmat, vec, n_w, n_b, target, white_bg, scale,
                                num_rays, S, rays_per_cta, cap, real_d, sigma_mul, rgb_mul,
                                scratch, partial, out, dcoef, rgb, acc, weights, stream);
}

const char* fused_gabor_train_tc_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
