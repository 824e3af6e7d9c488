// Fused grid render for Hopper (sm_90a): trilinear interpolation of a
// voxel grid at every sample of a ray, the density activation, the colour
// decode and volume compositing, in one kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_grid_render.py::_grid_render_kernel
// (class FusedGridRender), in both its forms: SH (Plenoxels grids, the baked
// PlenOctree cache) and factors (the baked FastNeRF cache), a template
// parameter here. Same function, per ray and sample s:
//   o'_a   = scale * o_a + off, d'_a = scale * d_a   the ray -> cell affine
//            (the normalisation and the domain folded into two scalars on
//            the host, FusedGridRender.affine; nerf_tpu's _cells)
//   g_a    = clamp(o'_a + d'_a * t_s, 0, R - 1)
//   v      = trilinear(grid, g)                   grid_common.cuh, float32
//            or the bfloat16 mode
//   SH:      sigma = softplus(v_0) = max(v_0, 0) + log1p(exp(-|v_0|))
//            rgb_c = sigmoid(sum_l v_{1 + c*L + l} * Y_l(viewdir)), the real
//            SH basis of degree 0-2 (L = 1, 4 or 9; C = 1 + 3L channels)
//            computed here as models/plenoxels.py::sh_basis computes it
//   factors: sigma = max(v_0, 0)
//            rgb_c = sigmoid(sum_d v_{1 + 3d + c} * beta_d), D = 1..10
//            factors (C = 1 + 3D), beta the ray's row of the cache's
//            direction grid, computed before the launch
//            (models/fastnerf.py::BakedFastNeRF.beta), as nerf_tpu computes
//            its basis outside its pallas_call
//   1 - alpha = exp(-sigma * delta_s), delta_s = t_{s+1} - t_s, 1e10 last
//   w_s    = T_s * alpha_s, T_s = prod_{j<s} (1 - alpha_j)
// and the outputs rgb = sum w_s rgb_s, acc = sum w_s, depth = sum w_s t_s
// and the (R, S) weights. The white background is the caller's.
//
// What bounds it on this card: bytes. A ray reads its origin, direction and
// view direction (36 bytes) and its S samples' t (4 each) and writes its
// weights (4 each) and 20 bytes of results; the grid rows its samples touch
// are read at least once (at most R^3 rows). At 1024 rays x 256 samples of a
// 128^3 x 28 grid: 2.2 MB plus the distinct rows touched, under 1 us at
// 3.35 TB/s. The 8 x 28 multiply-adds a sample are 0.002 ms of float32
// CUDA-core time. The factor form reads beta (4 D bytes a ray) in place of
// the view direction and a 25-channel row (D = 8): the same bound.
//
// Design: parallel over samples. A CTA owns one ray and gives each thread
// one sample of a block of up to 256 (the CTA walks longer rays block by
// block, carrying T). A thread reads its sample's eight corner rows as
// vectors (7 x 16 bytes a float32 row, 7 x 8 bytes a bfloat16 one,
// grid_common.cuh::interp_row, the interpolation arithmetic of row 17 bit
// for bit), keeps all C channels in registers, and takes the density and the
// colour dot there in channel order: no shuffles, every load of a sample in
// flight at once. The transmittance is an exclusive product scan of the
// 1 - alpha factors: a warp scan by shuffles, then across the CTA's warps in
// shared memory, times the carry of the earlier blocks. A product scan, not
// a sum of sigma * delta under one exp: it multiplies the same rounded
// factors as the plain version's cumprod, in another association, so T
// moves by a few ulps only; and the tail's 1 - alpha = exp(-inf) = 0 (or an
// opaque sample's) enters as an exact zero, with no inf - inf in a log-domain
// sum. The last sample's factor enters no T of its ray. The weights are
// written coalesced (thread s, column s); rgb, acc and depth are warp sums
// by shuffles, then summed over the warps in order. Consecutive CTAs are
// neighbouring rays in the caller's tile order (tile_ray_order), which share
// corner rows in L2. The TPU kernel's plan (8x8-ray tiles over depth
// segments, 16^3 brick windows, the fits bit, the segmented roll-scan)
// answers Mosaic's missing gather and has no counterpart here.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include <stdint.h>

#include "grid_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;   // samples a block: 8 warps
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_FACTORS = 10;    // the factor form's D: 1 + 3D <= 32 channels

// models/plenoxels.py's SH constants, rounded to float32 as PyTorch rounds
// a Python scalar against a float32 tensor
constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C20 = 1.0925484305920792f, SH_C21 = 1.0925484305920792f,
                SH_C22 = 0.31539156525252005f, SH_C23 = 1.0925484305920792f,
                SH_C24 = 0.5462742152960396f;

// The real SH basis Y_l(d) of a unit direction, L = 1, 4 or 9 (degree 0-2),
// each product and difference rounded in sh_basis's order.
template <int L>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float (&b)[L]) {
  b[0] = SH_C0;
  if constexpr (L >= 4) {
    b[1] = __fmul_rn(-SH_C1, y);
    b[2] = __fmul_rn(SH_C1, z);
    b[3] = __fmul_rn(-SH_C1, x);
  }
  if constexpr (L >= 9) {
    b[4] = __fmul_rn(__fmul_rn(SH_C20, x), y);
    b[5] = __fmul_rn(__fmul_rn(-SH_C21, y), z);
    b[6] = __fmul_rn(SH_C22, __fsub_rn(__fmul_rn(__fmul_rn(3.0f, z), z), 1.0f));
    b[7] = __fmul_rn(__fmul_rn(-SH_C23, x), z);
    b[8] = __fmul_rn(SH_C24, __fsub_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(grid::FULL, v, o));
  return v;
}

// FACTORS false: the SH form of degree 0-2 (L = 1, 4, 9 basis terms),
// `ray_in` the view directions (num_rays, 3); true: the factor form of L = D
// factors, `ray_in` beta (num_rays, D). C = 1 + 3L channels in both.
template <bool BF16, int L, bool FACTORS>
__global__ void __launch_bounds__(MAX_THREADS, 2)
grid_render_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                   const float* __restrict__ ray_in, const float* __restrict__ t,
                   float scale, float off, const void* __restrict__ g, int r, int s_len,
                   float* __restrict__ rgb_out, float* __restrict__ acc_out,
                   float* __restrict__ depth_out, float* __restrict__ w_out) {
  constexpr int C = 1 + 3 * L;
  __shared__ float part_t[MAX_WARPS];        // each warp's product of 1 - alpha
  __shared__ float part_q[MAX_WARPS][5];     // and its sums of rgb, acc, depth
  const int ray = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float top = static_cast<float>(r - 1);
  float oa[3], da[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    oa[a] = __fadd_rn(__fmul_rn(scale, rays_o[3 * ray + a]), off);
    da[a] = __fmul_rn(scale, rays_d[3 * ray + a]);
  }
  float basis[L];
  if constexpr (FACTORS) {
#pragma unroll
    for (int d = 0; d < L; ++d) basis[d] = ray_in[L * ray + d];
  } else {
    sh_basis<L>(ray_in[3 * ray], ray_in[3 * ray + 1], ray_in[3 * ray + 2], basis);
  }
  const float* tr = t + static_cast<long long>(ray) * s_len;
  float* wr = w_out + static_cast<long long>(ray) * s_len;
  float carry = 1.0f;                        // T at the block's first sample
  float sums[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < s_len; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const bool live = s < s_len;
    float ts = 0.0f, one_m = 1.0f, col[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      ts = tr[s];
      const float delta = s + 1 < s_len ? __fsub_rn(tr[s + 1], ts) : 1e10f;
      float gc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        gc[a] = fminf(fmaxf(__fadd_rn(oa[a], __fmul_rn(da[a], ts)), 0.0f), top);
      long long base;
      float w8[8], v[C];
      grid::stencil<BF16>(gc[0], gc[1], gc[2], r, base, w8);
      grid::interp_row<BF16, C>(g, r, base, w8, v);
      const float sigma = FACTORS ? fmaxf(v[0], 0.0f)
                                  : __fadd_rn(fmaxf(v[0], 0.0f), log1pf(expf(-fabsf(v[0]))));
      one_m = expf(__fmul_rn(-sigma, delta));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float pre = 0.0f;
#pragma unroll
        for (int l = 0; l < L; ++l)
          pre = __fadd_rn(pre, __fmul_rn(v[FACTORS ? 1 + 3 * l + c : 1 + c * L + l], basis[l]));
        col[c] = 1.0f / (1.0f + expf(-pre));
      }
    }
    // T_s: an inclusive product scan over the warp, shifted by one lane
    float inc = one_m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(grid::FULL, inc, o);
      if (lane >= o) inc = __fmul_rn(inc, y);
    }
    float excl = __shfl_up_sync(grid::FULL, inc, 1);
    if (lane == 0) excl = 1.0f;
    if (lane == 31) part_t[warp] = inc;
    __syncthreads();
    float before = carry;
    for (int j = 0; j < warp; ++j) before = __fmul_rn(before, part_t[j]);
    const float wgt = live ? __fmul_rn(__fmul_rn(before, excl), __fsub_rn(1.0f, one_m)) : 0.0f;
    if (live) wr[s] = wgt;
    const float q[5] = {__fmul_rn(wgt, col[0]), __fmul_rn(wgt, col[1]), __fmul_rn(wgt, col[2]),
                        wgt, __fmul_rn(wgt, ts)};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float qs = warp_sum(q[k]);
      if (lane == 0) part_q[warp][k] = qs;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < warps; ++j)
#pragma unroll
        for (int k = 0; k < 5; ++k) sums[k] = __fadd_rn(sums[k], part_q[j][k]);
    }
    for (int j = 0; j < warps; ++j) carry = __fmul_rn(carry, part_t[j]);
    __syncthreads();                         // part_* are rewritten next block
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb_out[3 * ray + k] = sums[k];
    acc_out[ray] = sums[3];
    depth_out[ray] = sums[4];
  }
}

template <bool BF16, int L, bool FACTORS>
void launch(int num_rays, int threads, cudaStream_t s, const float* o, const float* d,
            const float* ray_in, const float* t, float scale, float off, const void* g, int r,
            int s_len, float* rgb, float* acc, float* depth, float* w) {
  grid_render_kernel<BF16, L, FACTORS><<<num_rays, threads, 0, s>>>(
      o, d, ray_in, t, scale, off, g, r, s_len, rgb, acc, depth, w);
}

// The factor form of K factors, for K = D down to 1.
template <bool BF16, int K>
void launch_factors(int k, int num_rays, int threads, cudaStream_t s, const float* o,
                    const float* d, const float* ray_in, const float* t, float scale, float off,
                    const void* g, int r, int s_len, float* rgb, float* acc, float* depth,
                    float* w) {
  if (k == K)
    launch<BF16, K, true>(num_rays, threads, s, o, d, ray_in, t, scale, off, g, r, s_len, rgb,
                          acc, depth, w);
  else if constexpr (K > 1)
    launch_factors<BF16, K - 1>(k, num_rays, threads, s, o, d, ray_in, t, scale, off, g, r,
                                s_len, rgb, acc, depth, w);
}

// `k`: the SH degree (form 0) or the factor count D (form 1).
template <bool BF16>
void launch_form(int form, int k, int num_rays, int threads, cudaStream_t s, const float* o,
                 const float* d, const float* ray_in, const float* t, float scale, float off,
                 const void* g, int r, int s_len, float* rgb, float* acc, float* depth,
                 float* w) {
  if (form == 1)
    launch_factors<BF16, MAX_FACTORS>(k, num_rays, threads, s, o, d, ray_in, t, scale, off, g,
                                      r, s_len, rgb, acc, depth, w);
  else if (k == 0)
    launch<BF16, 1, false>(num_rays, threads, s, o, d, ray_in, t, scale, off, g, r, s_len, rgb,
                           acc, depth, w);
  else if (k == 1)
    launch<BF16, 4, false>(num_rays, threads, s, o, d, ray_in, t, scale, off, g, r, s_len, rgb,
                           acc, depth, w);
  else
    launch<BF16, 9, false>(num_rays, threads, s, o, d, ray_in, t, scale, off, g, r, s_len, rgb,
                           acc, depth, w);
}

}  // namespace

extern "C" {

// Per ray: `rays_o`, `rays_d` (num_rays, 3), `ray_in` the decode's input
// (form 0, SH: the view directions (num_rays, 3); form 1, factors: beta
// (num_rays, k)), `t` (num_rays, s_len) sorted sample depths; `scale`, `off`
// the ray -> cell affine; `grid` the (r, r, r, c) grid (float32, or its
// bfloat16 copy when `bf16`), 16-byte aligned, of the form's layout: SH of
// degree k (0-2), c = 1 + 3 (k + 1)^2, channel 1 + colour * L + l; factors,
// k = D (1-10), c = 1 + 3D, channel 1 + 3d + colour. Outputs rgb
// (num_rays, 3), acc and depth (num_rays,), weights (num_rays, s_len), all
// float32. Returns 0 on success, a cudaError_t code after a failed launch,
// or -1 when the shapes do not fit this kernel.
int grid_render(const float* rays_o, const float* rays_d, const float* ray_in,
                const float* t, float scale, float off, const void* grid, int r, int c,
                int form, int k, int bf16, int num_rays, int s_len, float* rgb, float* acc,
                float* depth, float* weights, void* stream) {
  const bool sh_ok = form == 0 && k >= 0 && k <= 2 && c == 1 + 3 * (k + 1) * (k + 1);
  const bool factors_ok = form == 1 && k >= 1 && k <= MAX_FACTORS && c == 1 + 3 * k;
  if (!(sh_ok || factors_ok) || r < 2 || num_rays < 1 || s_len < 1 ||
      reinterpret_cast<uintptr_t>(grid) % 16 != 0)
    return -1;
  const int warps = min(MAX_WARPS, (s_len + 31) / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_form<true>(form, k, num_rays, 32 * warps, s, rays_o, rays_d, ray_in, t, scale, off,
                      grid, r, s_len, rgb, acc, depth, weights);
  else
    launch_form<false>(form, k, num_rays, 32 * warps, s, rays_o, rays_d, ray_in, t, scale, off,
                       grid, r, s_len, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

const char* grid_render_error(int code) {
  if (code == -1)
    return "shapes do not fit the kernel (an SH grid of degree 0-2: C = 1 + 3 (degree + 1)^2 "
           "<= 28 channels, or a factor grid of D = 1-10: C = 1 + 3D <= 31 channels; R >= 2; "
           "a 16-byte aligned grid)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
