// Fused grid render for Hopper (sm_90a): trilinear interpolation of a
// voxel grid at every sample of a ray, the density activation, the colour
// decode and volume compositing, in one kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_grid_render.py::_grid_render_kernel
// (class FusedGridRender). Same function, per ray and sample s:
//   g_a    = clamp(o'_a + d'_a * t_s, 0, R - 1)   the folded ray -> cell
//            affine (o' = scale * o + off, d' = scale * d; _cells)
//   v      = trilinear(grid, g)                   grid_common.cuh, float32
//            or the bfloat16 mode
//   sigma  = softplus(v_0) = max(v_0, 0) + log1p(exp(-|v_0|))
//   rgb_c  = sigmoid(sum over channels ch with sel[ch] = c of v_ch * b_ch),
//            b the ray's channel-expanded basis (_expand_basis: Y_lm(d) for
//            the SH layout, channel 1 + c*L + l -> colour c; _sh_sel)
//   1 - alpha = exp(-sigma * delta_s), delta_s = t_{s+1} - t_s, 1e10 last
//   w_s    = T_s * alpha_s, T_{s+1} = T_s * (1 - alpha_s), T_0 = 1
// and the outputs rgb = sum w_s rgb_s, acc = sum w_s, depth = sum w_s t_s
// and the (R, S) weights. The white background is the caller's. (The TPU
// kernel's relu density and factor layout serve the baked FastNeRF cache,
// which is not ported yet.)
//
// What bounds it on this card: bytes. A ray reads its affine (24 bytes),
// its basis (128) and its S samples' t (4 each) and writes its weights (4
// each) and 20 bytes of results; the grid rows its samples touch are read
// at least once (at most R^3 rows). At 1024 rays x 256 samples of a 128^3 x
// 28 grid: 2.3 MB plus the distinct rows touched.
//
// Design: one warp per ray, the lanes over channels, and the warp walks its
// samples in order carrying the transmittance, as the TPU kernel carries it
// across depth segments; each sample is the shared interpolation (eight
// independent row loads a lane), the density from lane 0 by a shuffle, the
// colour by 32 shuffles in channel order, and the compositing step, which
// every lane computes alike. A warp loads 32 samples' t at a time and
// broadcasts them. The TPU kernel's plan (8x8-ray tiles over depth
// segments, 16^3 brick windows, the fits bit, the segmented roll-scan)
// answers Mosaic's missing gather and is not ported: the caller's tile
// order (tile_ray_order) makes consecutive warps' rays neighbours in space,
// so an 8x8 pixel block is eight consecutive CTAs of 8 warps that share
// corner rows in L2. (One CTA of 64 warps would exceed 1024 threads, and a
// 1024-ray launch would then fill 16 of the 132 SMs.)
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "grid_common.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps, one ray each

struct Sel {
  signed char col[grid::LANES];   // colour of each channel, -1 for none
};

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
grid_render_kernel(const float* __restrict__ o_aff, const float* __restrict__ d_aff,
                   const float* __restrict__ t, const float* __restrict__ bexp, Sel sel,
                   const void* __restrict__ g, int r, int c, int num_rays, int s_len,
                   float* __restrict__ rgb_out, float* __restrict__ acc_out,
                   float* __restrict__ depth_out, float* __restrict__ w_out) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (ray >= num_rays) return;
  const float top = static_cast<float>(r - 1);
  float oa[3], da[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    oa[a] = o_aff[3 * ray + a];
    da[a] = d_aff[3 * ray + a];
  }
  const float basis = (lane < c) ? bexp[static_cast<long long>(ray) * grid::LANES + lane] : 0.0f;
  const float* tr = t + static_cast<long long>(ray) * s_len;
  float* wr = w_out + static_cast<long long>(ray) * s_len;
  float trans = 1.0f, acc = 0.0f, depth = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < s_len; s0 += 32) {
    const int si = s0 + lane;
    const float tl = (si < s_len) ? tr[si] : 0.0f;
    const float tn = (si + 1 < s_len) ? tr[si + 1] : 0.0f;
    const float dl = (si + 1 < s_len) ? __fsub_rn(tn, tl) : 1e10f;
    const int count = min(32, s_len - s0);
    for (int j = 0; j < count; ++j) {
      const float ts = __shfl_sync(grid::FULL, tl, j);
      const float delta = __shfl_sync(grid::FULL, dl, j);
      float gc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        gc[a] = fminf(fmaxf(__fadd_rn(oa[a], __fmul_rn(da[a], ts)), 0.0f), top);
      long long base;
      float w8[8];
      grid::stencil<BF16>(gc[0], gc[1], gc[2], r, base, w8);
      const float v = grid::interp_lane<BF16>(g, r, c, base, w8, lane);
      const float sraw = __shfl_sync(grid::FULL, v, 0);
      const float prod = __fmul_rn(v, basis);
      float pre[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ch = 0; ch < grid::LANES; ++ch) {
        const float x = __shfl_sync(grid::FULL, prod, ch);
        const int col = sel.col[ch];
#pragma unroll
        for (int k = 0; k < 3; ++k)   // + 0.0f leaves a sum unchanged
          pre[k] = __fadd_rn(pre[k], col == k ? x : 0.0f);
      }
      const float sigma = __fadd_rn(fmaxf(sraw, 0.0f), log1pf(expf(-fabsf(sraw))));
      const float one_m = expf(__fmul_rn(-sigma, delta));
      const float w = __fmul_rn(trans, __fsub_rn(1.0f, one_m));
      trans = __fmul_rn(trans, one_m);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[k] = __fadd_rn(rgb[k], __fmul_rn(w, 1.0f / (1.0f + expf(-pre[k]))));
      acc = __fadd_rn(acc, w);
      depth = __fadd_rn(depth, __fmul_rn(w, ts));
      if (lane == 0) wr[s0 + j] = w;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb_out[3 * ray + k] = rgb[k];
    acc_out[ray] = acc;
    depth_out[ray] = depth;
  }
}

}  // namespace

extern "C" {

// Per ray: `o_aff`, `d_aff` (num_rays, 3) the folded affine, `bexp`
// (num_rays, 32) the channel-expanded basis; `t` (num_rays, s_len) sorted
// sample depths; `sel` 32 colour indices (-1: the channel has none); `grid`
// the (r, r, r, c) grid (float32, or its bfloat16 copy when `bf16`).
// Outputs rgb (num_rays, 3), acc and depth (num_rays,), weights (num_rays,
// s_len), all float32. Returns 0 on success, a cudaError_t code after a
// failed launch, or -1 when the shapes do not fit this kernel.
int grid_render(const float* o_aff, const float* d_aff, const float* t, const float* bexp,
                const signed char* sel, const void* grid, int r, int c, int bf16, int num_rays,
                int s_len, float* rgb, float* acc, float* depth, float* weights, void* stream) {
  if (c < 1 || c > grid::LANES || r < 2 || num_rays < 1 || s_len < 1) return -1;
  Sel sl;
  for (int i = 0; i < grid::LANES; ++i) {
    sl.col[i] = sel[i];
    if (sl.col[i] > 2 || (sl.col[i] >= 0 && i >= c)) return -1;
  }
  const int ctas = (num_rays + THREADS / 32 - 1) / (THREADS / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    grid_render_kernel<true><<<ctas, THREADS, 0, s>>>(o_aff, d_aff, t, bexp, sl, grid, r, c,
                                                      num_rays, s_len, rgb, acc, depth, weights);
  else
    grid_render_kernel<false><<<ctas, THREADS, 0, s>>>(o_aff, d_aff, t, bexp, sl, grid, r, c,
                                                       num_rays, s_len, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

const char* grid_render_error(int code) {
  if (code == -1)
    return "shapes do not fit the kernel (1 <= C <= 32 channels, R >= 2, colour map of "
           "channels < C onto 0..2)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
