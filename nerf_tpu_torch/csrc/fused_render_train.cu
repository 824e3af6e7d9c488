// Fused NeRF train pass and render backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of nerf_tpu/ops/pallas/fused_render.py:
//   * _train_kernel (FusedNerfRender.train): forward, white-background MSE
//     (loss partial and its analytic per-ray cotangent, _mse_cotangent),
//     the backward through compositing (_composite_bwd) and the MLP
//     backward (fused_nerf.py::_mlp_bwd_core without input gradients),
//     one pass over the rays;
//   * _bwd_kernel (the custom VJP of FusedNerfRender.__call__): the same,
//     with the per-ray cotangent [g_rgb, g_acc, g_depth] given instead of
//     the MSE head, and the depth cotangent reaching dL/dw as g_depth * t.
// Both give the 28 float32 weight gradients of the packed layout
// (fused_render_common.cuh), the train pass also the loss, rgb, acc and the
// compositing weights. One template body, two entry points.
//
// What bounds it on this card: operations. A sample costs the forward's
// 658,944 MACs plus twice that for the backward, less the three products
// the TPU kernel also skips (dz1 w1^T, dz6 w6p^T, dzr0 wr0d^T): about 1.95M
// MACs. float32 mode runs on the CUDA cores (67 TFLOP/s); bfloat16 mode
// rounds at the TPU kernel's points and sums in float32, also on the CUDA
// cores in this first version (its bound is the tensor cores' 989 TFLOP/s).
//
// Design. The TPU kernel keeps a whole-ray tile's activations in VMEM and
// adds into one gradient block across a grid that runs in order. Neither
// holds here: a 64-point chunk's eleven activations are ~700 KB against
// 227 KB of shared memory, a ray of 192 samples spans several chunks whose
// cotangent needs the whole ray first, and CTAs run in no order.
//   1. Forward (as fused_render_fwd.cu, chunk by chunk over the CTA's whole
//      rays) that also stashes every activation, point-major, in a per-CTA
//      scratch area in device memory (~13 KB per point; L2 and HBM). No
//      forward is recomputed: three forward-equivalents of work, as on the
//      TPU.
//   2. One thread per ray: transmittance, weights and ray sums, the
//      cotangent (MSE head or the given one), then the compositing
//      backward in reverse sample order (the suffix sum of g_w * w).
//   3. The MLP backward layer by layer over all of the CTA's points: each
//      dz (points x 256, float32, unrounded) is computed chunk by chunk
//      into the next scratch buffer (dz W^T on the same register-tiled
//      gemm as the forward, against transposed weights), and each weight
//      gradient is one product A^T dz over all the CTA's points with its
//      64 x 256 output strip in registers, so every gradient element is
//      written once per CTA. Bias and w10s gradients are column sums.
//   4. A second small kernel adds the per-CTA partials (and loss terms) in
//      CTA order. Nothing is atomic, so a step is deterministic from run to
//      run.
// Rounding in bfloat16 mode follows _mlp_bwd_core: both operands of every
// dW product and the dz of every dz W^T are rounded to bf16, sums are
// float32, the bias, w10s and b10s gradients are float32 sums of the
// unrounded values, and h9, sigma_pre and the rgb sigmoid are read in
// float32.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_common.cuh"

namespace {

using namespace nerf;

constexpr int N_TOT = N_W + N_B;                 // gradient floats
constexpr int NPART = (N_TOT + 1 + 3) / 4 * 4;   // per-CTA: gradients, loss
constexpr int N_COLS = 12;                       // per-point columns (C_*)
constexpr int FLOATS_PER_POINT = 9 * H + H + HR + PP + PP + 2 * LDZ + N_COLS;
static_assert(FLOATS_PER_POINT % 4 == 0, "stash rows must stay 16-byte aligned");

struct Scratch {
  Stash st;
  float* dz[2];
  float* cols;            // N_COLS x cap
};

__device__ Scratch carve(float* p, int cap) {
  Scratch s;
  const size_t c = static_cast<size_t>(cap);
  for (int i = 0; i < 9; ++i) { s.st.h[i] = p; p += c * H; }
  s.st.feat = p; p += c * H;
  s.st.y = p; p += c * HR;
  s.st.penc = p; p += c * PP;
  s.st.denc = p; p += c * PP;
  s.dz[0] = p; p += c * LDZ;
  s.dz[1] = p; p += c * LDZ;
  s.cols = p;
  s.st.sigma_pre = p + C_SIGP * c;
  s.st.rgb = p + C_RGB * c;
  s.st.cap = cap;
  return s;
}

// One hidden layer of the backward: from cur = dz_L, the next dz
// (dz_L W_L^T masked by h_prev > 0) into nxt, dW_L = h_prev^T dz_L and
// db_L = sum dz_L.
template <bool BF16, typename WT>
__device__ void back_layer(const float* cur, const WT* __restrict__ wT,
                           const float* h_prev, float* nxt, float* part_w,
                           float* part_b, int cap_c, float* smem) {
  if (nxt != nullptr)
    dact<H, BF16, Epi::Relu, false>(cur, wT, h_prev, H, nullptr, nullptr, 1.f, nxt,
                                    cap_c, smem, reinterpret_cast<WT*>(smem + SM_WST));
  dweight<2, false, BF16>(h_prev, H, H, H, cur, cap_c, part_w, smem);
  colsum(cur, H, cap_c, part_b);
  __syncthreads();
}

template <bool BF16, bool TRAIN, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
fused_render_grad_kernel(RayInputs in, const WT* __restrict__ wmat,
                         const WT* __restrict__ wmat_t,
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

  // ---- 1. forward, stashing every activation ----
  for (int c0 = 0; c0 < npts; c0 += P)
    forward_chunk<BF16, true>(in, wmat, ray0 * S + c0, min(P, npts - c0), smem,
                              sc.st, static_cast<size_t>(c0));

  // ---- 2. compositing, cotangent, compositing backward (thread per ray) ----
  float* lossr = smem + SM_ACT1;
  composite_rays<TRAIN>(in, ray0, nr, cap_c, cols, cz, 1.f, 1.f, given, white_bg,
                        scale, rgb_out, acc_out, weights_out, lossr);
  if (tid == 0) {
    float s = 0.f;
    if (TRAIN)
      for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }

  // ---- 3. MLP backward, layer by layer over the CTA's points ----
  const float* dsig = cols + C_DSIG * cz;
  const float* h9 = sc.st.h[8];
  float* dzA = sc.dz[0];
  float* dzB = sc.dz[1];
  float* pvec = part + N_W;
  // rgb output layer: dy = dzr1 wr1^T (3 live columns), dzr0 = dy * (y > 0)
  for (int idx = tid; idx < cap_c * HR; idx += THREADS) {
    const int l = idx / HR, k = idx % HR;
    float dy = 0.f;
    for (int c = 0; c < 3; ++c) {
      float d = cols[(C_DZR1 + c) * cz + l];
      if (BF16) d = round_bf16(d);
      dy = fmaf(d, load1(wmat + OFF_WR1 + k * 8 + c), dy);
    }
    dzA[static_cast<size_t>(l) * LDZ + k] =
        sc.st.y[static_cast<size_t>(l) * HR + k] > 0.f ? dy : 0.f;
  }
  for (int o = tid; o < HR * 8; o += THREADS) {
    const int k = o / 8, c = o % 8;
    float s = 0.f;
    if (c < 3) {
      for (int l = 0; l < cap_c; ++l) {
        float d = cols[(C_DZR1 + c) * cz + l];
        if (BF16) d = round_bf16(d);
        s = fmaf(sc.st.y[static_cast<size_t>(l) * HR + k], d, s);
      }
    }
    part[OFF_WR1 + o] = s;
  }
  for (int c = tid; c < 8; c += THREADS) {
    float s = 0.f;
    if (c < 3)
      for (int l = 0; l < cap_c; ++l) s += cols[(C_DZR1 + c) * cz + l];
    pvec[OFF_BR1 + c] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l) s += dsig[l];
    pvec[OFF_B10S] = s;
  }
  for (int k = tid; k < H; k += THREADS) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l)
      s = fmaf(h9[static_cast<size_t>(l) * H + k], dsig[l], s);
    pvec[OFF_W10S + k] = s;
  }
  __syncthreads();
  // rgb hidden layer: dfeat = dzr0 wr0f^T; wr0f, wr0d, br0
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  dact<HR, BF16, Epi::None, false>(dzA, wmat_t + OFF_WR0F, nullptr, 0, nullptr,
                                   nullptr, 1.f, dzB, cap_c, smem, wst);
  dweight<1, false, BF16>(sc.st.feat, H, H, H, dzA, cap_c, part + OFF_WR0F, smem);
  dweight<1, false, BF16>(sc.st.denc, PP, PP, DP, dzA, cap_c, part + OFF_WR0D, smem);
  colsum(dzA, HR, cap_c, pvec + OFF_BR0);
  __syncthreads();
  // feature head: dz9 = (dfeat w10f^T + dsig w10s) * (h9 > 0); w10f, b10f
  dact<H, BF16, Epi::Relu, true>(dzB, wmat_t + OFF_W10F, h9, H, dsig, vec + OFF_W10S,
                                 1.f, dzA, cap_c, smem, wst);
  dweight<2, BF16, BF16>(h9, H, H, H, dzB, cap_c, part + OFF_W10F, smem);
  colsum(dzB, H, cap_c, pvec + OFF_B10F);
  __syncthreads();
  // block2 and block1
  back_layer<BF16>(dzA, wmat_t + OFF_W9, sc.st.h[7], dzB, part + OFF_W9, pvec + 8 * H, cap_c, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W8, sc.st.h[6], dzA, part + OFF_W8, pvec + 7 * H, cap_c, smem);
  back_layer<BF16>(dzA, wmat_t + OFF_W7, sc.st.h[5], dzB, part + OFF_W7, pvec + 6 * H, cap_c, smem);
  // the skip layer: dz5 from w6h; w6h from h5, w6p from the position encoding
  dweight<2, false, BF16>(sc.st.penc, PP, PP, PP, dzB, cap_c, part + OFF_W6P, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W6H, sc.st.h[4], dzA, part + OFF_W6H, pvec + 5 * H, cap_c, smem);
  back_layer<BF16>(dzA, wmat_t + OFF_W5, sc.st.h[3], dzB, part + OFF_W5, pvec + 4 * H, cap_c, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W4, sc.st.h[2], dzA, part + OFF_W4, pvec + 3 * H, cap_c, smem);
  back_layer<BF16>(dzA, wmat_t + OFF_W3, sc.st.h[1], dzB, part + OFF_W3, pvec + 2 * H, cap_c, smem);
  back_layer<BF16>(dzB, wmat_t + OFF_W2, sc.st.h[0], dzA, part + OFF_W2, pvec + 1 * H, cap_c, smem);
  // first layer: w1 from the position encoding, no input gradient
  dweight<2, false, BF16>(sc.st.penc, PP, PP, PP, dzA, cap_c, part + OFF_W1, smem);
  colsum(dzA, H, cap_c, pvec + 0 * H);
}

template <bool BF16, bool TRAIN, typename WT>
int launch(const RayInputs& in, const void* wmat, const void* wmat_t,
           const float* given, float white_bg, float scale, int rays_per_cta,
           int cap, float* scratch, float* partial, float* out, float* rgb,
           float* acc, float* weights, cudaStream_t stream) {
  auto kernel = fused_render_grad_kernel<BF16, TRAIN, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (in.num_rays + rays_per_cta - 1) / rays_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      in, static_cast<const WT*>(wmat), static_cast<const WT*>(wmat_t), given,
      white_bg, scale, rays_per_cta, cap, scratch, partial, rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, stream>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the caller allocates: scratch floats per stashed point, floats per
// CTA partial, floats of the output (the gradients, then the loss).
void fused_render_grad_sizes(int* floats_per_point, int* npart, int* n_out) {
  *floats_per_point = FLOATS_PER_POINT;
  *npart = NPART;
  *n_out = N_TOT + 1;
}

// train != 0: `given` is the (R, 3) target and rgb/acc/weights are written;
// train == 0: `given` is the (R, 8) cotangent [g_rgb, g_acc, g_depth, 0..]
// and only the gradients are. `scratch` holds grid * cap * floats_per_point
// floats, `partial` grid * npart, `out` n_out, where grid =
// ceil(num_rays / rays_per_cta) and cap >= ceil(rays_per_cta * S / 64) * 64.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_render_grad(const float* o_aff, const float* d_aff,
                      const float* viewdirs, const float* t, const void* wmat,
                      const void* wmat_t, const float* vec, int n_w, int n_b,
                      int bf16, int train, const float* given, float white_bg,
                      float scale, int num_rays, int S, int rays_per_cta,
                      int cap, int real_p, int real_d, float* scratch,
                      float* partial, float* out, float* rgb, float* acc,
                      float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || rays_per_cta > H * LDA || real_p > PP ||
      real_d > DP || cap % P != 0 || cap < (rays_per_cta * S + P - 1) / P * P)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, real_p, real_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (train)
      return launch<true, true, __nv_bfloat16>(in, wmat, wmat_t, given, white_bg,
                                               scale, rays_per_cta, cap, scratch,
                                               partial, out, rgb, acc, weights, s);
    return launch<true, false, __nv_bfloat16>(in, wmat, wmat_t, given, white_bg,
                                              scale, rays_per_cta, cap, scratch,
                                              partial, out, rgb, acc, weights, s);
  }
  if (train)
    return launch<false, true, float>(in, wmat, wmat_t, given, white_bg, scale,
                                      rays_per_cta, cap, scratch, partial, out,
                                      rgb, acc, weights, s);
  return launch<false, false, float>(in, wmat, wmat_t, given, white_bg, scale,
                                     rays_per_cta, cap, scratch, partial, out,
                                     rgb, acc, weights, s);
}

const char* fused_render_grad_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
