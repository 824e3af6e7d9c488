// Fused SIREN train pass and render backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of nerf_tpu/ops/pallas/fused_render_siren.py:
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
// wanted): 1,681,536 MACs, and 2,176 sines and as many cosines. float32
// mode runs on the CUDA cores (67 TFLOP/s); bfloat16 mode rounds at the TPU
// kernel's points and sums in float32, also on the CUDA cores in this first
// version (its bound is the tensor cores' 989 TFLOP/s).
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
// Rounding in bfloat16 mode follows _mlp_bwd_core: both operands of every
// dW product and the dz of every dz W^T are rounded to bf16, sums are
// float32, the bias, ws and bs gradients are float32 sums of the unrounded
// values, and h8, sigma_pre and the rgb sigmoid are read in float32.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_render_siren_common.cuh"

namespace {

using namespace siren;

constexpr int N_TOT = N_W + N_B;                 // gradient floats
constexpr int NPART = (N_TOT + 1 + 3) / 4 * 4;   // per-CTA: gradients, loss
constexpr int C_POS = 11;                        // after the shared C_* columns
constexpr int N_COLS = 16;
constexpr int FLOATS_PER_POINT =
    2 * NL * H + H + 2 * HR + DENC_LD + 2 * LDZ + N_COLS;
static_assert(FLOATS_PER_POINT % 4 == 0, "stash rows must stay 16-byte aligned");
static_assert(C_POS > C_DSIG && C_POS + 3 <= N_COLS, "column plan");

struct Scratch {
  Stash st;
  float* dz[2];
  float* cols;            // N_COLS x cap
};

__device__ Scratch carve(float* p, int cap) {
  Scratch s;
  const size_t c = static_cast<size_t>(cap);
  for (int i = 0; i < NL; ++i) { s.st.h[i] = p; p += c * H; }
  for (int i = 0; i < NL; ++i) { s.st.c[i] = p; p += c * H; }
  s.st.feat = p; p += c * H;
  s.st.y = p; p += c * HR;
  s.st.cr0 = p; p += c * HR;
  s.st.denc = p; p += c * DENC_LD;
  s.dz[0] = p; p += c * LDZ;
  s.dz[1] = p; p += c * LDZ;
  s.cols = p;
  s.st.sigma_pre = p + C_SIGP * c;
  s.st.rgb = p + C_RGB * c;
  s.st.pos = p + C_POS * c;
  s.st.cap = cap;
  return s;
}

// One sine layer of the backward, l = 8..2: from cur = dz_l, the next
// dz_{l-1} = ((dz_l W_l^T) * w0_{l-1}) * cos(w0_{l-1} z_{l-1}) into nxt,
// dW_l = h_{l-1}^T dz_l and db_l = sum dz_l.
template <bool BF16, typename WT>
__device__ void back_layer(const float* cur, const WT* __restrict__ wT,
                           const float* h_prev, const float* c_prev, float w0_prev,
                           float* nxt, float* part_w, float* part_b, int cap_c,
                           float* smem) {
  dact<H, BF16, Epi::Cos, false>(cur, wT, c_prev, H, nullptr, nullptr, w0_prev, nxt,
                                 cap_c, smem, reinterpret_cast<WT*>(smem + SM_WST));
  dweight<2, false, BF16>(h_prev, H, H, H, cur, cap_c, part_w, smem);
  colsum(cur, H, cap_c, part_b);
  __syncthreads();
}

template <bool BF16, bool TRAIN, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
fused_siren_grad_kernel(RayInputs in, Siren sp, const WT* __restrict__ wmat,
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

  // ---- 1. forward, stashing what the backward needs ----
  for (int c0 = 0; c0 < npts; c0 += P)
    forward_chunk<BF16, true>(in, wmat, sp, ray0 * S + c0, min(P, npts - c0), smem,
                              sc.st, static_cast<size_t>(c0));

  // ---- 2. compositing, cotangent, compositing backward (thread per ray) ----
  float* lossr = smem + SM_ACT1;
  composite_rays<TRAIN>(in, ray0, nr, cap_c, cols, cz, sp.sigma_mul, sp.rgb_mul,
                        given, white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (tid == 0) {
    float s = 0.f;
    if (TRAIN)
      for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }

  // ---- 3. MLP backward, layer by layer over the CTA's points ----
  const float* dsig = cols + C_DSIG * cz;
  const float* h8 = sc.st.h[NL - 1];
  float* dzA = sc.dz[0];
  float* dzB = sc.dz[1];
  float* pvec = part + N_W;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);
  // rgb output layer: dy = dzr1 wr1^T (3 live columns),
  // dzr0 = (dy * w0h) * cos(w0h zr0)
  for (int idx = tid; idx < cap_c * HR; idx += THREADS) {
    const int l = idx / HR, k = idx % HR;
    float dy = 0.f;
    for (int c = 0; c < 3; ++c) {
      float d = cols[(C_DZR1 + c) * cz + l];
      if (BF16) d = round_bf16(d);
      dy = fmaf(d, load1(wmat + OFF_WR1 + k * 8 + c), dy);
    }
    dzA[static_cast<size_t>(l) * LDZ + k] =
        (dy * sp.w0h) * sc.st.cr0[static_cast<size_t>(l) * HR + k];
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
    pvec[OFF_BS] = s;
  }
  for (int k = tid; k < H; k += THREADS) {
    float s = 0.f;
    for (int l = 0; l < cap_c; ++l)
      s = fmaf(h8[static_cast<size_t>(l) * H + k], dsig[l], s);
    pvec[OFF_WS + k] = s;
  }
  __syncthreads();
  // rgb sine layer: dfeat = dzr0 wr0f^T; wr0f, wr0d, br0
  dact<HR, BF16, Epi::None, false>(dzA, wmat_t + OFF_WR0F, nullptr, 0, nullptr,
                                   nullptr, 1.f, dzB, cap_c, smem, wst);
  dweight<1, false, BF16>(sc.st.feat, H, H, H, dzA, cap_c, part + OFF_WR0F, smem);
  dweight<1, false, BF16>(sc.st.denc, DENC_LD, DENC_LD, DP, dzA, cap_c,
                          part + OFF_WR0D, smem);
  colsum(dzA, HR, cap_c, pvec + OFF_BR0);
  __syncthreads();
  // feature remap: dz8 = ((dfeat wre^T + dsig ws) * w0h) * cos(w0h z8);
  // wre from the unrounded h8, bre
  dact<H, BF16, Epi::Cos, true>(dzB, wmat_t + OFF_WRE, sc.st.c[NL - 1], H, dsig,
                                vec + OFF_WS, sp.w0h, dzA, cap_c, smem, wst);
  dweight<2, BF16, BF16>(h8, H, H, H, dzB, cap_c, part + OFF_WRE, smem);
  colsum(dzB, H, cap_c, pvec + OFF_BRE);
  __syncthreads();
  // sine layers 8..2
  float* cur = dzA;
  float* nxt = dzB;
#pragma unroll 1
  for (int l = NL; l >= 2; --l) {
    back_layer<BF16>(cur, wmat_t + off_w(l), sc.st.h[l - 2], sc.st.c[l - 2],
                     l == 2 ? sp.w0 : sp.w0h, nxt, part + off_w(l),
                     pvec + (l - 1) * H, cap_c, smem);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // first layer: dW1 = pos^T dz1 (rows 3..7 zero), db1; no input gradient
  const float* pos = cols + C_POS * cz;
  for (int n = tid; n < H; n += THREADS) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int l = 0; l < cap_c; ++l) {
      float d = cur[static_cast<size_t>(l) * LDZ + n];
      if (BF16) d = round_bf16(d);
      s0 = fmaf(pos[l], d, s0);
      s1 = fmaf(pos[cz + l], d, s1);
      s2 = fmaf(pos[2 * cz + l], d, s2);
    }
    part[OFF_W1 + 0 * H + n] = s0;
    part[OFF_W1 + 1 * H + n] = s1;
    part[OFF_W1 + 2 * H + n] = s2;
    for (int k = 3; k < 8; ++k) part[OFF_W1 + k * H + n] = 0.f;
  }
  colsum(cur, H, cap_c, pvec + 0 * H);
}

template <bool BF16, bool TRAIN, typename WT>
int launch(const RayInputs& in, const Siren& sp, const void* wmat,
           const void* wmat_t, const float* given, float white_bg, float scale,
           int rays_per_cta, int cap, float* scratch, float* partial, float* out,
           float* rgb, float* acc, float* weights, cudaStream_t stream) {
  auto kernel = fused_siren_grad_kernel<BF16, TRAIN, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (in.num_rays + rays_per_cta - 1) / rays_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      in, sp, static_cast<const WT*>(wmat), static_cast<const WT*>(wmat_t), given,
      white_bg, scale, rays_per_cta, cap, scratch, partial, rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, stream>>>(
      partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, typename WT>
int launch_mode(int train, const RayInputs& in, const Siren& sp, const void* wmat,
                const void* wmat_t, const float* given, float white_bg, float scale,
                int rays_per_cta, int cap, float* scratch, float* partial,
                float* out, float* rgb, float* acc, float* weights,
                cudaStream_t stream) {
  if (train)
    return launch<BF16, true, WT>(in, sp, wmat, wmat_t, given, white_bg, scale,
                                  rays_per_cta, cap, scratch, partial, out, rgb,
                                  acc, weights, stream);
  return launch<BF16, false, WT>(in, sp, wmat, wmat_t, given, white_bg, scale,
                                 rays_per_cta, cap, scratch, partial, out, rgb,
                                 acc, weights, stream);
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

// train != 0: `given` is the (R, 3) target and rgb/acc/weights are written;
// train == 0: `given` is the (R, 8) cotangent [g_rgb, g_acc, g_depth, 0..]
// and only the gradients are. `scratch` holds grid * cap * floats_per_point
// floats, `partial` grid * npart, `out` n_out, where grid =
// ceil(num_rays / rays_per_cta) and cap >= ceil(rays_per_cta * S / 64) * 64.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_siren_grad(const float* o_aff, const float* d_aff,
                     const float* viewdirs, const float* t, const void* wmat,
                     const void* wmat_t, const float* vec, int n_w, int n_b,
                     int bf16, int train, const float* given, float white_bg,
                     float scale, int num_rays, int S, int rays_per_cta, int cap,
                     int real_d, float w0, float w0h, float sigma_mul,
                     float rgb_mul, float* scratch, float* partial, float* out,
                     float* rgb, float* acc, float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || rays_per_cta > H * LDA || real_d > DP ||
      cap % P != 0 || cap < (rays_per_cta * S + P - 1) / P * P)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_mode<true, __nv_bfloat16>(train, in, sp, wmat, wmat_t, given,
                                            white_bg, scale, rays_per_cta, cap,
                                            scratch, partial, out, rgb, acc,
                                            weights, s);
  return launch_mode<false, float>(train, in, sp, wmat, wmat_t, given, white_bg,
                                   scale, rays_per_cta, cap, scratch, partial, out,
                                   rgb, acc, weights, s);
}

const char* fused_siren_grad_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
