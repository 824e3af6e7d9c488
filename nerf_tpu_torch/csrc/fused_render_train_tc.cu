// Fused NeRF train pass in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render.py::_train_kernel
// (FusedNerfRender.train) in bfloat16 mode: the forward of the NeRF MLP
// over a (rays, samples) batch, white-background MSE (loss partial and its
// per-ray cotangent, _mse_cotangent), the backward through compositing
// (_composite_bwd) and the MLP backward (fused_nerf.py::_mlp_bwd_core
// without input gradients), in one pass. It gives the 28 float32 weight
// gradients of the packed layout (fused_render_common.cuh), the loss, rgb,
// acc and the compositing weights. The float32 mode and the render
// backward stay in fused_render_train.cu.
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
// forward chain, shared with the bf16 forward render):
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
static_assert(2 * (SMEM_FWD + 1024) <= 233472, "two forward CTAs share an SM");
constexpr int FWD_SPLIT = 2;       // forward CTAs a backward CTA's points

// Shared memory (bytes) of the backward kernel: two activation tiles (a dz
// chunk, the staged output), a mask tile (the ReLU masks, float32
// [64][LDM] or bf16 [64][LDS]), the weight stages of a dz W^T product, a
// chunk's per-point cotangent columns, a reduction buffer. The weight
// gradients' stages overlay the activation and mask tiles; the per-ray
// losses of the compositing pass the second activation tile.
constexpr int LDM = H + 8;                     // row stride (floats) of the mask
constexpr int BB_ACT0 = 0;
constexpr int BB_ACT1 = BB_ACT0 + TC_P * LDS * 2;
constexpr int BB_MASK = BB_ACT1 + TC_P * LDS * 2;
constexpr int BB_WST = BB_MASK + TC_P * LDM * 4;
constexpr int BB_COL = BB_WST + WST_DACT_BYTES;
constexpr int BB_RED = BB_COL + 4 * TC_P * 4;
constexpr int SMEM_BWD = BB_RED + 4 * THREADS * 4;
static_assert(SMEM_BWD <= 232448, "exceeds the per-block shared memory");
static_assert(DW_STAGE_BYTES <= BB_WST, "weight-gradient stages fit");
constexpr int MAX_RAYS_PER_CTA = TC_P * LDS * 2 / 4;   // per-ray losses in ACT1

// The stash (fused_render_tc_common.cuh::TcStash), `cap` rows each.
constexpr int BYTES_PER_POINT = 2 * (12 * H + HR + PP + DP) + 4 * (H + N_COLS);
static_assert(BYTES_PER_POINT % 16 == 0, "stash rows must stay 16-byte aligned");

__device__ TcStash carve_stash(unsigned char* p, int cap) {
  TcStash s;
  const size_t c = static_cast<size_t>(cap);
  auto take = [&](int cols) {
    bf16* r = reinterpret_cast<bf16*>(p);
    p += c * cols * 2;
    return r;
  };
  for (int i = 0; i < 8; ++i) s.h[i] = take(H);
  s.h9b = take(H);
  s.feat = take(H);
  s.dz[0] = take(H);
  s.dz[1] = take(H);
  s.y = take(HR);
  s.penc = take(PP);
  s.denc = take(DP);
  s.h9f = reinterpret_cast<float*>(p);
  p += c * H * 4;
  s.cols = reinterpret_cast<float*>(p);
  return s;
}

struct BwdSmem {
  bf16* act0;
  bf16* act1;
  void* mask;
  bf16* wst;
  float* col;
  float* red;
};

enum class Mask { None, Bf16, F32 };

// dz_out = EPI(dz_in W^T (+ dsig w10s)) over the CTA's points l < cap_c,
// chunk by chunk: dz_in (KP columns) and dz_out (256) bf16 with stride
// LDZ, W (256 x KP) the packed matrix; EPI the ReLU mask of mref > 0 (bf16
// or float32, 256 columns). Each chunk's dz, mask and dsig are staged into
// shared memory with its first weight tiles. The unrounded values are
// summed by column into colsum (256), in a fixed order; dz_out gets them
// rounded. DSIG (the feature head, whose mask is h9 in float32) also sums
// h9 dsig by column into w10s_out (the w10s gradient). Ends past a
// barrier.
template <int KP, Mask MK, bool DSIG>
__device__ void dact_tc(const bf16* __restrict__ dz_in, const bf16* __restrict__ w,
                        const void* mref, const float* __restrict__ dsig,
                        const float* __restrict__ wsig, bf16* __restrict__ dz_out,
                        float* __restrict__ colsum, float* __restrict__ w10s_out, int cap_c,
                        const BwdSmem& sm) {
  static_assert(!DSIG || MK == Mask::F32, "the w10s sums read h9 in float32");
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = (tid >> 5) * 32;
  const bf16* mask_b = static_cast<const bf16*>(sm.mask);
  const float* mask_f = static_cast<const float*>(sm.mask);
  float cs[4][2] = {}, ws[4][2] = {};
  for (int l0 = 0; l0 < cap_c; l0 += TC_P) {
    constexpr int CPR = KP / 8;
    for (int e = tid; e < TC_P * CPR; e += THREADS) {
      const int r = e / CPR, q = (e % CPR) * 8;
      cp_async16(sm.act0 + r * LDS + q, dz_in + static_cast<size_t>(l0 + r) * LDZ + q);
    }
    if constexpr (MK == Mask::Bf16) {
      const bf16* m = static_cast<const bf16*>(mref);
      for (int e = tid; e < TC_P * (H / 8); e += THREADS) {
        const int r = e / (H / 8), q = (e % (H / 8)) * 8;
        cp_async16(static_cast<bf16*>(sm.mask) + r * LDS + q,
                   m + static_cast<size_t>(l0 + r) * H + q);
      }
    } else if constexpr (MK == Mask::F32) {
      const float* m = static_cast<const float*>(mref);
      for (int e = tid; e < TC_P * (H / 4); e += THREADS) {
        const int r = e / (H / 4), q = (e % (H / 4)) * 4;
        cp_async16(static_cast<float*>(sm.mask) + r * LDM + q,
                   m + static_cast<size_t>(l0 + r) * H + q);
      }
    }
    if constexpr (DSIG) {
      if (tid < TC_P / 4) cp_async16(sm.col + tid * 4, dsig + l0 + tid * 4);
    }
    cp_async_commit();
    float acc[4][4][4];
    zero_acc(acc);
    gemm_dact<KP>(acc, sm.act0, w, sm.wst);
    each_pair<4>(acc, n0, [&](int, int j, int, int row, int col, float& v0, float& v1) {
      float x0 = v0, x1 = v1;
      if constexpr (DSIG) {
        const float ds = sm.col[row];
        x0 = x0 + ds * __ldg(wsig + col);
        x1 = x1 + ds * __ldg(wsig + col + 1);
      }
      if constexpr (MK == Mask::Bf16) {
        const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(mask_b + row * LDS + col);
        x0 = __low2float(m) > 0.f ? x0 : 0.f;
        x1 = __high2float(m) > 0.f ? x1 : 0.f;
      } else if constexpr (MK == Mask::F32) {
        const float2 m = *reinterpret_cast<const float2*>(mask_f + row * LDM + col);
        x0 = m.x > 0.f ? x0 : 0.f;
        x1 = m.y > 0.f ? x1 : 0.f;
        if constexpr (DSIG) {
          const float ds = sm.col[row];
          ws[j][0] = fmaf(m.x, ds, ws[j][0]);
          ws[j][1] = fmaf(m.y, ds, ws[j][1]);
        }
      }
      cs[j][0] += x0;
      cs[j][1] += x1;
      put2(sm.act1 + row * LDS + col, x0, x1);
    });
    __syncthreads();
    tile_out(sm.act1, LDS, H, dz_out, static_cast<size_t>(l0));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = cs[j][u], x = ws[j][u];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      if (lane < 4) {
        colsum[n0 + j * 8 + 2 * lane + u] = v;
        if constexpr (DSIG) w10s_out[n0 + j * 8 + 2 * lane + u] = x;
      }
    }
  __syncthreads();
}

// The packed offset of hidden layer i's matrix (i = 2..9).
__device__ __forceinline__ int hidden_off(int i) {
  switch (i) {
    case 2: return OFF_W2;
    case 3: return OFF_W3;
    case 4: return OFF_W4;
    case 5: return OFF_W5;
    case 6: return OFF_W6H;
    case 7: return OFF_W7;
    case 8: return OFF_W8;
    default: return OFF_W9;
  }
}

// The MLP backward (fused_nerf.py::_mlp_bwd_core without input products)
// over the CTA's points l < cap_c from the stash and the cotangent columns
// dzr1 and dsig, into the CTA's partial (offsets of the packed layout, the
// vectors from N_W).
__device__ void backward(const TcStash& st, int cap, const float* __restrict__ vec,
                         const bf16* __restrict__ wmat, float* __restrict__ part, int cap_c,
                         const BwdSmem& sm) {
  const int tid = threadIdx.x;
  const size_t cz = static_cast<size_t>(cap);
  const float* dsig = st.cols + C_DSIG * cz;
  const float* dzr1 = st.cols + C_DZR1 * cz;
  float* pvec = part + N_W;
  // rgb output layer (CUDA cores), chunk by chunk: dzr0 = (r(dzr1) wr1^T)
  // * (y > 0) to dz[0] (128 columns), with its column sums (br0) and wr1 =
  // r(y)^T r(dzr1) in two halves of each chunk's points; br1 and b10s
  // (the sums of dzr1 and dsig) by four threads over the staged columns
  {
    const int k = tid & (HR - 1), half = tid / HR;
    const float w0 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 0]);
    const float w1 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 1]);
    const float w2 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 2]);
    const bf16* __restrict__ y = st.y;
    bf16* __restrict__ dz0 = st.dz[0];
    float* col_s = sm.col;              // [4][64]: dzr1 (3), dsig
    float sb = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sx = 0.f;
    for (int l0 = 0; l0 < cap_c; l0 += TC_P) {
      if (tid < 4 * TC_P) {
        const int c = tid / TC_P, p = tid % TC_P;
        col_s[tid] = c < 3 ? dzr1[c * cz + l0 + p] : dsig[l0 + p];
      }
      __syncthreads();
      float yv[TC_P / 2];
#pragma unroll
      for (int j = 0; j < TC_P / 2; ++j)
        yv[j] = __bfloat162float(y[static_cast<size_t>(l0 + half + 2 * j) * HR + k]);
#pragma unroll
      for (int j = 0; j < TC_P / 2; ++j) {
        const int p = half + 2 * j;
        const float d0 = round_bf16(col_s[p]), d1 = round_bf16(col_s[TC_P + p]),
                    d2 = round_bf16(col_s[2 * TC_P + p]);
        float dy = fmaf(d0, w0, 0.f);
        dy = fmaf(d1, w1, dy);
        dy = fmaf(d2, w2, dy);
        const float v = yv[j] > 0.f ? dy : 0.f;
        dz0[static_cast<size_t>(l0 + p) * LDZ + k] = __float2bfloat16_rn(v);
        sb += v;
        s0 = fmaf(yv[j], d0, s0);
        s1 = fmaf(yv[j], d1, s1);
        s2 = fmaf(yv[j], d2, s2);
      }
      if (tid < 4)
        for (int p = 0; p < TC_P; ++p) sx += col_s[tid * TC_P + p];
      __syncthreads();
    }
    float* red = sm.red;                // [4][256]: br0, wr1 (3) by thread
    red[tid] = sb;
    red[THREADS + tid] = s0;
    red[2 * THREADS + tid] = s1;
    red[3 * THREADS + tid] = s2;
    __syncthreads();
    if (tid < HR) {
      pvec[OFF_BR0 + tid] = red[tid] + red[tid + HR];
      float* o = part + OFF_WR1 + tid * 8;
      for (int c = 0; c < 3; ++c) o[c] = red[(1 + c) * THREADS + tid] + red[(1 + c) * THREADS + tid + HR];
      for (int c = 3; c < 8; ++c) o[c] = 0.f;
    } else if (tid < HR + 8) {
      pvec[OFF_BR1 + tid - HR] = 0.f;
    }
    __syncthreads();
    if (tid < 3) pvec[OFF_BR1 + tid] = sx;
    if (tid == 3) pvec[OFF_B10S] = sx;
  }
  // rgb hidden layer: wr0f, wr0d; dfeat = dzr0 wr0f^T (b10f)
  dweight_tc<H, HR, 4, 2>(st.feat, H, H, st.dz[0], cap_c, part + OFF_WR0F, sm.act0);
  dweight_tc<DP, HR, 1, 8>(st.denc, DP, DP, st.dz[0], cap_c, part + OFF_WR0D, sm.act0);
  dact_tc<HR, Mask::None, false>(st.dz[0], wmat + OFF_WR0F, nullptr, nullptr, nullptr, st.dz[1],
                                 pvec + OFF_B10F, nullptr, cap_c, sm);
  // feature head: w10f; dz9 = (dfeat w10f^T + dsig w10s) * (h9 > 0) (b9),
  // and w10s = h9^T dsig
  dweight_tc<128, H, 2, 4>(st.h9b, H, H, st.dz[1], cap_c, part + OFF_W10F, sm.act0);
  dact_tc<H, Mask::F32, true>(st.dz[1], wmat + OFF_W10F, st.h9f, dsig, vec + OFF_W10S, st.dz[0],
                              pvec + 8 * H, pvec + OFF_W10S, cap_c, sm);
  // block2 and block1: w_i from h_{i-1}; dz_{i-1} = dz_i w_i^T * (h_{i-1} > 0)
  bf16* cur = st.dz[0];
  bf16* nxt = st.dz[1];
  for (int i = 9; i >= 2; --i) {
    const int off = hidden_off(i);
    dweight_tc<128, H, 2, 4>(st.h[i - 2], H, H, cur, cap_c, part + off, sm.act0);
    if (i == 6) dweight_tc<PP, H, 1, 8>(st.penc, PP, PP, cur, cap_c, part + OFF_W6P, sm.act0);
    dact_tc<H, Mask::Bf16, false>(cur, wmat + off, st.h[i - 2], nullptr, nullptr, nxt,
                                  pvec + (i - 2) * H, nullptr, cap_c, sm);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  dweight_tc<PP, H, 1, 8>(st.penc, PP, PP, cur, cap_c, part + OFF_W1, sm.act0);
}

// Step 1: the forward of FWD_SPLIT CTAs a backward CTA's rays, each every
// FWD_SPLIT-th 64-point chunk of them, into that CTA's stash.
__global__ void __launch_bounds__(THREADS, 2)
fused_render_train_tc_fwd(RayInputs in, const bf16* __restrict__ wmat, int rays_per_cta, int cap,
                 unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const FwdSmem sm{reinterpret_cast<bf16*>(sb + FB_ACT), reinterpret_cast<bf16*>(sb + FB_PENC),
                   reinterpret_cast<bf16*>(sb + FB_DENC), reinterpret_cast<bf16*>(sb + FB_WST),
                   reinterpret_cast<float*>(sb + FB_SIG), nullptr};
  const int b = blockIdx.x / FWD_SPLIT, part = blockIdx.x % FWD_SPLIT;
  const int S = in.S;
  const int ray0 = b * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  const TcStash st = carve_stash(scratch + static_cast<size_t>(b) * cap * BYTES_PER_POINT, cap);
  for (int c0 = part * TC_P; c0 < npts; c0 += FWD_SPLIT * TC_P)
    forward_chunk_tc<true>(in, wmat, ray0 * S + c0, min(TC_P, npts - c0), sm, st,
                           static_cast<size_t>(c0), cap);
}

// Steps 2 and 3: compositing, the MSE cotangent and the compositing
// backward (a thread a ray), then the MLP backward over the CTA's points.
__global__ void __launch_bounds__(THREADS, 1)
fused_render_train_tc_bwd(RayInputs in, const bf16* __restrict__ wmat, const float* __restrict__ target,
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
      carve_stash(scratch + static_cast<size_t>(blockIdx.x) * cap * BYTES_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* lossr = reinterpret_cast<float*>(sm.act1);
  composite_rays<true>(in, ray0, nr, cap_c, st.cols, static_cast<size_t>(cap), 1.f, 1.f, target,
                       white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }
  __syncthreads();
  backward(st, cap, in.vec, wmat, part, cap_c, sm);
}

}  // namespace

extern "C" {

// Sizes the caller allocates: stash bytes per point, floats per CTA
// partial, floats of the output (the gradients, then the loss).
void fused_render_train_tc_sizes(int* bytes_per_point, int* npart, int* n_out) {
  *bytes_per_point = BYTES_PER_POINT;
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
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 || rays_per_cta <= 0 ||
      rays_per_cta > MAX_RAYS_PER_CTA || real_p > PP || real_d > DP || cap % TC_P != 0 ||
      cap < (rays_per_cta * S + TC_P - 1) / TC_P * TC_P)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, real_p, real_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(fused_render_train_tc_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_render_train_tc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_render_train_tc_fwd<<<grid * FWD_SPLIT, THREADS, SMEM_FWD, s>>>(
      in, static_cast<const bf16*>(wmat), rays_per_cta, cap, static_cast<unsigned char*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_render_train_tc_bwd<<<grid, THREADS, SMEM_BWD, s>>>(
      in, static_cast<const bf16*>(wmat), target, white_bg, scale, rays_per_cta, cap,
      static_cast<unsigned char*>(scratch), partial, rgb, acc, weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, s>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_render_train_tc_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
