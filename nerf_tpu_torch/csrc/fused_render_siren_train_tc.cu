// Fused SIREN train pass in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render_siren.py::_train_kernel
// (FusedSirenRender.train) in bfloat16 mode: the forward of the SIREN MLP
// over a (rays, samples) batch, white-background MSE (loss partial and its
// per-ray cotangent, fused_render.py::_mse_cotangent), the backward through
// compositing (_composite_bwd) and the MLP backward
// (fused_siren.py::_mlp_bwd_core without input gradients), in one pass. It
// gives the 25 float32 weight gradients of the packed layout
// (fused_render_siren_common.cuh), the loss, rgb, acc and the compositing
// weights. The float32 mode and the render backward (both dtypes) stay in
// fused_render_siren_train.cu.
//
// What bounds it on this card: operations. A sample costs the forward's
// 561,920 MACs plus twice that for the backward, less the two input
// products (dz1 w1^T, dzr0 wr0d^T): 1,681,536 MACs on the tensor cores'
// 989 TFLOP/s in bf16 (0.891 ms at 1024 rays x 256 samples), and 2,176
// sines and as many cosines on the CUDA cores. Next come the bytes of the
// stash below. The kernel it replaced in bf16 (the train entry of
// fused_render_siren_train.cu, every product an fp32 FMA on the CUDA cores)
// took 38.388 ms at 1024 x 256 on an NVIDIA H100 80GB HBM3 at 700 W, 0.023
// of the bound.
//
// Design: row 5's split (fused_render_train_tc.cu), on render_tc.cuh's
// products:
//   1. Forward kernel, two CTAs a backward CTA's rays, each every other
//      64-point chunk of them (two CTAs share an SM): row 6's chain
//      (fused_render_siren_tc_common.cuh::forward_chunk_siren_tc<true>,
//      the forward render's bit for bit), stashing per point.
//   2. Backward kernel, a CTA a group of whole rays: one thread per ray for
//      compositing, the MSE cotangent and the compositing backward
//      (render_common.cuh::composite_rays, with sigma_mul and rgb_mul); the
//      rgb output layer's 128 x 3 products on the CUDA cores, chunk by
//      chunk, with dzr0 = (dy w0h) cr0.
//   3. Then the MLP backward layer by layer over all of the CTA's points:
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
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_siren_tc_common.cuh"

namespace siren {
namespace {

constexpr int FWD_SPLIT = 2;       // forward CTAs a backward CTA's points

// Shared memory (bytes) of the backward kernel: two activation tiles (a dz
// chunk, the staged output), the cosine tile (float32 [64][LDM]), the
// weight stages of a dz W^T product, a chunk's per-point cotangent columns,
// a reduction buffer. The weight gradients' stages overlay the activation
// and cosine tiles; the per-ray losses of the compositing pass the second
// activation tile.
constexpr int LDM = H + 8;                     // row stride (floats) of the cosines
constexpr int BB_ACT0 = 0;
constexpr int BB_ACT1 = BB_ACT0 + TC_P * LDS * 2;
constexpr int BB_COS = BB_ACT1 + TC_P * LDS * 2;
constexpr int BB_WST = BB_COS + TC_P * LDM * 4;
constexpr int BB_COL = BB_WST + WST_DACT_BYTES;
constexpr int BB_RED = BB_COL + 4 * TC_P * 4;
constexpr int SMEM_BWD = BB_RED + 4 * THREADS * 4;
static_assert(SMEM_BWD <= 232448, "exceeds the per-block shared memory");
static_assert(DW_STAGE_BYTES <= BB_WST, "weight-gradient stages fit");
constexpr int MAX_RAYS_PER_CTA = TC_P * LDS * 2 / 4;   // per-ray losses in ACT1

// The stash (fused_render_siren_tc_common.cuh::TcStash), `cap` rows each.
constexpr int BYTES_PER_POINT = 2 * (11 * H + HR + DP) + 4 * (9 * H + HR + N_COLS);
static_assert(BYTES_PER_POINT % 16 == 0, "stash rows must stay 16-byte aligned");

__device__ TcStash carve_stash(unsigned char* p, int cap) {
  TcStash s;
  const size_t c = static_cast<size_t>(cap);
  auto take_b = [&](int cols) {
    bf16* r = reinterpret_cast<bf16*>(p);
    p += c * cols * 2;
    return r;
  };
  auto take_f = [&](int cols) {
    float* r = reinterpret_cast<float*>(p);
    p += c * cols * 4;
    return r;
  };
  for (int i = 0; i < NL; ++i) s.h[i] = take_b(H);
  s.feat = take_b(H);
  s.dz[0] = take_b(H);
  s.dz[1] = take_b(H);
  s.y = take_b(HR);
  s.denc = take_b(DP);
  s.h8f = take_f(H);
  for (int i = 0; i < NL; ++i) s.c[i] = take_f(H);
  s.cr0 = take_f(HR);
  s.cols = take_f(N_COLS);
  return s;
}

struct BwdSmem {
  bf16* act0;
  bf16* act1;
  float* cos;
  bf16* wst;
  float* col;
  float* red;
};

// dz_out = EPI(dz_in W^T) over the CTA's points l < cap_c, chunk by chunk:
// dz_in (KP columns) and dz_out (256) bf16 with stride LDZ, W (256 x KP) the
// packed matrix. COS: EPI(x) = ((x (+ dsig ws)) w0) cos, the cosine from
// cref (float32, 256 columns), staged into shared memory with the chunk's dz
// (and dsig) and its first weight tiles; else EPI(x) = x. The unrounded
// values are summed by column into colsum (256), in a fixed order; dz_out
// gets them rounded. Ends past a barrier.
template <int KP, bool COS, bool DSIG>
__device__ void dact_tc(const bf16* __restrict__ dz_in, const bf16* __restrict__ w,
                        const float* __restrict__ cref, float w0, const float* __restrict__ dsig,
                        const float* __restrict__ wsig, bf16* __restrict__ dz_out,
                        float* __restrict__ colsum, int cap_c, const BwdSmem& sm) {
  static_assert(COS || !DSIG, "dsig ws joins the sine layer's epilogue");
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = (tid >> 5) * 32;
  float cs[4][2] = {};
  for (int l0 = 0; l0 < cap_c; l0 += TC_P) {
    constexpr int CPR = KP / 8;
    for (int e = tid; e < TC_P * CPR; e += THREADS) {
      const int r = e / CPR, q = (e % CPR) * 8;
      cp_async16(sm.act0 + r * LDS + q, dz_in + static_cast<size_t>(l0 + r) * LDZ + q);
    }
    if constexpr (COS) {
      for (int e = tid; e < TC_P * (H / 4); e += THREADS) {
        const int r = e / (H / 4), q = (e % (H / 4)) * 4;
        cp_async16(sm.cos + r * LDM + q, cref + static_cast<size_t>(l0 + r) * H + q);
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
        x0 = __fadd_rn(x0, __fmul_rn(ds, __ldg(wsig + col)));
        x1 = __fadd_rn(x1, __fmul_rn(ds, __ldg(wsig + col + 1)));
      }
      if constexpr (COS) {
        const float2 m = *reinterpret_cast<const float2*>(sm.cos + row * LDM + col);
        x0 = __fmul_rn(__fmul_rn(x0, w0), m.x);
        x1 = __fmul_rn(__fmul_rn(x1, w0), m.y);
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
      float v = cs[j][u];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < 4) colsum[n0 + j * 8 + 2 * lane + u] = v;
    }
  __syncthreads();
}

// The MLP backward (fused_siren.py::_mlp_bwd_core without input products)
// over the CTA's points l < cap_c from the stash and the cotangent columns
// dzr1 and dsig, into the CTA's partial (offsets of the packed layout, the
// vectors from N_W).
__device__ void backward(const TcStash& st, int cap, const Siren& sp,
                         const float* __restrict__ vec, const bf16* __restrict__ wmat,
                         float* __restrict__ part, int cap_c, const BwdSmem& sm) {
  const int tid = threadIdx.x;
  const size_t cz = static_cast<size_t>(cap);
  const float* dsig = st.cols + C_DSIG * cz;
  const float* dzr1 = st.cols + C_DZR1 * cz;
  float* pvec = part + N_W;
  // rgb output layer (CUDA cores), chunk by chunk: dzr0 = ((r(dzr1) wr1^T)
  // w0h) cr0 to dz[0] (128 columns), with its column sums (br0) and wr1 =
  // r(y)^T r(dzr1) in two halves of each chunk's points; br1 and bs (the
  // sums of dzr1 and dsig) by four threads over the staged columns
  {
    const int k = tid & (HR - 1), half = tid / HR;
    const float w0 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 0]);
    const float w1 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 1]);
    const float w2 = __bfloat162float(wmat[OFF_WR1 + k * 8 + 2]);
    const bf16* __restrict__ y = st.y;
    const float* __restrict__ cr0 = st.cr0;
    bf16* __restrict__ dz0 = st.dz[0];
    float* col_s = sm.col;              // [4][64]: dzr1 (3), dsig
    float sb = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sx = 0.f;
    for (int l0 = 0; l0 < cap_c; l0 += TC_P) {
      if (tid < 4 * TC_P) {
        const int c = tid / TC_P, p = tid % TC_P;
        col_s[tid] = c < 3 ? dzr1[c * cz + l0 + p] : dsig[l0 + p];
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TC_P / 2; ++j) {
        const int p = half + 2 * j;
        const size_t l = static_cast<size_t>(l0 + p);
        const float yv = __bfloat162float(y[l * HR + k]);
        const float d0 = round_bf16(col_s[p]), d1 = round_bf16(col_s[TC_P + p]),
                    d2 = round_bf16(col_s[2 * TC_P + p]);
        float dy = fmaf(d0, w0, 0.f);
        dy = fmaf(d1, w1, dy);
        dy = fmaf(d2, w2, dy);
        const float v = __fmul_rn(__fmul_rn(dy, sp.w0h), cr0[l * HR + k]);
        dz0[l * LDZ + k] = __float2bfloat16_rn(v);
        sb += v;
        s0 = fmaf(yv, d0, s0);
        s1 = fmaf(yv, d1, s1);
        s2 = fmaf(yv, d2, s2);
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
    if (tid == 3) pvec[OFF_BS] = sx;
  }
  // the density row: ws = h8^T dsig, a column loop on the unrounded h8
  {
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < cap_c; ++l) s = fmaf(st.h8f[static_cast<size_t>(l) * H + tid], dsig[l], s);
    pvec[OFF_WS + tid] = s;
  }
  // rgb sine layer: wr0f, wr0d; dfeat = dzr0 wr0f^T (bre)
  dweight_tc<H, HR, 4, 2>(st.feat, H, H, st.dz[0], cap_c, part + OFF_WR0F, sm.act0);
  dweight_tc<DP, HR, 1, 8>(st.denc, DP, DP, st.dz[0], cap_c, part + OFF_WR0D, sm.act0);
  dact_tc<HR, false, false>(st.dz[0], wmat + OFF_WR0F, nullptr, 1.f, nullptr, nullptr, st.dz[1],
                            pvec + OFF_BRE, cap_c, sm);
  // feature remap: wre from r(h8); dz8 = ((dfeat wre^T + dsig ws) w0h) c8 (b8)
  dweight_tc<128, H, 2, 4>(st.h[NL - 1], H, H, st.dz[1], cap_c, part + OFF_WRE, sm.act0);
  dact_tc<H, true, true>(st.dz[1], wmat + OFF_WRE, st.c[NL - 1], sp.w0h, dsig, vec + OFF_WS,
                         st.dz[0], pvec + (NL - 1) * H, cap_c, sm);
  // sine layers 8..2: w_l from h_{l-1}; dz_{l-1} = ((dz_l w_l^T) w0_{l-1}) c_{l-1}
  bf16* cur = st.dz[0];
  bf16* nxt = st.dz[1];
  for (int l = NL; l >= 2; --l) {
    dweight_tc<128, H, 2, 4>(st.h[l - 2], H, H, cur, cap_c, part + off_w(l), sm.act0);
    dact_tc<H, true, false>(cur, wmat + off_w(l), st.c[l - 2], l == 2 ? sp.w0 : sp.w0h, nullptr,
                            nullptr, nxt, pvec + (l - 2) * H, cap_c, sm);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  // first layer: dW1 = r(pos)^T r(dz1) (rows 3..7 zero), a column loop
  {
    const float* pos = st.cols + C_POS * cz;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int l = 0; l < cap_c; ++l) {
      const float d = __bfloat162float(cur[static_cast<size_t>(l) * LDZ + tid]);
      s0 = fmaf(pos[l], d, s0);
      s1 = fmaf(pos[cz + l], d, s1);
      s2 = fmaf(pos[2 * cz + l], d, s2);
    }
    part[OFF_W1 + 0 * H + tid] = s0;
    part[OFF_W1 + 1 * H + tid] = s1;
    part[OFF_W1 + 2 * H + tid] = s2;
    for (int k = 3; k < 8; ++k) part[OFF_W1 + k * H + tid] = 0.f;
  }
}

static_assert(THREADS == H, "the column loops give each thread one of the 256 columns");

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
  const TcStash st = carve_stash(scratch + static_cast<size_t>(b) * cap * BYTES_PER_POINT, cap);
  for (int c0 = part * TC_P; c0 < npts; c0 += FWD_SPLIT * TC_P)
    forward_chunk_siren_tc<true>(in, sp, wmat, ray0 * S + c0, min(TC_P, npts - c0), sm, st,
                                 static_cast<size_t>(c0), cap);
}

// Steps 2 and 3: compositing, the MSE cotangent and the compositing
// backward (a thread a ray), then the MLP backward over the CTA's points.
__global__ void __launch_bounds__(THREADS, 1)
fused_siren_grad_tc_bwd(RayInputs in, Siren sp, const bf16* __restrict__ wmat,
                        const float* __restrict__ target, float white_bg, float scale,
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
      carve_stash(scratch + static_cast<size_t>(blockIdx.x) * cap * BYTES_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* lossr = reinterpret_cast<float*>(sm.act1);
  composite_rays<true>(in, ray0, nr, cap_c, st.cols, static_cast<size_t>(cap), sp.sigma_mul,
                       sp.rgb_mul, target, white_bg, scale, rgb_out, acc_out, weights_out, lossr);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += lossr[r];
    part[N_TOT] = scale * s;
  }
  __syncthreads();
  backward(st, cap, sp, in.vec, wmat, part, cap_c, sm);
}

int launch_train_tc(const float* o_aff, const float* d_aff, const float* viewdirs,
                    const float* t, const void* wmat, const float* vec, int n_w, int n_b,
                    const float* target, float white_bg, float scale, int num_rays, int S,
                    int rays_per_cta, int cap, int real_d, float w0, float w0h, float sigma_mul,
                    float rgb_mul, void* scratch, float* partial, float* out, float* rgb,
                    float* acc, float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 || rays_per_cta <= 0 ||
      rays_per_cta > MAX_RAYS_PER_CTA || real_d > DP || cap % TC_P != 0 ||
      cap < (rays_per_cta * S + TC_P - 1) / TC_P * TC_P)
    return -1;
  const RayInputs in{o_aff, d_aff, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(fused_siren_grad_tc_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SB_END);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_siren_grad_tc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  const bf16* w = static_cast<const bf16*>(wmat);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  fused_siren_grad_tc_fwd<<<grid * FWD_SPLIT, THREADS, SB_END, s>>>(in, sp, w, rays_per_cta, cap,
                                                                    sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_siren_grad_tc_bwd<<<grid, THREADS, SMEM_BWD, s>>>(in, sp, w, target, white_bg, scale,
                                                          rays_per_cta, cap, sc, partial, rgb, acc,
                                                          weights);
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
  *bytes_per_point = siren::BYTES_PER_POINT;
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
  return siren::launch_train_tc(o_aff, d_aff, viewdirs, t, wmat, vec, n_w, n_b, target, white_bg,
                                scale, num_rays, S, rays_per_cta, cap, real_d, w0, w0h, sigma_mul,
                                rgb_mul, scratch, partial, out, rgb, acc, weights, stream);
}

const char* fused_siren_train_tc_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
