// GaborNet field backward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_gabor.py::_bwd_kernel (the custom VJP
// of make_fused_gabor_apply's apply: a GaborNet distillation student's
// gradient) in bfloat16 mode. Same function as fused_gabor_bwd.cu, which
// keeps the float32 mode: from the cotangent (n, 4) of [rgb, sigma], the
// filters from the points (_filters_from_points) and _mlp_tile again, the
// heads' backward (dzr1 = g_rgb r (1 - r) rgb_mul, dsig = g_sigma sigma_mul
// where sigma_pre > 0, the ws and bs gradients), the multiplicative chain's
// backward (du = dz g_i, dg_i = dz u_{i-1}), each stage's bank gradients (d
// omega = x^T dsinarg, d phi = sum dsinarg, d mu^T = x^T (-2 dq), d |mu|^2
// = sum dq, d gamma = sum da (-q/2), with dsinarg = (dg cos(sinarg)) E, da
// = (dg sin(sinarg)) E, dq = da (-gamma/2)), the point cotangent (sum over
// stages of dsinarg omega^T + 2 x sum(dq) - 2 dq mu) and the direction
// cotangent (_encode_bwd of dzr0 wr0d^T, the exact cosine): the 23 float32
// gradients of the packed layout, the N_F bank gradients (F_* layout),
// dpts and ddirs.
//
// What bounds it on this card: operations. A point costs three times the
// forward's 573,440 MACs (0.057 ms at 16,384 points, a distillation step's
// batch, on the tensor cores' 989 TFLOP/s in bf16) and 6,144
// transcendentals (the forward's sine and exponential of each filter
// element, the backward's exponential, sine and cosine again) with about
// 60 CUDA-core instructions of filter arithmetic an element, which take
// longer than the products. The kernel it replaced in bf16
// (fused_gabor_bwd.cu, every product an fp32 FMA on the CUDA cores) took
// 3.544 / 13.440 ms at 16,384 / 65,536 points on an NVIDIA H100 80GB HBM3
// at 700 W, 0.016 of the bound, and recomputed the forward in another
// summation order than the tensor-core forward it differentiates.
//
// Design: row 12's split (fused_render_gabor_train_tc.cu) without the
// compositing, on row 13's chain:
//   1. Forward kernel, a CTA a 64-point chunk, two CTAs an SM: row 13's
//      chain (fused_render_gabor_tc_common.cuh::network_tc<true> behind
//      load_point_chunk_tc, PointFilterTc's filters), stashing what row 12
//      stashes into the stash of the backward CTA that owns the chunk. The
//      recomputed rgb and sigma_pre are row 13's outputs bit for bit.
//   2. Backward kernel, a CTA a run of points (a multiple of 64): one
//      thread a point takes the heads' backward from the given cotangent;
//      then row 12's network backward (fused_render_gabor_tc_common.cuh::
//      backward: each dz W^T against the packed W itself, each A^T du once
//      per CTA on the tensor cores) with this file's PointStages as its
//      policy. Once dzr0 is complete, dzr0 wr0d^T on gemm_fwd against wr0d^T
//      zero-padded to 128 columns (the wrapper's, built once a packing) and
//      the direction cotangent a thread a coordinate. Each stage's dz W^T
//      epilogue evaluates the filter again from the point
//      (PointFilterTc::full, bit for bit the forward's), forms dg, du,
//      dsinarg, da and dq, sums the nine bank gradients of each column over
//      the CTA's real points (masked: a padded point's filter is not zero
//      at x = 0) by the thread's rows, a shuffle tree over the warp's row
//      groups and a running sum in shared memory, and the point
//      cotangent's seven sums of each row over the thread's columns, a
//      shuffle over the row's 4 lanes and then the 8 warps in order through
//      shared memory (no atomics), added to the point's float32 column.
//   3. reduce_partials adds the per-CTA partials in CTA order. Nothing is
//      atomic, so two launches give the same bits.
// Rounding follows _bwd_kernel: both operands of every mmT_acc and dact are
// bf16 (the point rounded in the x^T products, dsinarg and -2 dq in the
// banks' and dsinarg and dq in the point cotangent's, whose banks stay
// float32), sums are float32, u_i, z_8, sigma_pre and the sigmoid are read
// in float32, and the bias, ws, bs, phi, |mu|^2 and gamma gradients sum
// unrounded values.
//
// Stash: row 12's 14,208 bytes a point (z_1..z_8, feat, y, denc and the dz
// buffers in bf16; u_2..u_8, z_8 and the per-point columns, among them the
// point cotangent, in float32): 233 MB at 16,384 points. Each CTA's
// gradient partial is 2.32 MB (the 23 gradients and the banks'); the run
// length sets how many are written and read back.
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

constexpr int N_GRAD = N_TOT + N_F;                    // the MLP's, then the banks'
constexpr int FIELD_NPART = (N_GRAD + 1 + 3) / 4 * 4;  // per-CTA: gradients, a zero
constexpr int PT_SUMS = 7;    // a point cotangent's sums a row: dsinarg om^T (3), dq mu (3), dq
static_assert(WARPS * TC_PB * PT_SUMS * 4 <= WST_DACT_BYTES, "row sums fit the weight stages");
static_assert(C_DP + 3 <= N_COLS, "the point cotangent's columns");

__device__ __forceinline__ unsigned char* cta_stash(unsigned char* scratch, int b, int cap) {
  return scratch + static_cast<size_t>(b) * cap * TC_BYTES_PER_POINT;
}

// Step 1: the forward of chunk blockIdx.x into the stash of the backward
// CTA that owns it (runs of `run` points, a multiple of 64).
__global__ void __launch_bounds__(THREADS, 2)
gabor_field_bwd_tc_fwd(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ vec, const bf16* __restrict__ wmat,
                       const float* __restrict__ fpack, float sigma_mul, float rgb_mul, int n,
                       int run, int cap, int real_d, unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  const GSmem sm = carve_gsmem(reinterpret_cast<unsigned char*>(smem4));
  const int p0 = blockIdx.x * TC_P;
  const int b = p0 / run;
  const size_t l0 = static_cast<size_t>(p0 - b * run);
  const int nvalid = min(TC_P, n - p0);
  const TcStash st = carve_tc_stash(cta_stash(scratch, b, cap), cap);
  load_point_chunk_tc(pts, dirs, p0, nvalid, real_d, sm);
  tile_out(sm.denc, LDD, DP, st.denc, l0);
  network_tc<true>(vec, wmat, sigma_mul, rgb_mul, sm, st, l0, cap,
                   [&](float (&acc)[MT_F][4][4], int nb, int stage, bool first, bool last,
                       const float* bias, const float* ws, bf16* out, float (&sp)[MT_F][2]) {
                     PointFilterTc f{fpack + stage * F_STRIDE, sm, nvalid};
                     stage_epilogue_tc<true>(acc, nb, f, first, last, bias, ws, out, sp,
                                             first ? nullptr : st.u[stage - 1], st.z8f, l0);
                   });
}

// The field's filter stages (the backward's policy) over a CTA's points
// [p0, p0 + npts): the filters from the points and the banks `fpack`, the
// banks' gradients into pf (the partial's N_TOT..), the point cotangent in
// the stash's columns C_DP.. (cols, cz a column), the direction cotangent
// from dzr0 against wr0d_t.
struct PointStages {
  const float* pts;
  const float* dirs;
  const bf16* wr0d_t;
  const float* fpack;
  float* pf;
  float* cols;
  size_t cz;
  float* ddirs;
  int p0, npts, cap_c, real_d;
  const BwdSmem& sm;

  __device__ void on_dzr0(const bf16* dzr0) const {
    direction_cotangent_tc(dzr0, wr0d_t, dirs, p0, npts, cap_c, real_d, ddirs, sm.act0,
                           reinterpret_cast<float*>(sm.act1), sm.wst);
  }

  // a thread a row: the point rounded to bf16 and |x|^2 of the unrounded
  // one, as load_point_chunk_tc gives them to the forward
  __device__ __forceinline__ void columns(int l0, const BwdSmem& s) const {
    const int tid = threadIdx.x, l = l0 + tid;
    float x[3] = {0.f, 0.f, 0.f};
    if (l < npts)
      for (int k = 0; k < 3; ++k) x[k] = pts[static_cast<size_t>(p0 + l) * 3 + k];
    for (int k = 0; k < 3; ++k) s.col[(BC_X + k) * TC_PB + tid] = round_bf16(x[k]);
    s.col[BC_XX * TC_PB + tid] =
        __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])), __fmul_rn(x[2], x[2]));
  }

  // The epilogue of filter stage `stage` over the chunk from l0, the warp's
  // TC_PB x 32 tile of dz = acc (+ dsig ws: DSIG) in the block of columns
  // from nb. For each element of a real
  // point: the filter (PointFilterTc::full), dg = dz (FIRST) or dz u, du =
  // dz g, dsinarg, da and dq; du rounded to act1 and summed unrounded into
  // cs; the nine bank gradients of each column into sm.run (the thread's
  // rows, then the warp's 8 row groups); the point cotangent's seven sums
  // of each row over the thread's 8 columns, then the row's 4 lanes, into
  // the weight stages (after_chunk adds the 8 warps).
  template <bool FIRST, bool DSIG>
  __device__ __forceinline__ void chunk(float (&acc)[MT_B][4][4], int nb, int stage, int l0,
                                        const float* __restrict__ wsig, const BwdSmem& s,
                                        float (&cs)[4][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3, warp = threadIdx.x >> 5;
    const int n0 = warp * 32, nvalid = npts - l0;
    const float* fs = fpack + stage * F_STRIDE;
    float pa[MT_B][2][PT_SUMS];
#pragma unroll
    for (int mt = 0; mt < MT_B; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < PT_SUMS; ++q) pa[mt][h][q] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lc = n0 + j * 8 + 2 * c, col = nb + lc;   // in the block, in the layer
      float2 om[3], mu[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        om[d] = __ldg(reinterpret_cast<const float2*>(fs + F_OM + d * H + col));
        mu[d] = __ldg(reinterpret_cast<const float2*>(fs + F_MU + d * H + col));
      }
      const float2 ph = __ldg(reinterpret_cast<const float2*>(fs + F_PH + col));
      const float2 m2 = __ldg(reinterpret_cast<const float2*>(fs + F_M2 + col));
      const float2 gam = __ldg(reinterpret_cast<const float2*>(fs + F_GAM + col));
      const float hg[2] = {__fmul_rn(-0.5f, gam.x), __fmul_rn(-0.5f, gam.y)};
      float ws[2] = {0.f, 0.f};
      if constexpr (DSIG) {
        ws[0] = __ldg(wsig + col);
        ws[1] = __ldg(wsig + col + 1);
      }
      float sums[NRUN][2] = {};    // om (3), mu (3), phi, |mu|^2, gamma by column
#pragma unroll
      for (int mt = 0; mt < MT_B; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + g + 8 * h;
          float du[2] = {0.f, 0.f};
          if (row < nvalid) {
            const float xr[3] = {s.col[BC_X * TC_PB + row], s.col[(BC_X + 1) * TC_PB + row],
                                 s.col[(BC_X + 2) * TC_PB + row]};
            const float xx = s.col[BC_XX * TC_PB + row];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float o0 = u ? om[0].y : om[0].x, o1 = u ? om[1].y : om[1].x,
                          o2 = u ? om[2].y : om[2].x;
              const float m0 = u ? mu[0].y : mu[0].x, m1 = u ? mu[1].y : mu[1].x,
                          mm2 = u ? mu[2].y : mu[2].x;
              const PointFilter f = PointFilterTc::full(xr[0], xr[1], xr[2], xx, o0, o1, o2, m0,
                                                        m1, mm2, u ? ph.y : ph.x,
                                                        u ? m2.y : m2.x, hg[u]);
              float x = acc[mt][j][2 * h + u];
              if constexpr (DSIG)
                x = __fadd_rn(x, __fmul_rn(s.col[BC_DSIG * TC_PB + row], ws[u]));
              float dg = x;
              if constexpr (!FIRST) {
                dg = __fmul_rn(x, s.u[row * LDU + lc + u]);
                du[u] = __fmul_rn(x, __fmul_rn(f.sn, f.E));
              }
              const float dsa = __fmul_rn(__fmul_rn(dg, cosine<true>(f.sinarg)), f.E);
              const float da = __fmul_rn(__fmul_rn(dg, f.sn), f.E);
              const float dq = __fmul_rn(da, hg[u]);
              const float rs = round_bf16(dsa), rq = round_bf16(__fmul_rn(-2.f, dq));
              const float rdq = round_bf16(dq);
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                sums[k][u] = fmaf(xr[k], rs, sums[k][u]);
                sums[3 + k][u] = fmaf(xr[k], rq, sums[3 + k][u]);
              }
              sums[6][u] += dsa;
              sums[7][u] += dq;
              sums[8][u] = fmaf(da, __fmul_rn(-0.5f, f.q), sums[8][u]);
              pa[mt][h][0] = fmaf(rs, o0, pa[mt][h][0]);
              pa[mt][h][1] = fmaf(rs, o1, pa[mt][h][1]);
              pa[mt][h][2] = fmaf(rs, o2, pa[mt][h][2]);
              pa[mt][h][3] = fmaf(rdq, m0, pa[mt][h][3]);
              pa[mt][h][4] = fmaf(rdq, m1, pa[mt][h][4]);
              pa[mt][h][5] = fmaf(rdq, mm2, pa[mt][h][5]);
              pa[mt][h][6] += dq;
            }
          }
          if constexpr (!FIRST) {
            cs[j][0] += du[0];
            cs[j][1] += du[1];
            put2(s.act1 + row * LDN + lc, du[0], du[1]);
          }
        }
#pragma unroll
      for (int q = 0; q < NRUN; ++q)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            sums[q][u] += __shfl_xor_sync(0xffffffffu, sums[q][u], off);
        }
      if (g == 0) {
#pragma unroll
        for (int q = 0; q < NRUN; ++q)
#pragma unroll
          for (int u = 0; u < 2; ++u) s.run[q * H + col + u] += sums[q][u];
      }
    }
    float* red = reinterpret_cast<float*>(s.wst);
#pragma unroll
    for (int mt = 0; mt < MT_B; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < PT_SUMS; ++q) {
          float v = pa[mt][h][q];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (c == 0) red[(warp * TC_PB + mt * 16 + g + 8 * h) * PT_SUMS + q] = v;
        }
  }

  // the point cotangent of each real point of the chunk, a thread a
  // coordinate: the 8 warps' sums in order, then dp = ((dp + a) + (2 x) sq)
  // - 2 m with x unrounded, as fused_gabor_bwd.cu adds a stage
  __device__ void after_chunk(int l0, const BwdSmem& s) const {
    const float* red = reinterpret_cast<const float*>(s.wst);
    const int tid = threadIdx.x;
    if (tid < 3 * TC_PB) {
      const int row = tid / 3, k = tid % 3, l = l0 + row;
      if (l < npts) {
        float a = 0.f, m = 0.f, sq = 0.f;
        for (int w = 0; w < WARPS; ++w) {
          const float* r = red + (w * TC_PB + row) * PT_SUMS;
          a += r[k];
          m += r[3 + k];
          sq += r[6];
        }
        float* dp = cols + (C_DP + k) * cz + l;
        const float x = pts[static_cast<size_t>(p0 + l) * 3 + k];
        *dp = ((*dp + a) + (2.f * x) * sq) - 2.f * m;
      }
    }
    __syncthreads();
  }

  // the stage's bank gradients to the partial, a thread a column; the
  // running sums start again at zero
  __device__ void end_stage(int stage, const BwdSmem& s) const {
    float* o = pf + stage * F_STRIDE;
    for (int col = threadIdx.x; col < H; col += THREADS) {
      for (int k = 0; k < 3; ++k) {
        o[F_OM + k * H + col] = s.run[k * H + col];
        o[F_MU + k * H + col] = s.run[(3 + k) * H + col];
      }
      o[F_PH + col] = s.run[6 * H + col];
      o[F_M2 + col] = s.run[7 * H + col];
      o[F_GAM + col] = s.run[8 * H + col];
      for (int q = 0; q < NRUN; ++q) s.run[q * H + col] = 0.f;
    }
  }
};

// Step 2: the heads' backward (a thread a point), then the network backward
// with the filter stages from the points over the CTA's run of points.
__global__ void __launch_bounds__(THREADS, 1)
gabor_field_bwd_tc_bwd(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ cot, const float* __restrict__ vec,
                       const bf16* __restrict__ wmat, const bf16* __restrict__ wr0d_t,
                       const float* __restrict__ fpack, float sigma_mul, float rgb_mul, int n,
                       int run, int cap, int real_d, unsigned char* __restrict__ scratch,
                       float* __restrict__ partial, float* __restrict__ dpts,
                       float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const BwdSmem sm{reinterpret_cast<bf16*>(sb + BB_ACT0), reinterpret_cast<bf16*>(sb + BB_ACT1),
                   reinterpret_cast<float*>(sb + BB_U),   reinterpret_cast<bf16*>(sb + BB_WST),
                   reinterpret_cast<float*>(sb + BB_COL), reinterpret_cast<float*>(sb + BB_RED),
                   reinterpret_cast<float*>(sb + BB_RUN)};
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * run;
  const int npts = min(run, n - p0);
  const int cap_c = (npts + TC_P - 1) / TC_P * TC_P;
  const size_t cz = static_cast<size_t>(cap);
  const TcStash st = carve_tc_stash(cta_stash(scratch, blockIdx.x, cap), cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * FIELD_NPART;
  float* cols = st.cols;
  for (int l = tid; l < cap_c; l += THREADS) {
    float dz[3] = {0.f, 0.f, 0.f};
    float ds = 0.f;
    if (l < npts) {
      const float* g = cot + static_cast<size_t>(p0 + l) * 4;
      for (int c = 0; c < 3; ++c) {
        const float r = cols[(C_RGB + c) * cz + l];
        dz[c] = ((g[c] * r) * (1.f - r)) * rgb_mul;
      }
      ds = cols[C_SIGP * cz + l] > 0.f ? g[3] * sigma_mul : 0.f;
    }
    for (int c = 0; c < 3; ++c) {
      cols[(C_DZR1 + c) * cz + l] = dz[c];
      cols[(C_DP + c) * cz + l] = 0.f;
    }
    cols[C_DSIG * cz + l] = ds;
  }
  for (int i = tid; i < NRUN * H; i += THREADS) sm.run[i] = 0.f;
  if (tid == 0) part[N_GRAD] = 0.f;
  __syncthreads();
  const PointStages stages{pts, dirs, wr0d_t, fpack, part + N_TOT, cols, cz, ddirs,
                           p0, npts, cap_c, real_d, sm};
  backward(st, cap, vec, wmat, part, cap_c, sm, stages);
  for (int idx = tid; idx < npts * 3; idx += THREADS) {
    const int l = idx / 3, k = idx % 3;
    dpts[static_cast<size_t>(p0 + l) * 3 + k] = cols[(C_DP + k) * cz + l];
  }
}

int launch_field_bwd_tc(const float* pts, const float* dirs, const float* cot, const void* wmat,
                        const void* wr0d_t, const float* vec, const float* fpack, int n_w,
                        int n_b, int n_f, int bf16_mode, int n, int run, int cap, int real_d,
                        float sigma_mul, float rgb_mul, float* scratch, float* partial,
                        float* out, float* dpts, float* ddirs, void* stream) {
  if (n_w != N_W || n_b != N_B || n_f != N_F || bf16_mode != 1 || n <= 0 || run <= 0 ||
      run % TC_P != 0 || cap % TC_P != 0 || cap < run || real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      gabor_field_bwd_tc_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_GABOR_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gabor_field_bwd_tc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* w = static_cast<const bf16*>(wmat);
  unsigned char* sc = reinterpret_cast<unsigned char*>(scratch);
  const int grid = (n + run - 1) / run;
  gabor_field_bwd_tc_fwd<<<(n + TC_P - 1) / TC_P, THREADS, SMEM_GABOR_TC, s>>>(
      pts, dirs, vec, w, fpack, sigma_mul, rgb_mul, n, run, cap, real_d, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gabor_field_bwd_tc_bwd<<<grid, THREADS, SMEM_BWD, s>>>(
      pts, dirs, cot, vec, w, static_cast<const bf16*>(wr0d_t), fpack, sigma_mul, rgb_mul, n,
      run, cap, real_d, sc, partial, dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_GRAD, FIELD_NPART><<<(N_GRAD + 1 + 255) / 256, 256, 0, s>>>(partial, grid,
                                                                                out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gabor

extern "C" {

// Sizes the caller allocates, as gabor_field_bwd_sizes gives them: scratch
// floats per stashed point (the stash's bytes / 4), floats per CTA
// partial, floats of the output (the MLP's gradients, the banks', then a
// zero).
void gabor_field_bwd_tc_sizes(int* per_point, int* npart, int* n_out) {
  *per_point = gabor::TC_BYTES_PER_POINT / 4;
  *npart = gabor::FIELD_NPART;
  *n_out = gabor::N_GRAD + 1;
}

// The bf16 field backward, with gabor_field_bwd's arguments but for the
// second matrix: `wr0d_t` is wr0d^T zero-padded to 128 x 128 (bf16; the
// other products read the packed W itself), `bf16` must be 1 and
// `pts_per_cta` (the run) a multiple of 64. `scratch` holds grid * cap *
// per_point floats, `partial` grid * npart, `out` n_out, where grid =
// ceil(n / pts_per_cta) and cap >= pts_per_cta is a multiple of 64.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int gabor_field_bwd_tc(const float* pts, const float* dirs, const float* cot, const void* wmat,
                       const void* wr0d_t, const float* vec, const float* fpack, int n_w, int n_b,
                       int n_f, int bf16_mode, int n, int pts_per_cta, int cap, int real_d,
                       float sigma_mul, float rgb_mul, float* scratch, float* partial, float* out,
                       float* dpts, float* ddirs, void* stream) {
  return gabor::launch_field_bwd_tc(pts, dirs, cot, wmat, wr0d_t, vec, fpack, n_w, n_b, n_f,
                                    bf16_mode, n, pts_per_cta, cap, real_d, sigma_mul, rgb_mul,
                                    scratch, partial, out, dpts, ddirs, stream);
}

const char* gabor_field_bwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
