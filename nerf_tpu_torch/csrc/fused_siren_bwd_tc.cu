// SIREN field backward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_siren.py::_bwd_kernel (the custom
// VJP of make_fused_siren_apply's apply: a SIREN distillation student's
// gradient) in bfloat16 mode. Same function as fused_siren_bwd.cu, which
// keeps the float32 mode: from the cotangent (n, 4) of [rgb, sigma],
// recompute the forward, take the heads' backward (dzr1 = ((g_rgb r) (1 -
// r)) rgb_mul, dsig = g_sigma sigma_mul where sigma_pre > 0), run
// _mlp_bwd_core with its two input products dz1 w1^T and dzr0 wr0d^T, then
// _encode_bwd of the direction with the exact cosine: the 25 float32 weight
// and bias gradients of the packed layout (fused_render_siren_common.cuh
// OFF_*), the point and direction cotangents (n, 3) each.
//
// What bounds it on this card: operations. A point costs three times the
// forward's 561,920 MACs (the recomputed forward, every dz W^T with the two
// input products, every A^T dz): 0.0559 ms at 16,384 points (a
// distillation step's batch) on the tensor cores' 989 TFLOP/s in bf16, and
// 2,200 sines and as many cosines on the CUDA cores. The kernel it replaced
// in bf16 (fused_siren_bwd.cu, every product an fp32 FMA on the CUDA cores)
// took 2.721 / 10.057 ms at 16,384 / 65,536 points on an NVIDIA H100 80GB
// HBM3 at 700 W, 0.021 of the bound, and recomputed the forward in another
// summation order than the tensor-core forward it differentiates.
//
// Design: row 8's split (fused_render_siren_train_tc.cu) without the
// compositing, on row 9's chain:
//   1. Forward kernel, a CTA a 64-point chunk, two CTAs an SM: row 9's
//      chain (fused_render_siren_tc_common.cuh::forward_chain_siren_tc<true>
//      behind load_point_chunk_tc, the near ties recomputed as there),
//      stashing what row 8 stashes into the stash of the backward CTA that
//      owns the chunk. The recomputed rgb and sigma_pre are row 9's outputs
//      bit for bit.
//   2. Backward kernel, a CTA a run of points (a multiple of 64): one
//      thread a point takes the heads' backward from the given cotangent;
//      then row 8's MLP backward (fused_render_siren_tc_common.cuh::
//      backward: each dz W^T against the packed W itself, each A^T dz once
//      per CTA on the tensor cores), whose hooks take the input products:
//      dzr0 wr0d^T on gemm_fwd against wr0d^T zero-padded to 128 columns
//      (the wrapper's input_transposes, built once a packing), then the
//      direction cotangent a thread a coordinate, as soon as dzr0 is
//      complete; and at the end dz1 w1^T, the point cotangent, on the CUDA
//      cores, a warp a point (each lane 8 of dz1's 256 columns as stored in
//      bf16, the three sums added over the warp by shuffles). That product
//      has K = 256 but only 3 output columns: on the tensor cores it would
//      fill 3 of a tile's 8 (or of gemm_fwd's 128) and cost more in staging
//      than its 768 MACs a point, about 0.05% of the kernel's products.
//   3. reduce_partials adds the per-CTA partials in CTA order. Nothing is
//      atomic, so two launches give the same bits.
// Rounding follows _mlp_bwd_core (nerf_tpu/ops/pallas/fused_siren.py:147),
// as row 8's: both operands of every product are bf16 (dz rounded where it
// is stored), sums are float32, the bias, ws and bs gradients sum the
// unrounded values, h8 and sigma_pre are read in float32, and the cosines
// are the forward's own (fast_sin(arg + pi/2) of its argument).
//
// Stash: row 8's 15,744 bytes a point (bf16 activations and dz buffers, h8,
// the cosines and the per-point columns in float32; the point cotangent
// needs no column of its own): 258 MB at 16,384 points. Each CTA's gradient
// partial is 2.3 MB (NPART floats); the run length sets how many are
// written and read back.
//
// Widths: hidden 256 to 1024 and the direction encoding padded to 32 or 64
// columns, each shape built with its plan's -D flags (siren_plan.py): the
// stash a point grows to 62,592 bytes at 1024 (1.0 GB at 16,384 points).
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_siren_tc_common.cuh"

namespace siren {
namespace {

// The input-product matrix: wr0d^T (HR x DP) zero-padded to HR x NI.
constexpr int N_WT_IN = HR * NI;

__device__ __forceinline__ unsigned char* cta_stash(unsigned char* scratch, int b, int cap) {
  return scratch + static_cast<size_t>(b) * cap * TC_BYTES_PER_POINT;
}

// Step 1: the forward of chunk blockIdx.x into the stash of the backward
// CTA that owns it (runs of `run` points, a multiple of 64).
__global__ void __launch_bounds__(THREADS, 2)
siren_field_bwd_tc_fwd(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ vec, const bf16* __restrict__ wmat, Siren sp,
                       int n, int run, int cap, int real_d, unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  const TcSmem sm = carve_smem(reinterpret_cast<unsigned char*>(smem4));
  const int p0 = blockIdx.x * TC_P;
  const int b = p0 / run;
  const TcStash st = carve_stash(cta_stash(scratch, b, cap), cap);
  forward_chain_siren_tc<true>(
      [&] { load_point_chunk_tc(pts, dirs, p0, min(TC_P, n - p0), real_d, sm); }, vec, sp, wmat,
      sm, st, static_cast<size_t>(p0 - b * run), cap);
}

// The field's input products, as row 8's backward's hooks, over a CTA's
// points [p0, p0 + npts) (rows < cap_c): wr0d_t is wr0d^T zero-padded to
// HR x NI, w1 the packed first layer (its rows 0..2). The direction
// cotangent's tiles use act1 as floats.
struct InputHooks {
  const float* dirs;
  const bf16* wr0d_t;
  const bf16* w1;
  float* dpts;
  float* ddirs;
  int p0, npts, cap_c, real_d;
  const BwdSmem& sm;

  __device__ void on_dzr0(const bf16* dzr0) const {
    direction_cotangent_tc(dzr0, wr0d_t, dirs, p0, npts, cap_c, real_d, ddirs, sm.act0,
                           reinterpret_cast<float*>(sm.act1), sm.wst);
  }
  // dpts = dz1 w1^T (the three coordinates' rows): a warp a point, lane k
  // columns 8k .. 8k + 7 of each block of 256
  __device__ void on_dz1(const bf16* dz1) const {
    constexpr int NCB = H / NB;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float w[NCB][3][8];
#pragma unroll
    for (int b = 0; b < NCB; ++b)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          w[b][k][u] = __bfloat162float(w1[k * H + b * NB + lane * 8 + u]);
    for (int l = warp; l < npts; l += WARPS) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int b = 0; b < NCB; ++b) {
        const uint4 pk = *reinterpret_cast<const uint4*>(dz1 + static_cast<size_t>(l) * LDZ +
                                                         b * NB + lane * 8);
        const bf16* d = reinterpret_cast<const bf16*>(&pk);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float v = __bfloat162float(d[u]);
          s0 = fmaf(v, w[b][0][u], s0);
          s1 = fmaf(v, w[b][1][u], s1);
          s2 = fmaf(v, w[b][2][u], s2);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (lane < 3)
        dpts[static_cast<size_t>(p0 + l) * 3 + lane] = lane == 0 ? s0 : (lane == 1 ? s1 : s2);
    }
  }
};

// Step 2: the heads' backward (a thread a point), then the MLP backward
// with the input products over the CTA's run of points.
__global__ void __launch_bounds__(THREADS, 1)
siren_field_bwd_tc_bwd(const float* __restrict__ dirs, const float* __restrict__ cot,
                       const float* __restrict__ vec, const bf16* __restrict__ wmat,
                       const bf16* __restrict__ wt_in, Siren sp, int n, int run, int cap,
                       int real_d, unsigned char* __restrict__ scratch,
                       float* __restrict__ partial, float* __restrict__ dpts,
                       float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const BwdSmem sm{reinterpret_cast<bf16*>(sb + BB_ACT0), reinterpret_cast<bf16*>(sb + BB_ACT1),
                   reinterpret_cast<float*>(sb + BB_COS), reinterpret_cast<bf16*>(sb + BB_WST),
                   reinterpret_cast<float*>(sb + BB_COL), reinterpret_cast<float*>(sb + BB_RED)};
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * run;
  const int npts = min(run, n - p0);
  const int cap_c = (npts + TC_P - 1) / TC_P * TC_P;   // whole forward chunks
  const size_t cz = static_cast<size_t>(cap);
  const TcStash st = carve_stash(cta_stash(scratch, blockIdx.x, cap), cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = st.cols;
  for (int l = tid; l < cap_c; l += THREADS) {
    float dz[3] = {0.f, 0.f, 0.f};
    float ds = 0.f;
    if (l < npts) {
      const float* g = cot + static_cast<size_t>(p0 + l) * 4;
      for (int c = 0; c < 3; ++c) {
        const float r = cols[(C_RGB + c) * cz + l];
        dz[c] = ((g[c] * r) * (1.f - r)) * sp.rgb_mul;
      }
      ds = cols[C_SIGP * cz + l] > 0.f ? g[3] * sp.sigma_mul : 0.f;
    }
    for (int c = 0; c < 3; ++c) cols[(C_DZR1 + c) * cz + l] = dz[c];
    cols[C_DSIG * cz + l] = ds;
  }
  if (tid == 0) part[N_TOT] = 0.f;
  __syncthreads();
  const InputHooks hk{dirs, wt_in, wmat + OFF_W1, dpts, ddirs, p0, npts, cap_c, real_d, sm};
  backward(st, cap, sp, vec, wmat, part, cap_c, sm, hk);
}

int launch_field_bwd_tc(const float* pts, const float* dirs, const float* cot, const void* wmat,
                        const void* wt_in, const float* vec, int n_w, int n_b, int n_t,
                        int is_bf16, int n, int run, int cap, int real_d, float w0, float w0h,
                        float sigma_mul, float rgb_mul, float* scratch, float* partial,
                        float* out, float* dpts, float* ddirs, void* stream) {
  if (n_w != N_W || n_b != N_B || n_t != N_WT_IN || is_bf16 != 1 || n <= 0 || run <= 0 ||
      run % TC_P != 0 || cap % TC_P != 0 || cap < run || real_d < 3 || real_d > DP)
    return -1;
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(siren_field_bwd_tc_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SB_END);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(siren_field_bwd_tc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* w = static_cast<const bf16*>(wmat);
  unsigned char* sc = reinterpret_cast<unsigned char*>(scratch);
  const int grid = (n + run - 1) / run;
  siren_field_bwd_tc_fwd<<<(n + TC_P - 1) / TC_P, THREADS, SB_END, s>>>(pts, dirs, vec, w, sp, n,
                                                                       run, cap, real_d, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  siren_field_bwd_tc_bwd<<<grid, THREADS, SMEM_BWD, s>>>(
      dirs, cot, vec, w, static_cast<const bf16*>(wt_in), sp, n, run, cap, real_d, sc, partial,
      dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, s>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace siren

extern "C" {

// Sizes the caller allocates: scratch floats per stashed point (the stash's
// bytes / 4), floats per CTA partial, floats of the output (the gradients,
// then a zero), and the length of the input-product matrix (wr0d^T
// zero-padded to HR x 128).
void siren_field_bwd_tc_sizes(int* per_point, int* npart, int* n_out, int* n_t_in) {
  *per_point = siren::TC_BYTES_PER_POINT / 4;
  *npart = siren::NPART;
  *n_out = siren::N_TOT + 1;
  *n_t_in = siren::N_WT_IN;
}

// The bf16 field backward, with siren_field_bwd's arguments and the input
// products' matrix: `wmat_t` is not read (the products read the packed W
// itself), `wt_in` holds wr0d^T zero-padded to HR x 128 (n_t values),
// `bf16` must be 1, and `pts_per_cta` (the run) must be a multiple of 64.
// `scratch` holds grid * cap * per_point floats, `partial` grid * npart,
// `out` n_out, where grid = ceil(n / pts_per_cta) and cap >= pts_per_cta
// is a multiple of 64. Returns 0 on success, a cudaError_t code after a
// failed launch, or -1 when the packed buffers or the shapes do not fit
// this kernel.
int siren_field_bwd_tc(const float* pts, const float* dirs, const float* cot, const void* wmat,
                       const void* wmat_t, const void* wt_in, const float* vec, int n_w, int n_b,
                       int n_t, int bf16, int n, int pts_per_cta, int cap, int real_d, float w0,
                       float w0h, float sigma_mul, float rgb_mul, float* scratch, float* partial,
                       float* out, float* dpts, float* ddirs, void* stream) {
  (void)wmat_t;
  return siren::launch_field_bwd_tc(pts, dirs, cot, wmat, wt_in, vec, n_w, n_b, n_t, bf16, n,
                                    pts_per_cta, cap, real_d, w0, w0h, sigma_mul, rgb_mul,
                                    scratch, partial, out, dpts, ddirs, stream);
}

const char* siren_field_bwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
