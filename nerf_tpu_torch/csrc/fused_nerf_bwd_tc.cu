// NeRF field backward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_nerf.py::_bwd_kernel (the custom VJP
// of make_fused_nerf_apply's apply: a NeRF distillation student's gradient)
// in bfloat16 mode. Same function as fused_nerf_bwd.cu, which keeps the
// float32 mode: from the cotangent (n, 4) of [rgb, sigma], recompute the
// forward (_forward_tile), take the heads' backward (dzr1 = g_rgb r (1 -
// r), dsig = g_sigma where sigma_pre > 0), run _mlp_bwd_core with its input
// products dz1 w1^T, dz6 w6p^T and dzr0 wr0d^T, then _encode_bwd with the
// exact cosine: the 28 float32 weight and bias gradients of the packed
// layout (fused_render_common.cuh OFF_*), the point and direction
// cotangents (n, 3) each.
//
// What bounds it on this card: operations. A point costs three times the
// forward's 658,944 MACs less nothing the TPU kernel skips (the recomputed
// forward, every dz W^T with the three input products, every A^T dz):
// 0.0655 ms at 16,384 points (a distillation step's batch) on the tensor
// cores' 989 TFLOP/s in bf16. The kernel it replaced in bf16
// (fused_nerf_bwd.cu, every product an fp32 FMA on the CUDA cores) took
// 3.061 / 10.905 ms at 16,384 / 65,536 points on an NVIDIA H100 80GB HBM3
// at 700 W, 0.021 of the bound, and recomputed the forward in another
// summation order than the tensor-core forward it differentiates.
//
// Design: row 5's split (fused_render_train_tc.cu) without the
// compositing, on row 1's chain:
//   1. Forward kernel, a CTA a 64-point chunk, two CTAs an SM: row 1's
//      chain (fused_render_tc_common.cuh::forward_chain_tc<true> behind
//      encode_point_chunk_tc), stashing what row 5 stashes into the stash
//      of the backward CTA that owns the chunk. The recomputed rgb and
//      sigma_pre are row 1's outputs bit for bit.
//   2. Backward kernel, a CTA a run of points (a multiple of 64): one
//      thread a point takes the heads' backward from the given cotangent;
//      then row 5's MLP backward (fused_render_tc_common.cuh::backward:
//      each dz W^T against the packed W itself, each A^T dz once per CTA
//      on the tensor cores), whose hooks take the three input products on
//      gemm_fwd against W_in^T zero-padded to 128 columns (the wrapper's
//      input_transposes, built once a packing): dzr0 wr0d^T, then the
//      direction cotangent a thread a coordinate, as soon as dzr0 is
//      complete; dz6 w6p^T into the stash's float32 columns; dz1 w1^T added
//      to them and the point cotangent a thread a coordinate.
//   3. reduce_partials adds the per-CTA partials in CTA order. Nothing is
//      atomic, so two launches give the same bits.
// Rounding follows _mlp_bwd_core: both operands of every product are bf16
// (dz rounded where it is stored), sums are float32, the bias and w10s
// gradients sum the unrounded dz, h9, sigma_pre and the sigmoid are read in
// float32, and dpenc = dz6 w6p^T + dz1 w1^T adds two float32 products.
//
// Stash: row 5's 7,664 bytes a point (bf16 activations and dz buffers, h9
// and the per-point columns in float32) and dz6 w6p^T's 64 float32
// columns: 7,920 bytes a point, 130 MB at 16,384 points. Each CTA's
// gradient partial is 2.65 MB (N_TOT floats); the run length sets how many
// are written and read back.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_tc_common.cuh"

namespace {

using namespace nerf;

// A backward CTA's stash: row 5's, then dz6 w6p^T (float32, PP a point).
constexpr int FIELD_BYTES_PER_POINT = TC_BYTES_PER_POINT + 4 * PP;
static_assert(FIELD_BYTES_PER_POINT % 16 == 0, "stash rows must stay 16-byte aligned");
constexpr int SMEM_FWD = FB_END;
static_assert(SMEM_FWD <= 232448 && (!ONE_TILE || 2 * (SMEM_FWD + 1024) <= 233472),
              "two forward CTAs share an SM at hidden 256, one fits wider");

__device__ __forceinline__ unsigned char* cta_stash(unsigned char* scratch, int b, int cap) {
  return scratch + static_cast<size_t>(b) * cap * FIELD_BYTES_PER_POINT;
}

// Step 1: the forward of chunk blockIdx.x into the stash of the backward
// CTA that owns it (runs of `run` points, a multiple of 64).
__global__ void __launch_bounds__(THREADS, 2)
nerf_field_bwd_tc_fwd(const float* __restrict__ pts, const float* __restrict__ dirs,
                      const float* __restrict__ vec, const bf16* __restrict__ wmat, int n,
                      int run, int cap, int real_p, int real_d,
                      unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const FwdSmem sm = fwd_smem(sb, -1);
  const int p0 = blockIdx.x * TC_P;
  const int b = p0 / run;
  const TcStash st = carve_tc_stash(cta_stash(scratch, b, cap), cap);
  forward_chain_tc<true>(
      [&] { encode_point_chunk_tc(pts, dirs, p0, min(TC_P, n - p0), real_p, real_d, sm); }, vec,
      wmat, sm, st, static_cast<size_t>(p0 - b * run), cap);
}

// The field's input products, as row 5's backward's hooks, over a CTA's
// points [p0, p0 + npts) (rows < cap_c): wt_in holds w1^T, w6p^T and
// wr0d^T, each zero-padded to 128 columns (OFF_T_*); gp6 the stash's
// dz6 w6p^T columns. The encoding-cotangent tiles use act1 as floats.
struct InputHooks {
  const float* pts;
  const float* dirs;
  const bf16* wt_in;
  float* gp6;
  float* dpts;
  float* ddirs;
  int p0, npts, cap_c, real_p, real_d;
  const BwdSmem& sm;

  __device__ void on_dzr0(const bf16* dzr0) const {
    direction_cotangent_tc(dzr0, wt_in + OFF_T_WR0D, dirs, p0, npts, cap_c, real_d, ddirs,
                           sm.act0, reinterpret_cast<float*>(sm.act1), sm.wst);
  }
  __device__ void on_dz6(const bf16* dz6) const {
    input_product<H>(
        dz6, cap_c, wt_in + OFF_T_W6P, sm.act0, sm.wst,
        [&](int l0, float (&acc)[MT_B][NI / 64][4]) {
          each_pair<NI / 64>(acc, (threadIdx.x >> 5) * 16,
                       [&](int, int, int, int row, int col, float& v0, float& v1) {
                         if (col < PP)
                           *reinterpret_cast<float2*>(
                               gp6 + static_cast<size_t>(l0 + row) * PP + col) =
                               make_float2(v0, v1);
                       });
        },
        [](int) {});
  }
  __device__ void on_dz1(const bf16* dz1) const {
    float* g = reinterpret_cast<float*>(sm.act1);
    input_product<H>(
        dz1, cap_c, wt_in + OFF_T_W1, sm.act0, sm.wst,
        [&](int l0, float (&acc)[MT_B][NI / 64][4]) {
          each_pair<NI / 64>(acc, (threadIdx.x >> 5) * 16,
                       [&](int, int, int, int row, int col, float& v0, float& v1) {
                         if (col < PP) {
                           const float2 a = *reinterpret_cast<const float2*>(
                               gp6 + static_cast<size_t>(l0 + row) * PP + col);
                           *reinterpret_cast<float2*>(g + row * LDG + col) =
                               make_float2(a.x + v0, a.y + v1);
                         }
                       });
        },
        [&](int l0) {
          encode_bwd_rows(g, pts, static_cast<size_t>(p0 + l0), npts - l0, real_p, dpts);
        });
  }
};

// Step 2: the heads' backward (a thread a point), then the MLP backward
// with the input products over the CTA's run of points.
__global__ void __launch_bounds__(THREADS, 1)
nerf_field_bwd_tc_bwd(const float* __restrict__ pts, const float* __restrict__ dirs,
                      const float* __restrict__ cot, const float* __restrict__ vec,
                      const bf16* __restrict__ wmat, const bf16* __restrict__ wt_in, int n,
                      int run, int cap, int real_p, int real_d,
                      unsigned char* __restrict__ scratch, float* __restrict__ partial,
                      float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const BwdSmem sm{reinterpret_cast<bf16*>(sb + BB_ACT0), reinterpret_cast<bf16*>(sb + BB_ACT1),
                   sb + BB_MASK, reinterpret_cast<bf16*>(sb + BB_WST),
                   reinterpret_cast<float*>(sb + BB_COL), reinterpret_cast<float*>(sb + BB_RED)};
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * run;
  const int npts = min(run, n - p0);
  const int cap_c = (npts + TC_P - 1) / TC_P * TC_P;
  const size_t cz = static_cast<size_t>(cap);
  unsigned char* cta = cta_stash(scratch, blockIdx.x, cap);
  const TcStash st = carve_tc_stash(cta, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = st.cols;
  for (int l = tid; l < cap_c; l += THREADS) {
    float dz[3] = {0.f, 0.f, 0.f};
    float ds = 0.f;
    if (l < npts) {
      const float* g = cot + static_cast<size_t>(p0 + l) * 4;
      for (int c = 0; c < 3; ++c) {
        const float r = cols[(C_RGB + c) * cz + l];
        dz[c] = (g[c] * r) * (1.f - r);
      }
      ds = cols[C_SIGP * cz + l] > 0.f ? g[3] : 0.f;
    }
    for (int c = 0; c < 3; ++c) cols[(C_DZR1 + c) * cz + l] = dz[c];
    cols[C_DSIG * cz + l] = ds;
  }
  if (tid == 0) part[N_TOT] = 0.f;
  __syncthreads();
  const InputHooks hk{pts, dirs, wt_in,
                      reinterpret_cast<float*>(cta + cz * TC_BYTES_PER_POINT), dpts, ddirs,
                      p0, npts, cap_c, real_p, real_d, sm};
  backward(st, cap, vec, wmat, part, cap_c, sm, hk);
}

}  // namespace

extern "C" {

// Sizes the caller allocates, as fused_nerf_bwd_sizes gives them: scratch
// floats per stashed point (the stash's bytes / 4), floats per CTA
// partial, floats of the output (the gradients, then a zero), and the
// length of the input-product matrix buffer.
void fused_nerf_bwd_tc_sizes(int* per_point, int* npart, int* n_out, int* n_t_in) {
  *per_point = FIELD_BYTES_PER_POINT / 4;
  *npart = NPART;
  *n_out = N_TOT + 1;
  *n_t_in = N_T_IN;
}

// The bf16 field backward, with fused_nerf_bwd's arguments: `wmat_t` is
// not read (the products read the packed W itself), `wt_in` holds w1^T,
// w6p^T and wr0d^T zero-padded to 128 columns, `bf16` must be 1, and
// `pts_per_cta` (the run) must be a multiple of 64. `scratch` holds grid *
// cap * per_point floats, `partial` grid * npart, `out` n_out, where grid
// = ceil(n / pts_per_cta) and cap >= pts_per_cta is a multiple of 64.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_nerf_bwd_tc(const float* pts, const float* dirs, const float* cot, const void* wmat,
                      const void* wmat_t, const void* wt_in, const float* vec, int n_w, int n_b,
                      int n_t, int bf16_mode, int n, int pts_per_cta, int cap, int real_p,
                      int real_d, float* scratch, float* partial, float* out, float* dpts,
                      float* ddirs, void* stream) {
  (void)wmat_t;
  if (n_w != N_W || n_b != N_B || n_t != N_T_IN || bf16_mode != 1 || n <= 0 ||
      pts_per_cta <= 0 || pts_per_cta % TC_P != 0 || cap % TC_P != 0 || cap < pts_per_cta ||
      real_p < 3 || real_p > PP || real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(nerf_field_bwd_tc_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nerf_field_bwd_tc_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* w = static_cast<const bf16*>(wmat);
  unsigned char* sc = reinterpret_cast<unsigned char*>(scratch);
  const int grid = (n + pts_per_cta - 1) / pts_per_cta;
  nerf_field_bwd_tc_fwd<<<(n + TC_P - 1) / TC_P, THREADS, SMEM_FWD, s>>>(
      pts, dirs, vec, w, n, pts_per_cta, cap, real_p, real_d, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nerf_field_bwd_tc_bwd<<<grid, THREADS, SMEM_BWD, s>>>(
      pts, dirs, cot, vec, w, static_cast<const bf16*>(wt_in), n, pts_per_cta, cap, real_p,
      real_d, sc, partial, dpts, ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_TOT, NPART><<<(N_TOT + 1 + 255) / 256, 256, 0, s>>>(partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_nerf_bwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
