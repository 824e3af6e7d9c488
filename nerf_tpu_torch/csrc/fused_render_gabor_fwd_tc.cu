// Fused GaborNet forward render in bfloat16 on Hopper's tensor cores
// (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_render_gabor.py::_fwd_kernel (the
// forward route of FusedGaborRender.__call__) in bfloat16 mode. Same
// function as fused_render_gabor_fwd.cu, which keeps the float32 mode: for
// every sample t of a ray, the filters g_i = sin(A_i + t B_i) exp(P_i + t
// Q_i + t^2 R_i) from the ray's coefficients (the prep, outside the
// kernel), the network of _mlp_tile on them and on the L_dir frequency
// encoding of the view direction, then compositing: deltas from t with the
// 1e10 tail, one_m = exp(-sigma*delta), exclusive-cumprod transmittance,
// w = T*(1-one_m), and per ray rgb = sum w*c, acc = sum w, depth = sum w*t.
// The weights (R,S) leave the kernel; the filters and the (points x 256)
// activations never do.
//
// What bounds it on this card: operations. One sample costs 561,152 MACs
// (0.297 ms at 1024 rays x 256 samples on the tensor cores' 989 TFLOP/s in
// bf16) and 4,096 transcendentals, a sine and an exponential per filter
// element (about 20 CUDA-core instructions each, with the filter's own
// arithmetic: about as long again as the products, at the CUDA cores'
// instruction rate). The kernel it replaced in bf16
// (fused_render_gabor_fwd.cu, every product an fp32 FMA on the CUDA cores)
// took 10.264 ms there on an NVIDIA H100 80GB HBM3 at 700 W, 0.029 of the
// bound.
//
// Design: a CTA owns whole rays and walks their samples in chunks of 64
// points; two CTAs share an SM, so that one CTA's filter epilogues and
// compositing (CUDA cores) overlap the other's products (tensor cores).
// Each stage's product u_i = z_{i-1} W_{i-1} (and wre, wr0f, wr0d) is
// render_tc.cuh's gemm_fwd: the chunk's bf16 activation tile in shared
// memory times the weights streamed through a ring of cp.async stages,
// mma.sync m16n8k16 with float32 sums. Its epilogue evaluates the filter of
// each accumulator element (row = point, column = neuron) in registers,
// exactly as fused_render_gabor_common.cuh::filter_at<true> (each operation
// rounded on its own, the degree-11 fast_sin of the TPU kernel's _trig,
// expf without fast math; the filters never rounded), forms z_i = (u_i +
// b) g_i in float32 (z_1 = g_1 has no product) and stores z_i rounded to
// bf16 as the next product's operand. The density is the float32 reduction
// of the UNROUNDED z_8 against ws (each thread over its columns, the 4
// lanes of a row by shuffle, the 8 warps in order), plus bs, relu, times
// sigma_mul; the feature product reads the rounded z_8. The rgb head's
// 128 x 3 layer and the sigmoid run on the CUDA cores; thread 0 then runs
// the compositing scan over the chunk in sample order, carrying T from
// chunk to chunk (render_common.cuh::composite_chunk).
//
// Coefficient reads: direct __ldg float2 loads (two neighbouring columns of
// an accumulator pair) through L1, not a shared-memory slab staged by
// cp.async. A stage's slab is 5 KB a ray; each warp reads only its own 32
// columns of it, and the 8 lanes of a column group load the same addresses
// (one transaction), so a slab is read once a chunk and the staging would
// buy nothing but a barrier and 5 KB of shared memory. Where a chunk lies in
// one ray (every chunk at S = 256, lego_siren.txt's samples) each thread
// loads a column pair's five coefficients once and evaluates its 8 rows
// from them; where a chunk spans rays (S = 37, a ragged last CTA) or is
// short, each row loads them by its own ray (-1 past the chunk's points:
// zero filters), as fused_render_gabor_fwd.cu's SM_ROW does.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "render_tc.cuh"
#include "fused_render_gabor_common.cuh"

namespace gabor {
namespace {

// Shared memory (bytes): the activation tile (each stage's z overwrites its
// input once the product has read it), the direction encoding, the weight
// stages, the density partials, the chunk's per-point columns (GC_*) and
// each point's coefficient row. Two CTAs share an SM.
constexpr int GB_ACT = 0;
constexpr int GB_DENC = GB_ACT + TC_P * LDS * 2;
constexpr int GB_WST = GB_DENC + TC_P * LDD * 2;
constexpr int GB_SIG = GB_WST + WST_FWD_BYTES;
constexpr int GB_COL = GB_SIG + WARPS * TC_P * 4;
constexpr int GC_T = 0, GC_T2 = 1, GC_DELTA = 2, GC_SIGMA = 3, GC_RGB = 4, N_GC = 7;
constexpr int GB_ROW = GB_COL + N_GC * TC_P * 4;
constexpr int SMEM_GABOR_TC = GB_ROW + TC_P * 4;
static_assert(2 * (SMEM_GABOR_TC + 1024) <= 233472, "two forward CTAs share an SM");

struct GSmem {
  bf16* act;
  bf16* denc;
  bf16* wst;
  float* sig;
  float* col;
  int* row;       // the point's ray * NH, -1 past the chunk's points
};

// The direction encoding (exact sine, rounded to bf16; point-major) of ray
// samples [chunk0, chunk0 + nvalid) and their columns t, t^2, delta and
// coefficient row, zero (row -1) past nvalid, as
// fused_render_gabor_common.cuh::load_ray_chunk<true>. Ends past a barrier.
__device__ void load_chunk(const RayInputs& in, int chunk0, int nvalid, const GSmem& sm) {
  const int tid = threadIdx.x, S = in.S;
  for (int idx = tid; idx < TC_P * DP; idx += THREADS) {
    const int p = idx / DP, c = idx % DP;
    float v = 0.f;
    if (p < nvalid && c < in.real_d) {
      const int ray = (chunk0 + p) / S;
      const int d = c < 3 ? c : (c - 3) % 3;
      v = encode_col<false>(in.viewdirs[ray * 3 + d], c);
    }
    sm.denc[p * LDD + c] = __float2bfloat16_rn(v);
  }
  if (tid < TC_P) {
    const int g = chunk0 + tid;
    float tv = 0.f, dv = 0.f;
    int row = -1;
    if (tid < nvalid) {
      tv = in.t[g];
      dv = (g % S == S - 1) ? 1e10f : __fsub_rn(in.t[g + 1], tv);
      row = (g / S) * NH;
    }
    sm.col[GC_T * TC_P + tid] = tv;
    sm.col[GC_T2 * TC_P + tid] = __fmul_rn(tv, tv);
    sm.col[GC_DELTA * TC_P + tid] = dv;
    sm.row[tid] = row;
  }
  __syncthreads();
}

// The five coefficients (A, B, P, Q, R) of two neighbouring columns at c.
__device__ __forceinline__ void load_coef(float2 (&k)[NCOEF], const float* c, size_t plane) {
#pragma unroll
  for (int i = 0; i < NCOEF; ++i) k[i] = __ldg(reinterpret_cast<const float2*>(c + i * plane));
}

// The epilogue of stage `stage` (0-based) over the warp's 64 x 32 tile:
// for each accumulator element the filter g, then z = g (first) or z =
// (acc + bias) g, stored rounded to bf16 into the activation tile; the
// last stage also adds z . ws of the thread's columns into sp, in float32
// on the unrounded z. UNIFORM: every point of the chunk lies in the ray
// whose coefficient row is base_u.
template <bool UNIFORM>
__device__ __forceinline__ void stage_epilogue_tc(float (&acc)[4][4][4], const Gabor& gp,
                                                  int stage, bool first, bool last,
                                                  const float* __restrict__ bias,
                                                  const float* __restrict__ ws, int base_u,
                                                  const GSmem& sm, float (&sp)[4][2]) {
  const int l = threadIdx.x & 31, g = l >> 2, c = l & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
  const float* coef = gp.coef + stage * H;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + j * 8 + 2 * c;
    float2 k[NCOEF];
    if constexpr (UNIFORM) load_coef(k, coef + base_u + col, gp.plane);
    float b0 = 0.f, b1 = 0.f, w0 = 0.f, w1 = 0.f;
    if (!first) {
      b0 = __ldg(bias + col);
      b1 = __ldg(bias + col + 1);
    }
    if (last) {
      w0 = __ldg(ws + col);
      w1 = __ldg(ws + col + 1);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        const int base = UNIFORM ? base_u : sm.row[row];
        float g0 = 0.f, g1 = 0.f;
        if (UNIFORM || base >= 0) {
          if constexpr (!UNIFORM) load_coef(k, coef + base + col, gp.plane);
          const float tv = sm.col[GC_T * TC_P + row], t2 = sm.col[GC_T2 * TC_P + row];
          const Filter f0 = filter_at<true>(k[0].x, k[1].x, k[2].x, k[3].x, k[4].x, tv, t2);
          const Filter f1 = filter_at<true>(k[0].y, k[1].y, k[2].y, k[3].y, k[4].y, tv, t2);
          g0 = __fmul_rn(f0.sn, f0.E);
          g1 = __fmul_rn(f1.sn, f1.E);
        }
        float z0 = g0, z1 = g1;
        if (!first) {
          z0 = __fmul_rn(acc[mt][j][2 * h] + b0, g0);
          z1 = __fmul_rn(acc[mt][j][2 * h + 1] + b1, g1);
        }
        if (last) {
          sp[mt][h] = fmaf(z0, w0, sp[mt][h]);
          sp[mt][h] = fmaf(z1, w1, sp[mt][h]);
        }
        put2(sm.act + row * LDS + col, z0, z1);
      }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
fused_gabor_fwd_tc_kernel(RayInputs in, Gabor gp, const bf16* __restrict__ wmat, int rays_per_cta,
                          float* __restrict__ rgb_out, float* __restrict__ acc_out,
                          float* __restrict__ depth_out, float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const GSmem sm{reinterpret_cast<bf16*>(sb + GB_ACT), reinterpret_cast<bf16*>(sb + GB_DENC),
                 reinterpret_cast<bf16*>(sb + GB_WST), reinterpret_cast<float*>(sb + GB_SIG),
                 reinterpret_cast<float*>(sb + GB_COL), reinterpret_cast<int*>(sb + GB_ROW)};
  const float* __restrict__ vec = in.vec;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = in.S;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, in.num_rays);
  if (ray0 >= ray1) return;
  const int npts = (ray1 - ray0) * S;
  RaySums sums;             // compositing carry (thread 0 only)
  for (int c0 = 0; c0 < npts; c0 += TC_P) {
    const int chunk0 = ray0 * S + c0, nvalid = min(TC_P, npts - c0);
    load_chunk(in, chunk0, nvalid, sm);
    const int ray_first = chunk0 / S;
    const bool uniform = nvalid == TC_P && (chunk0 + TC_P - 1) / S == ray_first;
    const int base_u = ray_first * NH;
    float acc[4][4][4];
    float sp[4][2] = {};
    // ---- stages: z_1 = g_1, then z_i = (z_{i-1} W_{i-1} + b_{i-1}) g_i ----
#pragma unroll 1
    for (int l = 1; l <= NL; ++l) {
      const bool first = l == 1, last = l == NL;
      zero_acc(acc);
      if (!first) gemm_fwd<H, H>(acc, sm.act, LDS, wmat + off_w(l - 1), sm.wst);
      const float* bias = first ? nullptr : vec + (l - 2) * H;
      const float* ws = last ? vec + OFF_WS : nullptr;
      if (uniform)
        stage_epilogue_tc<true>(acc, gp, l - 1, first, last, bias, ws, base_u, sm, sp);
      else
        stage_epilogue_tc<false>(acc, gp, l - 1, first, last, bias, ws, base_u, sm, sp);
    }
    // ---- the density row: z_8 . ws by row, the 8 warps in order ----
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = sp[mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) sm.sig[warp * TC_P + mt * 16 + (lane >> 2) + 8 * h] = v;
      }
    __syncthreads();
    if (tid < TC_P) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += sm.sig[w * TC_P + tid];
      sm.col[GC_SIGMA * TC_P + tid] = fmaxf(s + __ldg(vec + OFF_BS), 0.f) * gp.sigma_mul;
    }
    // ---- feature remap: no activation ----
    zero_acc(acc);
    gemm_fwd<H, H>(acc, sm.act, LDS, wmat + OFF_WRE, sm.wst);
    store_act<4>(acc, vec + OFF_BRE, false, sm.act);
    // ---- rgb head: relu layer on [feat, denc], then the output ----
    {
      float acc2[4][2][4];
      zero_acc(acc2);
      gemm_fwd<H, HR>(acc2, sm.act, LDS, wmat + OFF_WR0F, sm.wst);
      gemm_fwd<DP, HR>(acc2, sm.denc, LDD, wmat + OFF_WR0D, sm.wst);
      store_act<2>(acc2, vec + OFF_BR0, true, sm.act);
    }
    __syncthreads();
    if (tid < 3 * TC_P) {
      const int ch = tid / TC_P, p = tid % TC_P;
      float z = 0.f;
      for (int k = 0; k < HR; ++k)
        z = fmaf(__bfloat162float(sm.act[p * LDS + k]),
                 __bfloat162float(wmat[OFF_WR1 + k * 8 + ch]), z);
      z = (z + __ldg(vec + OFF_BR1 + ch)) * gp.rgb_mul;
      sm.col[(GC_RGB + ch) * TC_P + p] = 1.f / (1.f + expf(-z));
    }
    __syncthreads();
    if (tid == 0)
      composite_chunk(sums, sm.col + GC_T * TC_P, sm.col + GC_DELTA * TC_P,
                      sm.col + GC_SIGMA * TC_P, sm.col + GC_RGB * TC_P, chunk0, nvalid, S,
                      rgb_out, acc_out, depth_out, weights_out);
    __syncthreads();
  }
}

int launch_fwd_tc(const float* coef, const float* viewdirs, const float* t, const void* wmat,
                  const float* vec, int n_w, int n_b, int is_bf16, int num_rays, int S,
                  int rays_per_cta, int real_d, float sigma_mul, float rgb_mul, float* rgb,
                  float* acc, float* depth, float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || is_bf16 != 1 || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || real_d > DP)
    return -1;
  const RayInputs in{nullptr, nullptr, viewdirs, t, vec, num_rays, S, 0, real_d};
  const Gabor gp{coef, static_cast<size_t>(num_rays) * NH, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gabor_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_GABOR_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  fused_gabor_fwd_tc_kernel<<<grid, THREADS, SMEM_GABOR_TC, s>>>(
      in, gp, static_cast<const bf16*>(wmat), rays_per_cta, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gabor

extern "C" {

// The bf16 forward render. `coef` holds the (5, num_rays, 8 x 256) float32
// coefficients A, B, P, Q, R; the arguments are those of fused_gabor_fwd,
// and `is_bf16` must be 1. Returns 0 on success, a cudaError_t code after a
// failed launch, or -1 when the packed buffers or the shapes do not fit
// this kernel.
int fused_gabor_fwd_tc(const float* coef, const float* viewdirs, const float* t,
                       const void* wmat, const float* vec, int n_w, int n_b, int is_bf16,
                       int num_rays, int S, int rays_per_cta, int real_d, float sigma_mul,
                       float rgb_mul, float* rgb, float* acc, float* depth, float* weights,
                       void* stream) {
  return gabor::launch_fwd_tc(coef, viewdirs, t, wmat, vec, n_w, n_b, is_bf16, num_rays, S,
                              rays_per_cta, real_d, sigma_mul, rgb_mul, rgb, acc, depth,
                              weights, stream);
}

const char* fused_gabor_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
