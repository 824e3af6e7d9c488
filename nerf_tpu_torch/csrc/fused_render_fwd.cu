// Fused NeRF forward render for Hopper (sm_90a): positional encoding, the
// 11-matmul NeRF MLP and volume compositing in one kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_render.py::_fwd_kernel (the forward
// route of FusedNerfRender.__call__). Same function: for every sample
// p = o_aff + t * d_aff (o_aff/d_aff already carry the [near,far]->[-1,1]
// map), PE(p) with L_pos frequencies, PE(viewdir) with L_dir, the MLP of
// nerf_tpu/ops/pallas/fused_nerf.py::_mlp_tile, deltas from t with the 1e10
// tail, one_m = exp(-sigma*delta), exclusive-cumprod transmittance,
// w = T*(1-one_m), and per ray rgb = sum w*c, acc = sum w, depth = sum w*t.
// The weights (R,S) leave the kernel; sample positions, encodings and the
// (points x 256) activations never do.
//
// What bounds it on this card: operations. One sample costs 658,944 MACs
// at hidden 256, so a 8192-ray launch is 0.7 to 2.1 TFLOP, against a few MB
// of device-memory traffic. float32 mode must be true float32 (no TF32, no
// single bf16 pass), so it runs on the CUDA cores (67 TFLOP/s peak);
// bfloat16 mode rounds every matmul input and weight to bf16 and sums in
// float32, which this first version also does on the CUDA cores (its bound
// is the tensor cores' 989 TFLOP/s, far above what this design reaches).
//
// Design: a CTA owns whole rays and walks their samples in chunks of 64
// points. A chunk's activations live in shared memory, transposed
// (feature-major, 64 points contiguous), ping-ponged between two 256 x 68
// float buffers. Weights stay in global memory (in L2: 2.6 MB float32, 1.3
// MB bf16) and stream through a double-buffered 16-row shared-memory stage
// by cp.async. Each of 256 threads keeps an 8-point x 8-column register
// tile, so every k step is 64 FMAs against two broadcast and two vector
// shared loads. The density head is a float32 reduction of the unrounded
// h9 (warp shuffles); thread 0 then runs the transmittance scan over the
// chunk in sample order, carrying T from chunk to chunk, and writes the
// weights and the per-ray sums.
//
// Built by nerf_tpu_torch/ops/cuda/fused_render.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 256;        // hidden width (the only one supported)
constexpr int HR = H / 2;     // rgb-head width
constexpr int PP = 64;        // padded position-encoding width
constexpr int DP = 32;        // padded direction-encoding width
constexpr int P = 64;         // points per chunk
constexpr int LDA = P + 4;    // row stride (floats) of activation tiles
constexpr int KT = 16;        // weight rows per staged tile
constexpr int THREADS = 256;

// Packed matrix buffer: each matrix (K, N) row-major, (in, out) order, K
// padded with zero rows (w1/w6p to PP, wr0d to DP), wr1 padded to 8 columns.
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + PP * H;
constexpr int OFF_W3 = OFF_W2 + H * H;
constexpr int OFF_W4 = OFF_W3 + H * H;
constexpr int OFF_W5 = OFF_W4 + H * H;
constexpr int OFF_W6H = OFF_W5 + H * H;
constexpr int OFF_W6P = OFF_W6H + H * H;
constexpr int OFF_W7 = OFF_W6P + PP * H;
constexpr int OFF_W8 = OFF_W7 + H * H;
constexpr int OFF_W9 = OFF_W8 + H * H;
constexpr int OFF_W10F = OFF_W9 + H * H;
constexpr int OFF_WR0F = OFF_W10F + H * H;
constexpr int OFF_WR0D = OFF_WR0F + H * HR;
constexpr int OFF_WR1 = OFF_WR0D + DP * HR;
constexpr int N_W = OFF_WR1 + HR * 8;

// Packed float32 vector buffer: b1..b9, b10f, w10s (rounded to the compute
// dtype), br0, br1 (8), b10s.
constexpr int OFF_B10F = 9 * H;
constexpr int OFF_W10S = 10 * H;
constexpr int OFF_BR0 = 11 * H;
constexpr int OFF_BR1 = OFF_BR0 + HR;
constexpr int OFF_B10S = OFF_BR1 + 8;
constexpr int N_B = OFF_B10S + 1;

// Shared memory (floats): two activation buffers, the two encodings, the
// per-point chunk columns, then the weight stage (2 x KT x H of float32).
constexpr int SM_ACT0 = 0;
constexpr int SM_ACT1 = SM_ACT0 + H * LDA;
constexpr int SM_PENC = SM_ACT1 + H * LDA;
constexpr int SM_DENC = SM_PENC + PP * LDA;
constexpr int SM_T = SM_DENC + DP * LDA;
constexpr int SM_DELTA = SM_T + P;
constexpr int SM_SIGMA = SM_DELTA + P;
constexpr int SM_RGB = SM_SIGMA + P;         // 3 x P
constexpr int SM_WST = SM_RGB + 3 * P;
constexpr int SMEM_BYTES = SM_WST * 4 + 2 * KT * H * 4;
static_assert(SM_WST % 4 == 0, "weight stage must be 16-byte aligned");
static_assert(SMEM_BYTES <= 232448, "exceeds the per-block shared memory");

constexpr float HALF_PI = 1.5707963267948966f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive weights as float32.
__device__ __forceinline__ void load4(const float* p, float* w) {
  float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* w) {
  uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The degree-11 sine of nerf_tpu/ops/pallas/fused_nerf.py::_fast_sin, with
// every operation rounded as written (no FMA contraction), so that it
// matches the plain PyTorch version bit for bit.
__device__ __forceinline__ float fast_sin(float x) {
  const float two_pi = 6.283185307179586f;
  const float inv_two_pi = 0.15915494309189535f;
  float r = __fsub_rn(x, __fmul_rn(two_pi, rintf(__fmul_rn(x, inv_two_pi))));
  float r2 = __fmul_rn(r, r);
  float q = __fmul_rn(r2, -2.0534080101e-08f);
  q = __fmul_rn(r2, __fadd_rn(2.7040473315e-06f, q));
  q = __fmul_rn(r2, __fadd_rn(-1.9812572238e-04f, q));
  q = __fmul_rn(r2, __fadd_rn(8.3325579984e-03f, q));
  q = __fmul_rn(r2, __fadd_rn(-1.6666577198e-01f, q));
  return __fmul_rn(r, __fadd_rn(9.9999970696e-01f, q));
}

// Issue the cp.async copies of weight rows [kt*KT, kt*KT+KT) into a stage.
template <int N, typename WT>
__device__ __forceinline__ void stage_tile(const WT* __restrict__ wg, WT* dst,
                                           int kt) {
  constexpr int TILE = KT * N;
  constexpr int VEC = 16 / sizeof(WT);
  constexpr int COPIES = TILE / VEC / THREADS;
  static_assert(COPIES * VEC * THREADS == TILE, "tile must split evenly");
  const WT* src = wg + static_cast<size_t>(kt) * TILE;
#pragma unroll
  for (int c = 0; c < COPIES; ++c) {
    int e = (c * THREADS + threadIdx.x) * VEC;
    cp_async16(dst + e, src + e);
  }
  cp_async_commit();
}

// acc[i][j] += sum_k in[k][ty*8+i] * W[k][col(j)] over K rows, where
// col(j) = (j/4)*128 + tx*4 + j%4. `in_s` is feature-major (stride LDA).
// Starts and ends with every thread past a barrier, so the caller may write
// any buffer the previous layer read.
template <int K, int NQ, typename WT>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][4 * NQ],
                                         const float* in_s,
                                         const WT* __restrict__ wg, WT* wst) {
  constexpr int N = 128 * NQ;
  constexpr int TILE = KT * N;
  constexpr int NT = K / KT;
  static_assert(NT * KT == K, "K must be a multiple of KT");
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  stage_tile<N>(wg, wst, 0);
  for (int kt = 0; kt < NT; ++kt) {
    if (kt + 1 < NT) {
      stage_tile<N>(wg, wst + ((kt + 1) & 1) * TILE, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const WT* ws = wst + (kt & 1) * TILE + tx * 4;
    const float* as = in_s + kt * KT * LDA + ty * 8;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      float4 a0 = *reinterpret_cast<const float4*>(as + k * LDA);
      float4 a1 = *reinterpret_cast<const float4*>(as + k * LDA + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[4 * NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) load4(ws + k * N + q * 128, w + 4 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

template <int NQ>
__device__ __forceinline__ void zero(float (&acc)[8][4 * NQ]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = 0.f;
  }
}

// out[col][ty*8+i] = act(acc[i][j] + bias[col]), rounded to bf16 when the
// value is next a matmul input in bf16 mode.
template <int NQ, bool BF16>
__device__ __forceinline__ void epilogue(const float (&acc)[8][4 * NQ],
                                         const float* __restrict__ bias,
                                         bool relu, float* out_s) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4 * NQ; ++j) {
    const int col = (j >> 2) * 128 + tx * 4 + (j & 3);
    const float b = __ldg(bias + col);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = acc[i][j] + b;
      if (relu) x = fmaxf(x, 0.f);
      v[i] = BF16 ? round_bf16(x) : x;
    }
    float* dst = out_s + col * LDA + ty * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Positional encoding of one coordinate, column c of [x, sin(2^j x),
// sin(2^j x + pi/2), ...] (the cos columns as a phase-shifted sine, as the
// TPU kernel builds them).
template <bool FAST>
__device__ __forceinline__ float encode_col(float x, int c) {
  if (c < 3) return x;
  const int j = (c - 3) / 6;
  const float phase = (((c - 3) / 3) & 1) ? HALF_PI : 0.f;
  const float arg = __fadd_rn(__fmul_rn(x, static_cast<float>(1 << j)), phase);
  return FAST ? fast_sin(arg) : sinf(arg);
}

template <bool BF16, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
fused_render_fwd_kernel(const float* __restrict__ o_aff,
                        const float* __restrict__ d_aff,
                        const float* __restrict__ viewdirs,
                        const float* __restrict__ tg,
                        const WT* __restrict__ wmat,
                        const float* __restrict__ vec, int num_rays, int S,
                        int rays_per_cta, int real_p, int real_d,
                        float* __restrict__ rgb_out, float* __restrict__ acc_out,
                        float* __restrict__ depth_out,
                        float* __restrict__ weights_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* act0 = smem + SM_ACT0;
  float* act1 = smem + SM_ACT1;
  float* penc = smem + SM_PENC;
  float* denc = smem + SM_DENC;
  float* t_s = smem + SM_T;
  float* delta_s = smem + SM_DELTA;
  float* sig_s = smem + SM_SIGMA;
  float* rgb_s = smem + SM_RGB;
  WT* wst = reinterpret_cast<WT*>(smem + SM_WST);

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_cta;
  const int ray1 = min(ray0 + rays_per_cta, num_rays);
  if (ray0 >= ray1) return;
  const int pt_end = ray1 * S;

  // compositing carry (thread 0 only): transmittance and the running sums
  // of the ray in progress
  float T = 1.f, sum_r = 0.f, sum_g = 0.f, sum_b = 0.f, sum_a = 0.f, sum_d = 0.f;

  float acc2[8][8];
  float acc1[8][4];

  for (int chunk0 = ray0 * S; chunk0 < pt_end; chunk0 += P) {
    const int nvalid = min(P, pt_end - chunk0);

    // ---- encodings and per-point columns ----
    for (int idx = tid; idx < PP * P; idx += THREADS) {
      const int c = idx / P, p = idx % P;
      float v = 0.f;
      if (p < nvalid && c < real_p) {
        const int g = chunk0 + p;
        const int ray = g / S;
        const int d = c < 3 ? c : (c - 3) % 3;
        const float x = __fadd_rn(o_aff[ray * 3 + d],
                                  __fmul_rn(tg[g], d_aff[ray * 3 + d]));
        v = encode_col<BF16>(x, c);
        if (BF16) v = round_bf16(v);
      }
      penc[c * LDA + p] = v;
    }
    for (int idx = tid; idx < DP * P; idx += THREADS) {
      const int c = idx / P, p = idx % P;
      float v = 0.f;
      if (p < nvalid && c < real_d) {
        const int ray = (chunk0 + p) / S;
        const int d = c < 3 ? c : (c - 3) % 3;
        v = encode_col<false>(viewdirs[ray * 3 + d], c);
        if (BF16) v = round_bf16(v);
      }
      denc[c * LDA + p] = v;
    }
    if (tid < P) {
      const int g = chunk0 + tid;
      float tv = 0.f, dv = 0.f;
      if (tid < nvalid) {
        tv = tg[g];
        dv = (g % S == S - 1) ? 1e10f : __fsub_rn(tg[g + 1], tv);
      }
      t_s[tid] = tv;
      delta_s[tid] = dv;
    }
    __syncthreads();

    // ---- block1 ----
    zero<2>(acc2);
    gemm_acc<PP, 2>(acc2, penc, wmat + OFF_W1, wst);
    epilogue<2, BF16>(acc2, vec + 0 * H, true, act0);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act0, wmat + OFF_W2, wst);
    epilogue<2, BF16>(acc2, vec + 1 * H, true, act1);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act1, wmat + OFF_W3, wst);
    epilogue<2, BF16>(acc2, vec + 2 * H, true, act0);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act0, wmat + OFF_W4, wst);
    epilogue<2, BF16>(acc2, vec + 3 * H, true, act1);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act1, wmat + OFF_W5, wst);
    epilogue<2, BF16>(acc2, vec + 4 * H, true, act0);
    // ---- block2: skip input, then 3 more layers ----
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act0, wmat + OFF_W6H, wst);
    gemm_acc<PP, 2>(acc2, penc, wmat + OFF_W6P, wst);
    epilogue<2, BF16>(acc2, vec + 5 * H, true, act1);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act1, wmat + OFF_W7, wst);
    epilogue<2, BF16>(acc2, vec + 6 * H, true, act0);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act0, wmat + OFF_W8, wst);
    epilogue<2, BF16>(acc2, vec + 7 * H, true, act1);
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act1, wmat + OFF_W9, wst);
    {
      // h9 = relu(acc + b9). The density is a float32 reduction of the
      // UNROUNDED h9 against w10s: each thread sums its 8 columns, the
      // warp's 32 lanes (same 8 points, all 256 columns) reduce by shuffle.
      const int tx = tid & 31, ty = tid >> 5;
      float part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (j >> 2) * 128 + tx * 4 + (j & 3);
        const float b = __ldg(vec + 8 * H + col);
        const float ws = __ldg(vec + OFF_W10S + col);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc2[i][j] = fmaxf(acc2[i][j] + b, 0.f);
          part[i] = fmaf(acc2[i][j], ws, part[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
      }
      if (tx == 0) {
        const float b10s = __ldg(vec + OFF_B10S);
#pragma unroll
        for (int i = 0; i < 8; ++i) sig_s[ty * 8 + i] = fmaxf(part[i] + b10s, 0.f);
      }
      // bias and relu are in; store h9 (rounded in bf16 mode)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (j >> 2) * 128 + tx * 4 + (j & 3);
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = BF16 ? round_bf16(acc2[i][j]) : acc2[i][j];
        float* dst = act0 + col * LDA + ty * 8;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    // feature head: no activation
    zero<2>(acc2);
    gemm_acc<H, 2>(acc2, act0, wmat + OFF_W10F, wst);
    epilogue<2, BF16>(acc2, vec + OFF_B10F, false, act1);
    // ---- rgb head ----
    zero<1>(acc1);
    gemm_acc<H, 1>(acc1, act1, wmat + OFF_WR0F, wst);
    gemm_acc<DP, 1>(acc1, denc, wmat + OFF_WR0D, wst);
    epilogue<1, BF16>(acc1, vec + OFF_BR0, true, act0);
    __syncthreads();
    if (tid < 3 * P) {
      const int c = tid / P, p = tid % P;
      float z = 0.f;
      for (int k = 0; k < HR; ++k)
        z = fmaf(act0[k * LDA + p], load1(wmat + OFF_WR1 + k * 8 + c), z);
      z += __ldg(vec + OFF_BR1 + c);
      rgb_s[c * P + p] = 1.f / (1.f + expf(-z));
    }
    __syncthreads();

    // ---- compositing, in sample order ----
    if (tid == 0) {
      for (int p = 0; p < nvalid; ++p) {
        const int g = chunk0 + p;
        const float one_m = expf(-sig_s[p] * delta_s[p]);
        const float w = T * (1.f - one_m);
        weights_out[g] = w;
        sum_r = fmaf(w, rgb_s[p], sum_r);
        sum_g = fmaf(w, rgb_s[P + p], sum_g);
        sum_b = fmaf(w, rgb_s[2 * P + p], sum_b);
        sum_a += w;
        sum_d = fmaf(w, t_s[p], sum_d);
        T *= one_m;
        if (g % S == S - 1) {
          const int ray = g / S;
          rgb_out[ray * 3 + 0] = sum_r;
          rgb_out[ray * 3 + 1] = sum_g;
          rgb_out[ray * 3 + 2] = sum_b;
          acc_out[ray] = sum_a;
          depth_out[ray] = sum_d;
          T = 1.f;
          sum_r = sum_g = sum_b = sum_a = sum_d = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

template <bool BF16, typename WT>
int launch(const float* o_aff, const float* d_aff, const float* viewdirs,
           const float* t, const void* wmat, const float* vec, int num_rays,
           int S, int rays_per_cta, int real_p, int real_d, float* rgb,
           float* acc, float* depth, float* weights, cudaStream_t stream) {
  auto kernel = fused_render_fwd_kernel<BF16, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (num_rays + rays_per_cta - 1) / rays_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      o_aff, d_aff, viewdirs, t, static_cast<const WT*>(wmat), vec, num_rays, S,
      rays_per_cta, real_p, real_d, rgb, acc, depth, weights);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_render_fwd(const float* o_aff, const float* d_aff,
                     const float* viewdirs, const float* t, const void* wmat,
                     const float* vec, int n_w, int n_b, int bf16,
                     int num_rays, int S, int rays_per_cta, int real_p,
                     int real_d, float* rgb, float* acc, float* depth,
                     float* weights, void* stream) {
  if (n_w != N_W || n_b != N_B || num_rays <= 0 || S <= 0 ||
      rays_per_cta <= 0 || real_p > PP || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, __nv_bfloat16>(o_aff, d_aff, viewdirs, t, wmat, vec,
                                       num_rays, S, rays_per_cta, real_p,
                                       real_d, rgb, acc, depth, weights, s);
  return launch<false, float>(o_aff, d_aff, viewdirs, t, wmat, vec, num_rays, S,
                              rays_per_cta, real_p, real_d, rgb, acc, depth,
                              weights, s);
}

const char* fused_render_fwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
