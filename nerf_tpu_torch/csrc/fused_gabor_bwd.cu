// GaborNet field backward for Hopper (sm_90a): the vector-Jacobian product
// of fused_gabor_fwd.cu's function, in one kernel and an in-order sum.
//
// Replaces: nerf_tpu/ops/pallas/fused_gabor.py::_bwd_kernel (the custom
// VJP of make_fused_gabor_apply's apply: a GaborNet distillation student's
// gradient). Same function: from the cotangent of (rgb, sigma) of every
// point, the 23 float32 weight and bias gradients of the packed layout
// (fused_render_gabor_common.cuh), the gradients of every filter bank (in
// the F_* layout: d omega = x^T dsinarg, d phi = sum dsinarg, d mu^T =
// x^T (-2 dq), d |mu|^2 = sum dq, d gamma = sum da (-q/2), with dsinarg =
// (dg cos(sinarg)) E, da = (dg sin(sinarg)) E, dq = da (-gamma/2), dg the
// filter value's cotangent; autograd carries d |mu|^2 on to mu), the point
// cotangent sum_i dsinarg_i omega_i^T + 2 x sum(dq_i) - 2 dq_i mu_i (the
// expansion's terms) and the direction cotangent, _encode_bwd of dzr0
// wr0d^T with the exact cosine. In bfloat16 mode both operands of the
// x^T products are rounded to bf16, and of the point cotangent's products
// only dsinarg and dq (the banks stay float32), as mmT_acc and dact round
// them.
//
// What bounds it on this card: operations. A point costs about three times
// the forward's 573,440 MACs (the recomputed forward, the dz W^T products
// with the input product dzr0 wr0d^T, the A^T dz gradient products, and
// the filters' products) and 8,192 transcendentals (the forward's sine and
// exponential a filter element, the backward's again with the cosine),
// against 40 bytes in and 24 out a point plus the weights and their float32
// gradients. float32 runs on the CUDA cores (67 TFLOP/s); bfloat16's bound
// is the tensor cores' 989 TFLOP/s, which this first version, on the CUDA
// cores too, stays far from.
//
// Design (that of fused_render_gabor_train.cu, without the compositing,
// with the filters evaluated from the points):
//   1. A CTA owns a run of points (the wrapper gives about one run an SM, a
//      multiple of the 64-point chunk) and runs their forward chunk by chunk
//      (load_point_chunk + mlp_chunk with PointFilters), stashing per point
//      in its scratch area in device memory each stage's z and u, feat, y,
//      denc, sigma_pre and rgb (~21 KB a point with the two filter buffers
//      below).
//   2. One thread a point: the sigmoid's and the density ReLU's backward
//      from the given cotangent into the per-point columns.
//   3. The network backward over all the CTA's points, the train kernel's
//      own (fused_render_gabor_common.cuh::net_backward); once dzr0 is
//      complete, one thread a (point, coordinate) takes the direction
//      cotangent. Each stage's filter pass is two passes over the CTA's
//      points in order:
//      a. one thread a column: the filter again from the point (bit for bit
//         the forward's), dg and du in place, dsinarg and dq into two
//         scratch buffers, and the column's five bank gradients summed over
//         the points, masked to the CTA's real points (a padded point's
//         filter is not zero at x = 0, so masking, not the values, keeps it
//         out);
//      b. one warp a point: the three point-cotangent sums over the 256
//         columns (a fixed shuffle tree), added to the point's column.
//   4. A second small kernel adds the per-CTA partials in CTA order.
//      Nothing is atomic, so a step is deterministic from run to run.
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_render_gabor_common.cuh"

namespace {

using namespace gabor;

constexpr int N_GRAD = N_TOT + N_F;              // the MLP's, then the banks'
constexpr int NPART = (N_GRAD + 1 + 3) / 4 * 4;  // per-CTA: gradients, a zero
constexpr int FLOATS_PER_POINT = floats_per_point<4>();

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? round_bf16(x) : x;
}

// A point's coordinates, rounded to the compute dtype, and |x|^2 of the
// unrounded ones, as load_point_chunk computes them.
template <bool BF16>
__device__ __forceinline__ void point_at(const float* __restrict__ pts, size_t i,
                                         float (&x)[3], float (&xr)[3], float& xx) {
  for (int c = 0; c < 3; ++c) {
    x[c] = pts[i * 3 + c];
    xr[c] = rnd<BF16>(x[c]);
  }
  xx = __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                 __fmul_rn(x[2], x[2]));
}

template <bool BF16, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
gabor_field_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ cot, const float* __restrict__ vec,
                       const WT* __restrict__ wmat, const WT* __restrict__ wmat_t,
                       const float* __restrict__ fpack, float sigma_mul,
                       float rgb_mul, int n, int pts_per_cta, int cap, int real_d,
                       float* __restrict__ scratch, float* __restrict__ partial,
                       float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p_begin = blockIdx.x * pts_per_cta;
  const int p_end = min(p_begin + pts_per_cta, n);
  if (p_begin >= p_end) return;
  const int npts = p_end - p_begin;
  const int cap_c = (npts + P - 1) / P * P;
  const size_t cz = static_cast<size_t>(cap);
  Scratch sc = carve<4>(scratch + static_cast<size_t>(blockIdx.x) * cz * FLOATS_PER_POINT, cap);
  float* part = partial + static_cast<size_t>(blockIdx.x) * NPART;
  float* cols = sc.cols;
  float* dsinarg_s = sc.dz[2];
  float* dq_s = sc.dz[3];

  // ---- 1. forward, stashing what the backward needs ----
  for (int c0 = 0; c0 < npts; c0 += P) {
    const int nvalid = min(P, npts - c0);
    load_point_chunk<BF16>(pts, dirs, p_begin + c0, nvalid, real_d, smem);
    const PointFilters<BF16> filt{fpack, smem + SM_X, nvalid};
    mlp_chunk<BF16, true>(vec, wmat, sigma_mul, rgb_mul, filt, smem, sc.st,
                          static_cast<size_t>(c0));
  }

  // ---- 2. the heads' backward: dzr1 = ((g_rgb r) (1 - r)) rgb_mul, dsig =
  //      g_sigma sigma_mul where sigma_pre > 0; zero past the CTA's points;
  //      the point cotangents start at zero ----
  for (int l = tid; l < cap_c; l += THREADS) {
    float dz[3] = {0.f, 0.f, 0.f};
    float ds = 0.f;
    if (l < npts) {
      const float* g = cot + static_cast<size_t>(p_begin + l) * 4;
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
  if (tid == 0) part[N_GRAD] = 0.f;
  __syncthreads();

  // ---- 3. network backward; the direction cotangent from dzr0, the filter
  //      banks' gradients and the point cotangent stage by stage ----
  auto direction = [&](const float* dzr0) {
    direction_cotangent<BF16>(dzr0, wmat + OFF_WR0D, dirs, p_begin, npts, real_d, ddirs);
  };
  auto filters = [&](int stage, float* dz, const float* u) {
    const float* fs = fpack + stage * F_STRIDE;
    float* pf = part + N_TOT + stage * F_STRIDE;
    // a. thread = column: bank gradients over the CTA's points
    {
      const int c = tid;
      const float mhalf_gam = __fmul_rn(-0.5f, __ldg(fs + F_GAM + c));
      float s_om[3] = {0.f, 0.f, 0.f}, s_mu[3] = {0.f, 0.f, 0.f};
      float s_ph = 0.f, s_m2 = 0.f, s_gam = 0.f;
      for (int l = 0; l < npts; ++l) {
        float x[3], xr[3], xx;
        point_at<BF16>(pts, static_cast<size_t>(p_begin + l), x, xr, xx);
        const PointFilter f = point_filter_at<BF16>(fs, c, xr[0], xr[1], xr[2], xx);
        const size_t at = static_cast<size_t>(l) * LDZ + c;
        const float d = dz[at];
        float dg = d;
        if (u != nullptr) {
          dg = __fmul_rn(d, u[static_cast<size_t>(l) * H + c]);
          dz[at] = __fmul_rn(d, __fmul_rn(f.sn, f.E));
        }
        const float dsa = __fmul_rn(__fmul_rn(dg, cosine<BF16>(f.sinarg)), f.E);
        const float da = __fmul_rn(__fmul_rn(dg, f.sn), f.E);
        const float dq = __fmul_rn(da, mhalf_gam);
        dsinarg_s[at] = dsa;
        dq_s[at] = dq;
        const float rs = rnd<BF16>(dsa), rq = rnd<BF16>(__fmul_rn(-2.f, dq));
        for (int k = 0; k < 3; ++k) {
          s_om[k] = fmaf(xr[k], rs, s_om[k]);
          s_mu[k] = fmaf(xr[k], rq, s_mu[k]);
        }
        s_ph = __fadd_rn(s_ph, dsa);
        s_m2 = __fadd_rn(s_m2, dq);
        s_gam = fmaf(da, __fmul_rn(-0.5f, f.q), s_gam);
      }
      for (int k = 0; k < 3; ++k) {
        pf[F_OM + k * H + c] = s_om[k];
        pf[F_MU + k * H + c] = s_mu[k];
      }
      pf[F_PH + c] = s_ph;
      pf[F_M2 + c] = s_m2;
      pf[F_GAM + c] = s_gam;
    }
    __syncthreads();
    // b. warp = point: dx += dsinarg omega^T + 2 x sum(dq) - 2 dq mu
    for (int l = warp; l < npts; l += THREADS / 32) {
      const float* rs = dsinarg_s + static_cast<size_t>(l) * LDZ;
      const float* rq = dq_s + static_cast<size_t>(l) * LDZ;
      float a[3] = {0.f, 0.f, 0.f}, m[3] = {0.f, 0.f, 0.f}, sq = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float vs = rnd<BF16>(rs[c]), q = rq[c], vq = rnd<BF16>(q);
        for (int k = 0; k < 3; ++k) {
          a[k] = fmaf(vs, __ldg(fs + F_OM + k * H + c), a[k]);
          m[k] = fmaf(vq, __ldg(fs + F_MU + k * H + c), m[k]);
        }
        sq += q;
      }
      for (int off = 16; off > 0; off >>= 1) {
        for (int k = 0; k < 3; ++k) {
          a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
          m[k] += __shfl_xor_sync(0xffffffffu, m[k], off);
        }
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (lane == 0) {
        const float* x = pts + static_cast<size_t>(p_begin + l) * 3;
        for (int k = 0; k < 3; ++k) {
          float* dp = cols + (C_DP + k) * cz + l;
          *dp = ((*dp + a[k]) + (2.f * x[k]) * sq) - 2.f * m[k];
        }
      }
    }
    __syncthreads();
  };
  net_backward<BF16>(sc, cz, vec, wmat, wmat_t, part, cap_c, smem, direction, filters);

  // ---- 4. the point cotangents ----
  for (int idx = tid; idx < npts * 3; idx += THREADS) {
    const int l = idx / 3, k = idx % 3;
    dpts[static_cast<size_t>(p_begin + l) * 3 + k] = cols[(C_DP + k) * cz + l];
  }
}

template <bool BF16, typename WT>
int launch(const float* pts, const float* dirs, const float* cot, const float* vec,
           const void* wmat, const void* wmat_t, const float* fpack, float sigma_mul,
           float rgb_mul, int n, int pts_per_cta, int cap, int real_d, float* scratch,
           float* partial, float* out, float* dpts, float* ddirs,
           cudaStream_t stream) {
  auto kernel = gabor_field_bwd_kernel<BF16, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + pts_per_cta - 1) / pts_per_cta;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      pts, dirs, cot, vec, static_cast<const WT*>(wmat), static_cast<const WT*>(wmat_t),
      fpack, sigma_mul, rgb_mul, n, pts_per_cta, cap, real_d, scratch, partial, dpts,
      ddirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<N_GRAD, NPART><<<(N_GRAD + 1 + 255) / 256, 256, 0, stream>>>(
      partial, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sizes the caller allocates: scratch floats per stashed point, floats per
// CTA partial, floats of the output (the MLP's gradients, the banks', then
// a zero).
void gabor_field_bwd_sizes(int* per_point, int* npart, int* n_out) {
  *per_point = FLOATS_PER_POINT;
  *npart = NPART;
  *n_out = N_GRAD + 1;
}

// `cot` is the (n, 4) cotangent [g_rgb, g_sigma]; `wmat_t` the packed
// matrices transposed (same offsets); `fpack` the filter banks (N_F
// floats). `scratch` holds grid * cap * per_point floats, `partial` grid *
// npart, `out` n_out, where grid = ceil(n / pts_per_cta) and cap >=
// ceil(pts_per_cta / 64) * 64 is a multiple of 64. Writes the gradients to
// `out` and the point and direction cotangents (n, 3) each. Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 when the packed
// buffers or the shapes do not fit this kernel.
int gabor_field_bwd(const float* pts, const float* dirs, const float* cot,
                    const void* wmat, const void* wmat_t, const float* vec,
                    const float* fpack, int n_w, int n_b, int n_f, int bf16, int n,
                    int pts_per_cta, int cap, int real_d, float sigma_mul,
                    float rgb_mul, float* scratch, float* partial, float* out,
                    float* dpts, float* ddirs, void* stream) {
  if (n_w != N_W || n_b != N_B || n_f != N_F || n <= 0 || pts_per_cta <= 0 ||
      cap % P != 0 || cap < (pts_per_cta + P - 1) / P * P || real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, __nv_bfloat16>(pts, dirs, cot, vec, wmat, wmat_t, fpack,
                                       sigma_mul, rgb_mul, n, pts_per_cta, cap, real_d,
                                       scratch, partial, out, dpts, ddirs, s);
  return launch<false, float>(pts, dirs, cot, vec, wmat, wmat_t, fpack, sigma_mul,
                              rgb_mul, n, pts_per_cta, cap, real_d, scratch, partial,
                              out, dpts, ddirs, s);
}

const char* gabor_field_bwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
