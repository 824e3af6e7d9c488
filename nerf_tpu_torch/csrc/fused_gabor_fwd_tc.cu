// GaborNet field forward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_gabor.py::_fwd_kernel (the forward of
// make_fused_gabor_apply's apply: the occupancy bake of a served or trained
// GaborNet, a GaborNet distillation teacher or student) in bfloat16 mode.
// Same function as fused_gabor_fwd.cu, which keeps the float32 mode: for
// every point x and stage i the filters
//   g_i = sin(x . omega_i + phi_i) * exp(-gamma_i/2 (|x|^2 - 2 x . mu_i + |mu_i|^2))
// (_filters_from_points: x rounded to bf16 as _mm rounds pts8, |x|^2 from
// the unrounded point, the banks float32), the multiplicative filter network
// and its heads, rgb (N, 3) and sigma (N,) out.
//
// What bounds it on this card: operations. A point costs 573,440 MACs (the
// render's 561,152 and the filters' two 3-long products a filter element:
// 0.076 ms at 65,536 points on the tensor cores' 989 TFLOP/s in bf16) and
// 4,096 transcendentals (a sine and an exponential a filter element, with
// the filter's own arithmetic about 40 CUDA-core instructions: longer than
// the products at the CUDA cores' instruction rate), against 40 bytes of
// the point in and out. The kernel it replaced in bf16 (fused_gabor_fwd.cu,
// every product an fp32 FMA on the CUDA cores) took 2.901 / 0.728 ms at
// 65,536 / 16,384 points on an NVIDIA H100 80GB HBM3 at 700 W, 0.026 of the
// bound.
//
// Design: row 11's chain with no compositing
// (fused_render_gabor_tc_common.cuh::network_tc, the GaborNet forward
// render's and train pass's): a CTA of 256 threads a 64-point chunk, two
// CTAs an SM, so that one CTA's filter epilogues overlap the other's
// products; the last chunk is ragged and its missing points get zero
// filters. Each product is render_tc.cuh's gemm_fwd (mma.sync m16n8k16,
// bf16 operands, float32 sums); its epilogue evaluates the point filter of
// each accumulator element in registers (PointFilterTc: the nine bank values
// of a column pair loaded once, then point_filter_at<true>'s operations on
// each of the thread's 8 rows). The chunk's rounded points and |x|^2 sit in
// shared-memory columns.
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

__global__ void __launch_bounds__(THREADS, 2)
gabor_field_fwd_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                          const float* __restrict__ vec, const bf16* __restrict__ wmat,
                          const float* __restrict__ fpack, float sigma_mul, float rgb_mul, int n,
                          int real_d, float* __restrict__ rgb_out,
                          float* __restrict__ sigma_out) {
  extern __shared__ float4 smem4[];
  const GSmem sm = carve_gsmem(reinterpret_cast<unsigned char*>(smem4));
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TC_P;
  const int nvalid = min(TC_P, n - p0);
  const TcStash none{};
  load_point_chunk_tc(pts, dirs, p0, nvalid, real_d, sm);
  network_tc<false>(vec, wmat, sigma_mul, rgb_mul, sm, none, 0, 0,
                    [&](float (&acc)[MT_F][4][4], int nb, int stage, bool first, bool last,
                        const float* bias, const float* ws, bf16* out, float (&sp)[MT_F][2]) {
                      PointFilterTc f{fpack + stage * F_STRIDE, sm, nvalid};
                      stage_epilogue_tc<false>(acc, nb, f, first, last, bias, ws, out, sp,
                                               nullptr, nullptr, 0);
                    });
  if (tid < nvalid) sigma_out[p0 + tid] = sm.col[GC_SIGMA * TC_P + tid];
  if (tid < 3 * TC_P) {
    const int c = tid / TC_P, p = tid % TC_P;
    if (p < nvalid)
      rgb_out[static_cast<size_t>(p0 + p) * 3 + c] = sm.col[(GC_RGB + c) * TC_P + p];
  }
}

int launch_field_fwd_tc(const float* pts, const float* dirs, const void* wmat, const float* vec,
                        const float* fpack, int n_w, int n_b, int n_f, int n, int real_d,
                        float sigma_mul, float rgb_mul, float* rgb, float* sigma,
                        void* stream) {
  if (n_w != N_W || n_b != N_B || n_f != N_F || n <= 0 || real_d < 3 || real_d > DP) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      gabor_field_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_GABOR_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  gabor_field_fwd_tc_kernel<<<(n + TC_P - 1) / TC_P, THREADS, SMEM_GABOR_TC, s>>>(
      pts, dirs, vec, static_cast<const bf16*>(wmat), fpack, sigma_mul, rgb_mul, n, real_d, rgb,
      sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gabor

extern "C" {

// The bf16 field forward: rgb (n, 3) and sigma (n,) of the points (n, 3)
// and directions (n, 3); `wmat` the packed bf16 matrices, `vec` the float32
// vectors, `fpack` the float32 filter banks (N_F floats, F_* layout). The
// arguments are those of gabor_field_fwd. Returns 0 on success, a
// cudaError_t code after a failed launch, or -1 when the packed buffers or
// the shapes do not fit this kernel.
int gabor_field_fwd_tc(const float* pts, const float* dirs, const void* wmat, const float* vec,
                       const float* fpack, int n_w, int n_b, int n_f, int n, int real_d,
                       float sigma_mul, float rgb_mul, float* rgb, float* sigma, void* stream) {
  return gabor::launch_field_fwd_tc(pts, dirs, wmat, vec, fpack, n_w, n_b, n_f, n, real_d,
                                    sigma_mul, rgb_mul, rgb, sigma, stream);
}

const char* gabor_field_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
