// SIREN field forward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_siren.py::_fwd_kernel (the forward of
// make_fused_siren_apply's apply: the occupancy bake of a served or trained
// SIREN, a SIREN distillation teacher or student) in bfloat16 mode. Same
// function as fused_siren_fwd.cu, which keeps the float32 mode: the raw
// points rounded to bf16 (as _mm rounds pts8) through h_l = sin(w0_l (h_{l-1}
// W_l + b_l)), l = 1..8 (w0 30, then 1; the degree-11 fast_sin), the density
// relu(h8 . ws + bs) * sigma_mul in float32 from the unrounded h8, the
// remap, and the sine rgb head on [feat, denc] with denc the frequency
// encoding of the direction through the EXACT sine; rgb (N, 3) and sigma
// (N,) out.
//
// What bounds it on this card: operations. A point costs 561,920 MACs at
// hidden 256 (0.075 ms at 65,536 points, one chunk of the occupancy bake,
// on the tensor cores' 989 TFLOP/s in bf16) and 2,200 sines (about 15
// CUDA-core instructions each), against 24 bytes in and 16 out. The kernel
// it replaced in bf16 (fused_siren_fwd.cu, every product an fp32 FMA on the
// CUDA cores) took 2.104 / 0.526 ms at 65,536 / 16,384 points on an NVIDIA
// H100 80GB HBM3 at 700 W, 0.035 of the bound.
//
// Design: row 6's chain with no compositing
// (fused_render_siren_tc_common.cuh::forward_chain_siren_tc, the SIREN
// forward render's and train pass's) behind the point loader
// (load_point_chunk_tc): a CTA of 256 threads a 64-point chunk, two CTAs
// an SM, so that one CTA's sine epilogues overlap the other's products;
// the last chunk is ragged and its missing points get zero inputs. Layer 1 (K = 3)
// runs on the CUDA cores straight into the accumulator layout; every other
// product is render_tc.cuh's gemm_fwd (mma.sync m16n8k16, bf16 operands,
// float32 sums), each sine in its epilogue, and the near ties of hidden
// layers 2..8 are recomputed in the plain version's sequential k order, so
// that every activation rounds to the plain version's bf16 (the chain's
// header says why). The chunk's sigma and rgb leave shared memory in point
// order.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_siren_tc_common.cuh"

namespace siren {
namespace {

__global__ void __launch_bounds__(THREADS, 2)
siren_field_fwd_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                          const float* __restrict__ vec, const bf16* __restrict__ wmat, Siren sp,
                          int n, int real_d, float* __restrict__ rgb_out,
                          float* __restrict__ sigma_out) {
  extern __shared__ float4 smem4[];
  const TcSmem sm = carve_smem(reinterpret_cast<unsigned char*>(smem4));
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TC_P;
  const int nvalid = min(TC_P, n - p0);
  const TcStash none{};
  forward_chain_siren_tc<false>(
      [&] { load_point_chunk_tc(pts, dirs, p0, nvalid, real_d, sm); }, vec, sp, wmat, sm, none,
      0, 0);
  if (tid < nvalid) sigma_out[p0 + tid] = sm.col[SC_SIGMA * TC_P + tid];
  if (tid < 3 * nvalid)
    rgb_out[static_cast<size_t>(p0) * 3 + tid] = sm.col[(SC_RGB + tid % 3) * TC_P + tid / 3];
}

int launch_field_fwd_tc(const float* pts, const float* dirs, const void* wmat, const float* vec,
                        int n_w, int n_b, int is_bf16, int n, int real_d, float w0, float w0h,
                        float sigma_mul, float rgb_mul, float* rgb, float* sigma, void* stream) {
  if (n_w != N_W || n_b != N_B || is_bf16 != 1 || n <= 0 || real_d < 3 || real_d > DP)
    return -1;
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      siren_field_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SB_END);
  if (err != cudaSuccess) return static_cast<int>(err);
  siren_field_fwd_tc_kernel<<<(n + TC_P - 1) / TC_P, THREADS, SB_END, s>>>(
      pts, dirs, vec, static_cast<const bf16*>(wmat), sp, n, real_d, rgb, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace siren

extern "C" {

// The bf16 field forward: rgb (n, 3) and sigma (n,) of the points (n, 3)
// and directions (n, 3); `wmat` the packed bf16 matrices, `vec` the float32
// vectors. The arguments are those of siren_field_fwd; `bf16` must be 1.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int siren_field_fwd_tc(const float* pts, const float* dirs, const void* wmat, const float* vec,
                       int n_w, int n_b, int bf16, int n, int real_d, float w0, float w0h,
                       float sigma_mul, float rgb_mul, float* rgb, float* sigma, void* stream) {
  return siren::launch_field_fwd_tc(pts, dirs, wmat, vec, n_w, n_b, bf16, n, real_d, w0, w0h,
                                    sigma_mul, rgb_mul, rgb, sigma, stream);
}

const char* siren_field_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
