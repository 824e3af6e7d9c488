// SIREN field forward for Hopper (sm_90a): the 8-layer sine MLP of given
// points and directions, in one kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_siren.py::_fwd_kernel (the forward of
// make_fused_siren_apply's apply: the occupancy bake of a served SIREN, a
// SIREN distillation teacher and student). Same function (_forward_tile):
// the raw points (rounded to bf16 in bfloat16 mode, as _mm rounds pts8)
// through h_l = sin(w0_l (h_{l-1} W_l + b_l)), l = 1..8 (w0 30, then 1),
// the density relu(h8 . ws + bs) * sigma_mul in float32 from the unrounded
// h8, the remap, and the sine rgb head on [feat, denc] with denc the
// frequency encoding of the direction through the EXACT sine (the layers
// take the degree-11 fast_sin in bfloat16 mode, sinf in float32). The TPU
// packs rgb and sigma into an (N, 8) row; here rgb (N, 3) and sigma (N,)
// leave the kernel, and the (points x 256) activations never do.
//
// What bounds it on this card: operations. A point costs 561,920 MACs at
// hidden 256 and 2,176 sines, against 24 bytes in and 16 out, so 65,536
// points (one chunk of the occupancy bake) are 74 GFLOP against 2.6 MB.
// float32 runs on the CUDA cores (67 TFLOP/s); bfloat16's bound is the
// tensor cores' 989 TFLOP/s, which this first version, on the CUDA cores
// too, stays far from.
//
// Design: one CTA of 256 threads per 64-point chunk (the render kernels'
// chunk P); the last chunk is ragged and its missing points get zero
// inputs. load_point_chunk puts the chunk's points and direction encoding
// in shared memory, and the chain is the SIREN render kernels' own
// (fused_render_siren_common.cuh::mlp_chunk: activations feature-major in
// two shared buffers, weights streamed from L2 through a double-buffered
// cp.async stage, an 8 x 8 register tile a thread, each layer's sine in the
// gemm's epilogue, the density a float32 warp reduction); the chunk's rgb
// and sigma are then written out. Built by nerf_tpu_torch/ops/cuda/build.py
// with nvcc into a shared library with a plain C interface (loaded by
// ctypes).

#include "fused_render_siren_common.cuh"

namespace {

using namespace siren;

template <bool BF16, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
siren_field_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const float* __restrict__ vec, const WT* __restrict__ wmat,
                       Siren sp, int n, int real_d, float* __restrict__ rgb_out,
                       float* __restrict__ sigma_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* sig_s = smem + SM_SIGMA;
  const float* rgb_s = smem + SM_RGB;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const int nvalid = min(P, n - p0);
  const Stash none{};

  load_point_chunk<BF16>(pts, dirs, p0, nvalid, real_d, smem);
  mlp_chunk<BF16, false>(vec, wmat, sp, smem, none, 0);
  if (tid < nvalid) sigma_out[p0 + tid] = sig_s[tid];
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    if (p < nvalid) rgb_out[static_cast<size_t>(p0 + p) * 3 + c] = rgb_s[c * P + p];
  }
}

template <bool BF16, typename WT>
int launch(const float* pts, const float* dirs, const float* vec, const void* wmat,
           const Siren& sp, int n, int real_d, float* rgb, float* sigma,
           cudaStream_t stream) {
  auto kernel = siren_field_fwd_kernel<BF16, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + P - 1) / P, THREADS, SMEM_BYTES, stream>>>(
      pts, dirs, vec, static_cast<const WT*>(wmat), sp, n, real_d, rgb, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rgb (n, 3) and sigma (n,) of the points (n, 3) and directions (n, 3).
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int siren_field_fwd(const float* pts, const float* dirs, const void* wmat,
                    const float* vec, int n_w, int n_b, int bf16, int n, int real_d,
                    float w0, float w0h, float sigma_mul, float rgb_mul, float* rgb,
                    float* sigma, void* stream) {
  if (n_w != N_W || n_b != N_B || n <= 0 || real_d < 3 || real_d > DP) return -1;
  const Siren sp{w0, w0h, sigma_mul, rgb_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, __nv_bfloat16>(pts, dirs, vec, wmat, sp, n, real_d, rgb, sigma,
                                       s);
  return launch<false, float>(pts, dirs, vec, wmat, sp, n, real_d, rgb, sigma, s);
}

const char* siren_field_fwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
