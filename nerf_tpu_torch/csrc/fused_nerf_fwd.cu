// NeRF field forward for Hopper (sm_90a) in float32: positional and
// direction encoding and the 11-matmul NeRF MLP of given points, in one
// kernel.
//
// Replaces: nerf_tpu/ops/pallas/fused_nerf.py::_fwd_kernel (the forward of
// make_fused_nerf_apply's apply: the occupancy bake of a served NeRF, a
// NeRF distillation teacher and student) in float32 mode; bfloat16 runs on
// the tensor cores (fused_nerf_fwd_tc.cu). Same function (_forward_tile):
// for every point, PE(p) with L_pos frequencies and PE(dir) with L_dir
// (x @ E + mask * sin(x @ S + phase): the coordinates, then sin(2^j x) and
// the cos columns as sin(2^j x + pi/2)), the MLP of _mlp_tile, rgb through
// a sigmoid and sigma through a ReLU. The TPU packs them into an (N, 8) row;
// here rgb (N, 3) and sigma (N,) leave the kernel, and the encodings and the
// (points x 256) activations never do. The sine is sinf and the sums are
// true float32.
//
// What bounds it on this card: operations. A point costs 658,944 MACs at
// hidden 256 (and 84 sines), against 24 bytes in and 16 out, so 65,536
// points (one chunk of the occupancy bake) are 86 GFLOP against 2.6 MB, on
// the CUDA cores' 67 TFLOP/s in float32.
//
// Design: one CTA of 256 threads per 64-point chunk (the render kernels'
// chunk P); the last chunk is ragged and its missing points get zero
// encodings. The chunk's encodings go straight into shared memory; the MLP
// is the render kernels' own chain (fused_render_common.cuh::mlp_chunk:
// activations feature-major in two shared buffers, weights streamed from L2
// through a double-buffered cp.async stage, an 8 x 8 register tile a
// thread, the density a float32 warp reduction of h9); the
// chunk's rgb and sigma are then written out. Built by
// nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library with a
// plain C interface (loaded by ctypes).

#include "fused_render_common.cuh"

namespace {

using namespace nerf;

__global__ void __launch_bounds__(THREADS, 1)
fused_nerf_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                      const float* __restrict__ vec, const float* __restrict__ wmat,
                      int n, int real_p, int real_d, float* __restrict__ rgb_out,
                      float* __restrict__ sigma_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* sig_s = smem + SM_SIGMA;
  const float* rgb_s = smem + SM_RGB;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P;
  const int nvalid = min(P, n - p0);
  const Stash none{};

  encode_point_chunk<false>(pts, dirs, p0, nvalid, real_p, real_d, smem);
  mlp_chunk<false, false>(vec, wmat, smem, none, 0);
  if (tid < nvalid) sigma_out[p0 + tid] = sig_s[tid];
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    if (p < nvalid) rgb_out[static_cast<size_t>(p0 + p) * 3 + c] = rgb_s[c * P + p];
  }
}

}  // namespace

extern "C" {

// rgb (n, 3) and sigma (n,) of the points (n, 3) and directions (n, 3);
// `bf16` must be 0 (fused_nerf_fwd_tc takes bfloat16). Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 when the packed
// buffers or the shapes do not fit this kernel.
int fused_nerf_fwd(const float* pts, const float* dirs, const void* wmat,
                   const float* vec, int n_w, int n_b, int bf16, int n, int real_p,
                   int real_d, float* rgb, float* sigma, void* stream) {
  if (n_w != N_W || n_b != N_B || bf16 != 0 || n <= 0 || real_p < 3 || real_p > PP ||
      real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_nerf_fwd_kernel<<<(n + P - 1) / P, THREADS, SMEM_BYTES, s>>>(
      pts, dirs, vec, static_cast<const float*>(wmat), n, real_p, real_d, rgb, sigma);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_nerf_fwd_error(int code) {
  if (code == -1) return "packed weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
