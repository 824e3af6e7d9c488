// NeRF field forward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_nerf.py::_fwd_kernel (the forward of
// make_fused_nerf_apply's apply: the occupancy bake of a served or trained
// NeRF, a NeRF distillation teacher and student) in bfloat16 mode. Same
// function as fused_nerf_fwd.cu, which keeps the float32 mode: for every
// point, PE(p) with L_pos frequencies and PE(dir) with L_dir (both through
// the degree-11 fast_sin, rounded to bf16), the MLP of _mlp_tile, rgb
// through a sigmoid and sigma through a ReLU; rgb (N, 3) and sigma (N,) out.
//
// What bounds it on this card: operations. A point costs 658,944 MACs at
// hidden 256 (0.087 ms at 65,536 points, one chunk of the occupancy bake, on
// the tensor cores' 989 TFLOP/s in bf16) and 84 sines, against 24 bytes in
// and 16 out. The kernel it replaced in bf16 (fused_nerf_fwd.cu, every
// product an fp32 FMA on the CUDA cores) took 2.663 / 0.670 ms at 65,536 /
// 16,384 points on an NVIDIA H100 80GB HBM3 at 700 W, 0.033 of the bound.
//
// Design: row 3's chain with no compositing
// (fused_render_tc_common.cuh::forward_chain_tc, the NeRF forward render's
// and train pass's) behind the point loader (encode_point_chunk_tc): a CTA
// of 256 threads a 64-point chunk, two CTAs an SM, so that one CTA's
// encodings and epilogues overlap the other's products; the last chunk is
// ragged and its missing points get zero encodings. Each product is render_tc.cuh's
// gemm_fwd (mma.sync m16n8k16, bf16 operands, float32 sums) against the
// weights streamed from L2 through a ring of cp.async stages, with the
// render's rounding points: every activation rounded to bf16, h9 unrounded
// for the density (a float32 reduction against w10s) and rounded for the
// feature product. The chunk's sigma and rgb leave shared memory in point
// order.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).

#include "fused_render_tc_common.cuh"

namespace {

using namespace nerf;

// Shared memory (bytes): the chain's forward plan, then the chunk's
// per-point columns (COL_*; t and delta unused here).
constexpr int FB_COL = FB_END;
constexpr int SMEM_FIELD_TC = FB_COL + N_FWD_COLS * TC_P * 4;
static_assert(SMEM_FIELD_TC <= 232448 && (!ONE_TILE || 2 * (SMEM_FIELD_TC + 1024) <= 233472),
              "two field CTAs share an SM at hidden 256, one fits wider");

__global__ void __launch_bounds__(THREADS, 2)
nerf_field_fwd_tc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                         const float* __restrict__ vec, const bf16* __restrict__ wmat, int n,
                         int real_p, int real_d, float* __restrict__ rgb_out,
                         float* __restrict__ sigma_out) {
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const FwdSmem sm = fwd_smem(sb, FB_COL);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TC_P;
  const int nvalid = min(TC_P, n - p0);
  const TcStash none{};
  forward_chain_tc<false>(
      [&] { encode_point_chunk_tc(pts, dirs, p0, nvalid, real_p, real_d, sm); }, vec, wmat, sm,
      none, 0, 0);
  if (tid < nvalid) sigma_out[p0 + tid] = sm.col[COL_SIGMA * TC_P + tid];
  if (tid < 3 * nvalid)
    rgb_out[static_cast<size_t>(p0) * 3 + tid] = sm.col[(COL_RGB + tid % 3) * TC_P + tid / 3];
}

}  // namespace

extern "C" {

// The bf16 field forward: rgb (n, 3) and sigma (n,) of the points (n, 3)
// and directions (n, 3); `wmat` the packed bf16 matrices, `vec` the float32
// vectors. The arguments are those of fused_nerf_fwd; `bf16` must be 1.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1
// when the packed buffers or the shapes do not fit this kernel.
int fused_nerf_fwd_tc(const float* pts, const float* dirs, const void* wmat, const float* vec,
                      int n_w, int n_b, int bf16, int n, int real_p, int real_d, float* rgb,
                      float* sigma, void* stream) {
  if (n_w != N_W || n_b != N_B || bf16 != 1 || n <= 0 || real_p < 3 || real_p > PP ||
      real_d < 3 || real_d > DP)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_field_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FIELD_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  nerf_field_fwd_tc_kernel<<<(n + TC_P - 1) / TC_P, THREADS, SMEM_FIELD_TC, s>>>(
      pts, dirs, vec, static_cast<const nerf::bf16*>(wmat), n, real_p, real_d, rgb, sigma);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_nerf_fwd_tc_error(int code) {
  if (code == -1) return "packed bf16 weights or shapes do not fit the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
