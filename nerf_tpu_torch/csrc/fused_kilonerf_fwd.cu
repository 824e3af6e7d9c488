// KiloNeRF field forward in float32 for Hopper (sm_90a): every point
// through the tiny MLP of the voxel it lies in, on the CUDA cores.
//
// Replaces: nerf_tpu/ops/pallas/fused_kilonerf.py::_fwd_kernel_mx (the
// forward of make_fused_kilonerf_apply) in float32; bfloat16 runs on the
// tensor cores (fused_kilonerf_fwd_tc.cu), and float32 stays here because
// TF32 would change its results. Same function: for each point, sorted by
// network, the L=10 encoding of its voxel-local position and the L=4
// encoding of its direction, then its network's l1 -> l2 -> trunk
// (density) -> rgb1 -> rgb2 -> sigmoid. The points are read through the
// sort (point i of a run is payload row order[i]) and each (rgb, sigma) is
// written to row order[i] of the point-order output: the sort and the
// segment offsets stay outside, as in the JAX package
// (ops/cuda/fused_kilonerf.py), but no gather of the payload or of the
// output does.
//
// What bounds it on this card: operations. A point costs 6,080 MACs at h 32
// (63x32 + 32x32 + 32x33 + 59x32 + 32x3) and 84 sines; at 262,144 points
// (a 1024-ray x 256-sample step) that is 3.19 GFLOP, 0.048 ms at the
// float32 CUDA-core rate, against 12.6 MB of payload in and out plus 12.7
// MB of weights (512 networks), 7.6 us at 3.35 TB/s.
//
// Design: the TPU kernel's lane-slotted block-diagonal packing, dummy rows
// and two-pass boundary tiles exist for Mosaic's static shapes and the MXU's
// latency; none is needed here. A CTA owns a run of at most 128 sorted
// points of ONE network (a segment, or a piece of a long one, found by a
// binary search over the running count of runs), stages that network's
// 6,212 parameters into shared memory as an aligned float32 block (25.8
// KB), and each thread carries one point through the whole chain in
// registers; every weight read is a shared-memory broadcast (the whole warp
// reads the same row), four weights per load. A skewed scene makes more
// runs of one network, not a longer CTA, so the forward has no load
// imbalance beyond the ragged last run of each segment.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_kilonerf_common.cuh"

namespace {

using namespace kilo;

constexpr int THREADS = 128;   // points per run: one per thread

__global__ void __launch_bounds__(THREADS)
fused_kilonerf_fwd_kernel(const float4* __restrict__ pay, const long long* __restrict__ order,
                          const int* __restrict__ offsets, const int* __restrict__ run_end,
                          int g3, const float* __restrict__ wpack, Dims dims,
                          float4* __restrict__ out) {
  __shared__ __align__(16) float w[NW];
  int g, start, end;
  if (!find_run(blockIdx.x, run_end, offsets, g3, THREADS, g, start, end)) return;
  stage_weights(w, wpack + static_cast<size_t>(g) * dims.R, dims);
  __syncthreads();
  const int i = start + threadIdx.x;
  if (i >= end) return;
  const long long row = order[i];
  const float4 a = pay[2 * row], b = pay[2 * row + 1];
  const float loc[3] = {a.x, a.y, a.z};
  const float dir[3] = {b.x, b.y, b.z};
  float rgb[3], sigma_pre;
  unsigned m1, my;
  point_forward<false>(w, loc, dir, dims, nullptr, rgb, sigma_pre, m1, my);
  out[row] = make_float4(rgb[0], rgb[1], rgb[2], fmaxf(sigma_pre, 0.0f));
}

}  // namespace

extern "C" {

// `pay` is the (n, 8) float32 payload in point order (cols 0-2 voxel-local
// position, 4-6 direction), `order` (n,) int64 the stable sort of the points
// by network, `offsets` the (g3 + 1) segment starts in that order, `run_end`
// the running count of `run`-point runs over the networks, `wpack` the
// (g3, R) packed float32 parameters, `out` the (n, 4) result (rgb, sigma)
// in point order. `grid` is the number of CTAs (at least the number of
// runs). Returns 0 on success, a cudaError_t code after a failed launch, or
// -1 when the widths or shapes do not fit this kernel.
int fused_kilonerf_fwd(const float* pay, const long long* order, const int* offsets,
                       const int* run_end, int g3, const float* wpack, int R, int P, int D,
                       int hidden, int n, int run, int grid, float* out, void* stream) {
  if (hidden != H || P > PMAX || D > DMAX || P < 3 || D < 3 ||
      R != packed_size(P, D) || g3 <= 0 || n <= 0 || run != THREADS || grid <= 0)
    return -1;
  fused_kilonerf_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pay), order, offsets, run_end, g3, wpack,
      Dims{P, D, R}, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_kilonerf_fwd_error(int code) {
  if (code == -1) return "widths or shapes do not fit the kernel (hidden 32, encodings "
                         "of at most 64 / 32 columns, 128-point runs)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
