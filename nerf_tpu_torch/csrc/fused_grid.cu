// Trilinear interpolation of a dense voxel grid at a batch of points, for
// Hopper (sm_90a).
//
// Replaces: nerf_tpu/ops/pallas/fused_grid.py::_grid_kernel (the forward of
// trilinear_rays), the same function as nerf_tpu/ops/interp.py::trilinear:
// points (n, 3) in [-1, 1] -> (n, C) float32, C <= 32, coordinates clamped
// to the grid's border (grid_common.cuh has the arithmetic, float32 and
// bfloat16 modes). It serves any batch: the TPU kernel's window plan, its
// fits bit and its fallback to the gather path have no counterpart here.
//
// What bounds it on this card: bytes. A point reads its 12-byte position
// and writes C floats; the grid rows it touches are read at least once each
// (at most R^3 rows of C floats). At a training step's 262,144 points of a
// 128^3 x 28 grid that is 32.5 MB of points and outputs plus the distinct
// rows touched (up to 235 MB), 0.01-0.08 ms at 3.35 TB/s; the 8 x 28
// multiply-adds a point are 0.004 ms of float32 CUDA-core time.
//
// Design: one warp per point, the lanes over channels (28 of 32 busy for
// Plenoxels), a grid-stride loop over the points. Every lane recomputes the
// stencil (a few dozen instructions) rather than broadcasting it; the eight
// corner loads of a lane are independent and in flight together; a point's
// output row is one coalesced 112-byte store. Rays that are close in space
// (tile-ordered camera rays, the upsample's lattice lines) reuse corner rows
// through the L2 cache.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "grid_common.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps: 8 points in flight a CTA
constexpr int MAX_CTAS = 16384;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
grid_interp_kernel(const float* __restrict__ points, const void* __restrict__ g, int r,
                   int c, long long n, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  const float half = 0.5f * static_cast<float>(r - 1);
  const float top = static_cast<float>(r - 1);
  for (long long i = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
       i < n; i += warps) {
    const float gx = grid::cell_of(points[3 * i], half, top);
    const float gy = grid::cell_of(points[3 * i + 1], half, top);
    const float gz = grid::cell_of(points[3 * i + 2], half, top);
    long long base;
    float w[8];
    grid::stencil<BF16>(gx, gy, gz, r, base, w);
    const float v = grid::interp_lane<BF16>(g, r, c, base, w, lane);
    if (lane < c) out[i * c + lane] = v;
  }
}

}  // namespace

extern "C" {

// `points` (n, 3) float32 in [-1, 1], `grid` the (r, r, r, c) grid (float32,
// or its bfloat16 copy when `bf16`), `out` (n, c) float32. Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 when the shapes do
// not fit this kernel (c in [1, 32], r >= 2, n >= 1).
int grid_interp(const float* points, const void* grid, int r, int c, int bf16, long long n,
                float* out, void* stream) {
  if (c < 1 || c > grid::LANES || r < 2 || n < 1) return -1;
  const long long need = (n + THREADS / 32 - 1) / (THREADS / 32);
  const int ctas = static_cast<int>(need < MAX_CTAS ? need : MAX_CTAS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    grid_interp_kernel<true><<<ctas, THREADS, 0, s>>>(points, grid, r, c, n, out);
  else
    grid_interp_kernel<false><<<ctas, THREADS, 0, s>>>(points, grid, r, c, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* grid_interp_error(int code) {
  if (code == -1) return "shapes do not fit the kernel (1 <= C <= 32 channels, R >= 2)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
