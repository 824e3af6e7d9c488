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
// Design: one thread per point, C a template parameter (every C in 1..32
// has its kernel). A thread computes its point's stencil once and reads the
// eight corner rows whole, as the widest vectors the row stride keeps
// aligned (grid::interp_row, shared with the fused grid render: 7 x 16 B a
// float32 row of 28 channels, 7 x 8 B a bfloat16 one), every channel in its
// registers. A CTA's positions (12 B a point) come in, and its (points x C)
// outputs go out, through shared memory as consecutive 16-byte vectors
// across the threads, where a thread's own row would be a strided run of
// 4 C bytes. Rays that are close in space (tile-ordered camera rays, the
// upsample's lattice lines) reuse corner rows through the L2 cache. The
// warp-a-point kernel it replaced (a lane a channel: 32 stencils and 256
// scalar loads for every 32 points, 4 of 32 lanes idle at C = 28) took
// 0.0786 / 0.0740 ms (float32 / bfloat16) on the device at 1024 x 256
// training-ray points, this one 0.0544 / 0.0375 (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py's check_grid_interp_kernel); both give the same
// bits.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include <cstdint>

#include "grid_common.cuh"

namespace {

constexpr int THREADS = 128;       // points a CTA
constexpr long long MAX_CTAS = 1 << 30;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Floats [0, count) of src into dst, one of them in shared memory (both
// 16-byte aligned when `vec`): 16-byte vectors across the threads, then the
// tail one float a thread.
__device__ __forceinline__ void copy_floats(const float* __restrict__ src,
                                            float* __restrict__ dst, int count, bool vec) {
  int done = 0;
  if (vec) {
    const int nv = count / 4;
    for (int j = threadIdx.x; j < nv; j += THREADS)
      reinterpret_cast<float4*>(dst)[j] = reinterpret_cast<const float4*>(src)[j];
    done = 4 * nv;
  }
  for (int j = done + threadIdx.x; j < count; j += THREADS) dst[j] = src[j];
}

// Four CTAs an SM asked for (up to 128 registers a thread): ptxas then keeps
// many of a thread's corner loads in flight ahead of their products. With
// no minimum it held the registers near 48 and issued each load just before
// its product (slower on the H100 than the warp-a-point kernel); with a
// minimum of one it took 212 (float32), one CTA an SM, also slower.
template <bool BF16, int C>
__global__ void __launch_bounds__(THREADS, 4)
grid_interp_kernel(const float* __restrict__ points, const void* __restrict__ g, int r,
                   long long n, float* __restrict__ out) {
  __shared__ __align__(16) float pos[THREADS * 3];
  __shared__ __align__(16) float vals[THREADS * C];
  const int tid = threadIdx.x;
  const float half = 0.5f * static_cast<float>(r - 1);
  const float top = static_cast<float>(r - 1);
  const bool vec_in = aligned16(points), vec_out = aligned16(out);
  const long long tiles = (n + THREADS - 1) / THREADS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * THREADS;
    const int m = static_cast<int>(min(static_cast<long long>(THREADS), n - p0));
    // positions in (the tile's 12 m bytes start 16-byte aligned)
    copy_floats(points + 3 * p0, pos, 3 * m, vec_in);
    __syncthreads();
    if (tid < m) {
      const float gx = grid::cell_of(pos[3 * tid], half, top);
      const float gy = grid::cell_of(pos[3 * tid + 1], half, top);
      const float gz = grid::cell_of(pos[3 * tid + 2], half, top);
      long long base;
      float w[8], v[C];
      grid::stencil<BF16>(gx, gy, gz, r, base, w);
      grid::interp_row<BF16, C>(g, r, base, w, v);
      float* row = vals + tid * C;
      if constexpr (C % 4 == 0) {
#pragma unroll
        for (int i = 0; i < C / 4; ++i)
          reinterpret_cast<float4*>(row)[i] =
              make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      } else if constexpr (C % 2 == 0) {
#pragma unroll
        for (int i = 0; i < C / 2; ++i)
          reinterpret_cast<float2*>(row)[i] = make_float2(v[2 * i], v[2 * i + 1]);
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i) row[i] = v[i];
      }
    }
    __syncthreads();
    // outputs out (the tile's 4 C m bytes start 16-byte aligned); the next
    // tile's positions overwrite nothing this reads, and its outputs come
    // after the barrier that follows them
    copy_floats(vals, out + p0 * C, m * C, vec_out);
  }
}

// The kernel of `c` channels, for C = c .. 32.
template <bool BF16, int C>
void launch(int c, int ctas, cudaStream_t s, const float* points, const void* g, int r,
            long long n, float* out) {
  if (c == C)
    grid_interp_kernel<BF16, C><<<ctas, THREADS, 0, s>>>(points, g, r, n, out);
  else if constexpr (C < grid::MAX_C)
    launch<BF16, C + 1>(c, ctas, s, points, g, r, n, out);
}

}  // namespace

extern "C" {

// `points` (n, 3) float32 in [-1, 1], `grid` the (r, r, r, c) grid (float32,
// or its bfloat16 copy when `bf16`), 16-byte aligned, `out` (n, c) float32.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1 when
// the shapes do not fit this kernel (c in [1, 32], r >= 2, n >= 1, an
// aligned grid).
int grid_interp(const float* points, const void* grid, int r, int c, int bf16, long long n,
                float* out, void* stream) {
  if (c < 1 || c > grid::MAX_C || r < 2 || n < 1 || !aligned16(grid)) return -1;
  const long long tiles = (n + THREADS - 1) / THREADS;
  const int ctas = static_cast<int>(tiles < MAX_CTAS ? tiles : MAX_CTAS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<true, 1>(c, ctas, s, points, grid, r, n, out);
  else
    launch<false, 1>(c, ctas, s, points, grid, r, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* grid_interp_error(int code) {
  if (code == -1)
    return "shapes do not fit the kernel (1 <= C <= 32 channels, R >= 2, a 16-byte aligned "
           "grid)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
