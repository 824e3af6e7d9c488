// KiloNeRF field forward in bfloat16 on Hopper's tensor cores (sm_90a):
// every point through the tiny MLP of the voxel it lies in.
//
// Replaces: nerf_tpu/ops/pallas/fused_kilonerf.py::_fwd_kernel_mx (the
// forward of make_fused_kilonerf_apply) in bfloat16, the kilonerf config's
// dtype; float32 stays on the CUDA cores (fused_kilonerf_fwd.cu), as TF32
// would change its results. Same function as there: the L=10 encoding of
// each point's voxel-local position and the L=4 encoding of its direction,
// then its network's l1 -> relu -> l2 -> relu -> trunk (32 features, and the
// density column from the unrounded x2) -> rgb1 on [features, direction
// encoding] -> relu -> rgb2 -> sigmoid; every product input rounded to
// bfloat16 (the packed weights already are), float32 sums, the bias added
// after the sum.
//
// What bounds it on this card: bytes. A point reads its order entry and
// 32-byte payload row and writes 16 bytes; the 512 networks' bfloat16
// weights are 6.4 MB: 21 MB at 262,144 points, 6.3 us at 3.35 TB/s. Its
// 6,080 MACs a point are 1.6 GMAC there, 3 us at the bf16 tensor-core peak.
// Its 84 sines a point (sinf with the full range reduction, 22 M of them)
// are what bounds this design in practice.
//
// Design: a CTA owns a run of at most 128 sorted points of ONE network
// (fused_kilonerf_common.cuh::find_run, as the CUDA-core kernel), four
// warps of 32 points. The CTA stages its network's weights once into
// shared memory in the B-fragment layout, all 50 loads of a thread in
// flight together; each lane reads one point through the sort; then the
// warp runs fused_kilonerf_tc_common.cuh::point_chain_tc (the encodings
// into the warp's row-per-point tiles, each lane a point, then every layer
// on mma.sync m16n8k16 with the accumulators as the next layer's A
// fragments; the header says more), which the bfloat16 backward
// (fused_kilonerf_bwd_tc.cu) runs too. A version that computed each
// fragment's encoding columns in registers, 96 inlined sines a lane, ran
// markedly slower. A point's (rgb, sigma) goes straight to its row
// order[i] of the point-order output, so no gather of the payload or of
// the output runs outside the kernel.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include "fused_kilonerf_tc_common.cuh"

namespace {

using namespace kilo;

struct Smem {
  uint2 frag[NFRAG][32];
  float vec[NV];
  __align__(16) __nv_bfloat16 penc[THREADS / 32][32][LDP];
  __align__(16) __nv_bfloat16 denc[THREADS / 32][32][LDD];
};

__global__ void __launch_bounds__(THREADS)
fused_kilonerf_fwd_tc_kernel(const float* __restrict__ pay, const long long* __restrict__ order,
                             const int* __restrict__ offsets, const int* __restrict__ run_end,
                             int g3, const __nv_bfloat16* __restrict__ wpack, Dims dims,
                             float* __restrict__ out) {
  __shared__ Smem sm;
  int g, start, end;
  if (!find_run(blockIdx.x, run_end, offsets, g3, THREADS, g, start, end)) return;
  stage(sm.frag, sm.vec, wpack + static_cast<size_t>(g) * dims.R, dims.P, dims.D);
  __syncthreads();
  const int w0 = start + (threadIdx.x >> 5) * 32;
  if (w0 >= end) return;
  const int lane = threadIdx.x & 31, gq = lane >> 2, c = lane & 3, warp = threadIdx.x >> 5;
  // lane p loads and encodes point w0 + p; row gq + 8 h of m-tile mt is
  // point 16 mt + gq + 8 h
  const int i = w0 + lane;
  const long long mine = i < end ? order[i] : -1;
  float loc[3] = {0.f, 0.f, 0.f}, dir[3] = {0.f, 0.f, 0.f};
  if (mine >= 0) {
    const float4 a = *reinterpret_cast<const float4*>(pay + 8 * mine);
    const float4 b = *reinterpret_cast<const float4*>(pay + 8 * mine + 4);
    loc[0] = a.x; loc[1] = a.y; loc[2] = a.z;
    dir[0] = b.x; dir[1] = b.y; dir[2] = b.z;
  }
  long long row[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) row[p] = __shfl_sync(FULL, mine, 16 * (p >> 1) + gq + 8 * (p & 1));
  float rgb[4][2], sig[4];
  NoHooks none;
  point_chain_tc(sm.frag, sm.vec, sm.penc[warp], sm.denc[warp], loc, dir, dims.P, dims.D, rgb,
                 sig, none);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float blue = __shfl_down_sync(FULL, rgb[p][0], 1);   // column 2, from lane c = 1
    if (c == 0 && row[p] >= 0)
      *reinterpret_cast<float4*>(out + 4 * row[p]) = make_float4(rgb[p][0], rgb[p][1], blue,
                                                                 sig[p]);
  }
}

}  // namespace

extern "C" {

// `pay` is the (n, 8) float32 payload in point order (cols 0-2 voxel-local
// position, 4-6 direction), `order` (n,) int64 the stable sort of the points
// by network, `offsets` the (g3 + 1) segment starts in that order, `run_end`
// the running count of `run`-point runs over the networks, `wpack` the
// (g3, R) packed bfloat16 parameters, `out` the (n, 4) result (rgb, sigma)
// in point order. `grid` is the number of CTAs (at least the number of
// runs). Returns 0 on success, a cudaError_t code after a failed launch, or
// -1 when the widths or shapes do not fit this kernel.
int fused_kilonerf_fwd_tc(const float* pay, const long long* order, const int* offsets,
                          const int* run_end, int g3, const void* wpack, int R, int P, int D,
                          int hidden, int n, int run, int grid, float* out, void* stream) {
  if (hidden != H || P > PMAX || D > DMAX || P < 3 || D < 3 || R != packed_size(P, D) ||
      g3 <= 0 || n <= 0 || run != THREADS || grid <= 0)
    return -1;
  fused_kilonerf_fwd_tc_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pay, order, offsets, run_end, g3, static_cast<const __nv_bfloat16*>(wpack),
      Dims{P, D, R}, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_kilonerf_fwd_tc_error(int code) {
  if (code == -1) return "widths or shapes do not fit the kernel (hidden 32, encodings "
                         "of at most 64 / 32 columns, 128-point runs)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
