// Exact, deterministic scatter-add of rows by id for Hopper (sm_90a):
// out[id] = sum of the value rows with that id, with no float atomics.
//
// Replaces: nerf_tpu/ops/pallas/scatter_add.py::_scatter_kernel
// (scatter_add_rows). The function is zeros((num_rows, C)).at[ids].add(vals),
// C <= 32. As the TPU kernel does, the ids are sorted outside the kernel (a
// stable torch.sort in the wrapper, lax.sort_key_val there) and the kernel
// sums each run of equal ids in a fixed order and writes each touched row
// once, so every run gives the same bits. In the port it is the 8-corner
// gradient scatter of the trilinear interpolation's backward (a Plenoxels
// training step scatters 8 x 262,144 rows of 28 floats into a 128^3 grid).
//
// What bounds it on this card: bytes. The sorted ids (4 bytes a row), the
// permutation (8) and the value rows (4 C) are read once, the touched rows
// written once; at the step's 2,097,152 x 28 rows that is 260 MB, 0.078 ms
// at 3.35 TB/s (the zeroed output, up to 235 MB, is the wrapper's memset).
//
// Design: the values are read through the sort permutation, not through a
// gathered copy. The M sorted positions are cut into chunks of K = 256; one
// warp a chunk, its lanes over channels. Pass 1 walks its chunk's pieces
// (a piece is a run of one id inside the chunk) in order, loading 32
// positions' ids and permutation entries at a time and finding a piece's
// extent with a ballot; each lane sums its channel of the piece's rows in
// order. A piece that is a whole run is written to its row; the first
// piece of a chunk that continues a run from the previous chunk goes to the
// chunk's head slot, the last piece that starts a run and continues past
// the chunk to its tail slot. Pass 2 gives each run that crosses chunks to
// the warp of the chunk where it starts: the tail, then the heads of the
// following chunks in order. So a run of n rows costs at most K + n / K
// dependent adds instead of n: an id repeated 65,536 times (the border
// cells where clamped samples land) is 256 chunk sums in parallel and one
// sum of 256 partials, not one warp adding 65,536 rows.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // 8 warps, one chunk each
constexpr int CHUNK = 256;       // sorted positions a chunk
constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Window {                  // 32 sorted positions held by the warp
  long long start;
  int id;                        // this lane's position's id (-1 past the end)
  long long src;                 // its value row (the permutation entry)
};

__device__ __forceinline__ void load_window(Window& win, long long start, long long hi,
                                            const int* __restrict__ sid,
                                            const long long* __restrict__ perm, int lane) {
  win.start = start;
  const long long q = start + lane;
  win.id = (q < hi) ? sid[q] : -1;
  win.src = (q < hi) ? perm[q] : 0;
}

__global__ void __launch_bounds__(THREADS)
scatter_pieces_kernel(const int* __restrict__ sid, const long long* __restrict__ perm,
                      const float* __restrict__ vals, long long m, int c, int num_rows,
                      float* __restrict__ head, float* __restrict__ tail,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long chunk = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  const long long lo = chunk * CHUNK;
  if (lo >= m) return;
  const long long hi = min(lo + CHUNK, m);
  const int before = (lo > 0) ? sid[lo - 1] : -1;
  Window win;
  load_window(win, lo, hi, sid, perm, lane);
  long long j = lo;
  while (j < hi) {
    const int id = __shfl_sync(FULL, win.id, static_cast<int>(j - win.start));
    float acc = 0.0f;
    long long q = j;
    while (true) {
      const long long pos = win.start + lane;
      const unsigned run = __ballot_sync(FULL, win.id == id && pos >= q && pos < hi);
      const int n = __popc(run);
      const int off = static_cast<int>(q - win.start);
#pragma unroll 8
      for (int u = 0; u < n; ++u) {
        const long long src = __shfl_sync(FULL, win.src, off + u);
        if (lane < c) acc = __fadd_rn(acc, vals[src * c + lane]);
      }
      q += n;
      if (q < win.start + LANES || q >= hi) break;   // the piece ended
      load_window(win, win.start + LANES, hi, sid, perm, lane);
    }
    const bool starts = j > lo || lo == 0 || before != id;
    const bool ends = q < hi || q == m || sid[q] != id;
    if (lane < c) {
      if (starts && ends) {
        if (id >= 0 && id < num_rows) out[static_cast<long long>(id) * c + lane] = acc;
      } else if (!starts) {
        head[chunk * c + lane] = acc;
      } else {
        tail[chunk * c + lane] = acc;
      }
    }
    j = q;
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_runs_kernel(const int* __restrict__ sid, long long m, int c, int num_rows,
                    const float* __restrict__ head, const float* __restrict__ tail,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long chunk = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  const long long lo = chunk * CHUNK;
  if (lo >= m) return;
  const long long hi = min(lo + CHUNK, m);
  const int id = sid[hi - 1];
  if (hi == m || sid[hi] != id) return;                      // no run leaves this chunk
  if (sid[lo] == id && lo > 0 && sid[lo - 1] == id) return;  // nor starts in it
  float acc = (lane < c) ? tail[chunk * c + lane] : 0.0f;
  for (long long k = chunk + 1;; ++k) {
    if (lane < c) acc = __fadd_rn(acc, head[k * c + lane]);
    const long long end = min((k + 1) * CHUNK, m);
    if (end == m || sid[end - 1] != id || sid[end] != id) break;
  }
  if (lane < c && id >= 0 && id < num_rows) out[static_cast<long long>(id) * c + lane] = acc;
}

}  // namespace

extern "C" {

// `sid` (m,) int32 ids sorted ascending, `perm` (m,) int64 the stable sort's
// permutation (sid[i] = ids[perm[i]]), `vals` (m, c) float32 in the unsorted
// order, `out` (num_rows, c) float32, zeroed by the caller: every row whose
// id occurs is written once, others are left alone (ids outside [0,
// num_rows) are skipped). `head`, `tail`: (ceil(m / 256), c) float32
// scratch. Returns 0 on success, a cudaError_t code after a failed launch,
// or -1 when the shapes do not fit this kernel (c in [1, 32], m >= 1).
int scatter_add_sorted(const int* sid, const long long* perm, const float* vals, long long m,
                       int c, int num_rows, float* head, float* tail, float* out,
                       void* stream) {
  if (c < 1 || c > LANES || m < 1 || num_rows < 1) return -1;
  const long long chunks = (m + CHUNK - 1) / CHUNK;
  const long long ctas = (chunks + THREADS / 32 - 1) / (THREADS / 32);
  if (ctas > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scatter_pieces_kernel<<<static_cast<int>(ctas), THREADS, 0, s>>>(sid, perm, vals, m, c,
                                                                  num_rows, head, tail, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_runs_kernel<<<static_cast<int>(ctas), THREADS, 0, s>>>(sid, m, c, num_rows, head,
                                                                tail, out);
  return static_cast<int>(cudaGetLastError());
}

int scatter_add_chunk() { return CHUNK; }

const char* scatter_add_error(int code) {
  if (code == -1) return "shapes do not fit the kernel (1 <= C <= 32 channels, M >= 1 rows)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
