// Exact, deterministic scatter-add of rows by id for Hopper (sm_90a):
// out[id] = sum of the value rows with that id, with no float atomics.
//
// Replaces: nerf_tpu/ops/pallas/scatter_add.py::_scatter_kernel
// (scatter_add_rows). The function is zeros((num_rows, C)).at[ids].add(vals),
// 1 <= C <= 32, int32 or int64 ids, ids outside [0, num_rows) skipped. In
// the port it is the 8-corner gradient scatter of the trilinear
// interpolation's backward (a Plenoxels training step scatters 8 x 262,144
// rows of 28 floats into a 128^3 grid).
//
// What bounds it on this card: bytes. The ids and the value rows are read
// once and every output row is written once: at the step's 2,097,152 x 28
// rows into 2,097,152 rows that is 478 MB, 0.1427 ms at 3.35 TB/s.
//
// The time it replaced (NVIDIA H100 80GB HBM3, 700 W): 0.5602 ms at the
// step's ids, a stable torch.sort of the int32 ids with an int64
// permutation (0.1814 ms, 32 key bits), a separate torch.zeros of the 235
// MB output, then two passes over 256-row chunks of the sorted rows, one
// piece at a time; index_add_ on the same ids took 0.5269 ms.
//
// Design. Everything is in this library, and every output row is written
// exactly once, zeros included (no memset of the output):
//   1. a stable LSD radix sort of the keys (an id in [0, num_rows), else
//      num_rows: skipped) with an int32 permutation, over only
//      bit_length(num_rows) key bits (3 passes of 8 bits at 2^21 rows, not
//      4 of a 32-bit sort; the first pass reads the ids themselves): per
//      pass a per-tile digit histogram, an exclusive scan of it in (digit,
//      tile) order, and a scatter in which each warp ranks its run of the
//      tile's keys in index order with __match_any_sync and a counter per
//      digit, the warps' counters then scanned in warp order; stable by
//      construction; each tile is sorted by digit in shared memory first,
//      so its keys leave it in one contiguous run a digit;
//   2. the row pointer without atomics: the end of each id's run of sorted
//      positions stored at its row, then an inclusive max-scan over the
//      rows (3 launches);
//   3. pieces, for runs longer than K = 256 only: the sorted positions cut
//      into chunks of K; one warp a chunk sums, in sorted order (lanes over
//      channels), the piece of such a run that crosses into it (head) and
//      the piece of such a run that starts in it (tail);
//   4. row owners: a group of lanes a row (float4 lanes over channels where
//      C % 4 == 0) reads its run from the row pointer and sums its rows in
//      sorted order when the run holds
//      at most K rows, or else adds the run's pieces in order (its first
//      chunk's tail piece, then each later chunk's head piece). An id
//      repeated 65,536 times is 256 chunk sums in parallel and one sum of
//      257 pieces, not one warp adding 65,536 rows.
// Sorted order is the ids' stable order, so each row sums its value rows in
// their input order: the same bits on every run. A run of n rows is summed
// in order (n <= K: n - 1 roundings) or in pieces of at most K rows and
// then its at most n / K + 2 pieces in order, so it errs by at most (K + n
// / K + 2) ulps of its sum of magnitudes.
//
// Built by nerf_tpu_torch/ops/cuda/build.py with nvcc into a shared library
// with a plain C interface (loaded by ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 256;             // K: sorted positions a piece chunk
constexpr int LANES = 32;
constexpr int RADIX_ITEMS = 16;        // keys a thread per radix tile
constexpr int RADIX_TILE = THREADS * RADIX_ITEMS;
constexpr int MAX_DIGIT_BITS = 8;
constexpr int SCAN_ITEMS = 16;         // counts a thread per scan tile
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- scans

// Max-scan of one value a thread over the block (values >= 0): the max of
// the threads before this one (exclusive) or up to it; `total` gets the
// block's max. Starts and ends past a barrier.
__device__ __forceinline__ int block_scan_max(int v, bool exclusive, int* total, int* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x = max(x, y);
  }
  int xe = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) xe = 0;
  __syncthreads();
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_s[lane] : 0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w = max(w, y);
    }
    if (lane < WARPS) warp_s[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_s[warp - 1] : 0;
  *total = warp_s[WARPS - 1];
  __syncthreads();
  return max(before, exclusive ? xe : x);
}

// Exclusive sum-scan of one value a thread over the block; `total` gets the
// block's sum. Starts and ends past a barrier.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total, int* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_s[lane] : 0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < WARPS) warp_s[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_s[warp - 1] : 0;
  *total = warp_s[WARPS - 1];
  __syncthreads();
  return before + x - v;
}

// The SCAN_ITEMS values of thread `t` of scan tile `b` (zeros past n).
__device__ __forceinline__ void load_items(const int* __restrict__ x, long long base, int n,
                                           int (&v)[SCAN_ITEMS]) {
  if (base + SCAN_ITEMS <= n) {
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
      const int4 t = reinterpret_cast<const int4*>(x + base)[q];
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) v[j] = base + j < n ? x[base + j] : 0;
  }
}

// bmax[b] = max of x[b * SCAN_TILE, (b + 1) * SCAN_TILE) (x of length n).
__global__ void __launch_bounds__(THREADS)
scatter_add_scan_reduce(const int* __restrict__ x, int n, int* __restrict__ bmax) {
  __shared__ int warp_s[WARPS];
  int v[SCAN_ITEMS];
  load_items(x, static_cast<long long>(blockIdx.x) * SCAN_TILE + threadIdx.x * SCAN_ITEMS, n, v);
  int m = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) m = max(m, v[j]);
  int total;
  block_scan_max(m, false, &total, warp_s);
  if (threadIdx.x == 0) bmax[blockIdx.x] = total;
}

// In place: bmax[b] becomes the max of bmax[0..b) (0 for b = 0; one block).
__global__ void __launch_bounds__(THREADS)
scatter_add_scan_top(int* __restrict__ bmax, int nb) {
  __shared__ int warp_s[WARPS];
  int carry = 0;
  for (int base = 0; base < nb; base += THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? bmax[i] : 0;
    int total;
    const int ex = block_scan_max(v, true, &total, warp_s);
    if (i < nb) bmax[i] = max(carry, ex);
    carry = max(carry, total);
  }
}

// In place: x[0..n) becomes its inclusive max-scan, tile b starting from
// bmax[b] (the max of the tiles before it).
__global__ void __launch_bounds__(THREADS)
scatter_add_scan_down(int* __restrict__ x, int n, const int* __restrict__ bmax) {
  __shared__ int warp_s[WARPS];
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  load_items(x, base, n, v);
#pragma unroll
  for (int j = 1; j < SCAN_ITEMS; ++j) v[j] = max(v[j], v[j - 1]);
  int total;
  const int off = max(bmax[blockIdx.x], block_scan_max(v[SCAN_ITEMS - 1], true, &total, warp_s));
  if (base + SCAN_ITEMS <= n) {
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q)
      reinterpret_cast<int4*>(x + base)[q] =
          make_int4(max(off, v[4 * q]), max(off, v[4 * q + 1]), max(off, v[4 * q + 2]),
                    max(off, v[4 * q + 3]));
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j)
      if (base + j < n) x[base + j] = max(off, v[j]);
  }
}

// ---------------------------------------------------------------- radix sort

// The sort key of an id: itself in [0, num_rows), else num_rows (sorted
// last, skipped). The identity on keys already made.
template <typename ID>
__device__ __forceinline__ int to_key(ID id, int num_rows) {
  return (id >= 0 && id < static_cast<ID>(num_rows)) ? static_cast<int>(id) : num_rows;
}

// hist[d * tiles + tile] = keys of digit d in the tile.
template <typename ID>
__global__ void __launch_bounds__(THREADS)
scatter_add_radix_hist(const ID* __restrict__ keys, int m, int num_rows, int shift, int mask,
                  int tiles, int* __restrict__ hist) {
  __shared__ int cnt[1 << MAX_DIGIT_BITS];
  for (int d = threadIdx.x; d <= mask; d += THREADS) cnt[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * RADIX_TILE;
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const int i = base + it * THREADS + threadIdx.x;
    if (i < m) atomicAdd(cnt + ((to_key(keys[i], num_rows) >> shift) & mask), 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d <= mask; d += THREADS)
    hist[static_cast<long long>(d) * tiles + blockIdx.x] = cnt[d];
}

// Block d: hist[d * tiles + 0 .. tiles) becomes its exclusive scan (tile
// order), totals[d] the digit's count.
__global__ void __launch_bounds__(THREADS)
scatter_add_radix_scan(int* __restrict__ hist, int tiles, int* __restrict__ totals) {
  __shared__ int warp_s[WARPS];
  int* h = hist + static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? h[i] : 0;
    int total;
    const int ex = block_exclusive_sum(v, &total, warp_s);
    if (i < tiles) h[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One stable pass: each key of the tile goes to its digit's base (the
// digits before it over all tiles, plus its digit in the tiles before this
// one) plus its rank among the tile's keys of that digit in index order.
// Warp w takes the tile's w-th run of RADIX_ITEMS * 32 keys in rounds of 32
// (index order); a key's rank is its digit's count in the earlier warps
// (a prefix over the warps' counters), in the warp's earlier rounds (its
// counter) and in the earlier lanes of its round (__match_any_sync). The
// tile is first sorted by digit in shared memory, so that the keys of one
// digit leave it as one contiguous run. perm_in == nullptr: the identity
// (the first pass, which reads the ids).
template <typename ID>
__global__ void __launch_bounds__(THREADS)
scatter_add_radix_sort(const ID* __restrict__ keys_in, const int* __restrict__ perm_in, int m,
                     int num_rows, int shift, int mask, int tiles, const int* __restrict__ hist,
                     const int* __restrict__ totals, int* __restrict__ keys_out,
                     int* __restrict__ perm_out) {
  constexpr int NB = 1 << MAX_DIGIT_BITS;
  __shared__ int base_s[NB];                 // global position of the tile's first key of d
  __shared__ int start_s[NB];                // tile position of its first key of d
  __shared__ int wcnt[WARPS][NB];
  __shared__ int warp_s[WARPS];
  __shared__ int key_s[RADIX_TILE];
  __shared__ int src_s[RADIX_TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = mask + 1;
  const int t0 = blockIdx.x * RADIX_TILE;
  const int tile_n = min(RADIX_TILE, m - t0);
  {
    const int v = tid < nb ? totals[tid] : 0;
    int total;
    const int ex = block_exclusive_sum(v, &total, warp_s);
    if (tid < nb) base_s[tid] = ex + hist[static_cast<long long>(tid) * tiles + blockIdx.x];
  }
  for (int j = tid; j < WARPS * NB; j += THREADS) (&wcnt[0][0])[j] = 0;
  const int w0 = t0 + warp * RADIX_ITEMS * 32;
  int key[RADIX_ITEMS], src[RADIX_ITEMS], rank[RADIX_ITEMS];
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const int i = w0 + it * 32 + lane;
    key[it] = i < m ? to_key(keys_in[i], num_rows) : 0;
    src[it] = i < m ? (perm_in != nullptr ? perm_in[i] : i) : 0;
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const bool valid = w0 + it * 32 + lane < m;
    const int d = valid ? (key[it] >> shift) & mask : NB;   // NB: no digit
    const unsigned peers = __match_any_sync(FULL, d);
    const int leader = __ffs(peers) - 1;
    int before = (valid && lane == leader) ? wcnt[warp][d] : 0;
    before = __shfl_sync(FULL, before, leader);
    rank[it] = before + __popc(peers & lower);
    if (valid && lane == leader) wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int count = 0;
  if (tid < nb) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w][tid];
      wcnt[w][tid] = count;
      count += c;
    }
  }
  {
    int total;
    const int ex = block_exclusive_sum(tid < nb ? count : 0, &total, warp_s);
    if (tid < nb) start_s[tid] = ex;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    if (w0 + it * 32 + lane < m) {
      const int d = (key[it] >> shift) & mask;
      const int at = start_s[d] + wcnt[warp][d] + rank[it];
      key_s[at] = key[it];
      src_s[at] = src[it];
    }
  }
  __syncthreads();
  for (int j = tid; j < tile_n; j += THREADS) {
    const int k = key_s[j];
    const int d = (k >> shift) & mask;
    const int dst = base_s[d] + j - start_s[d];
    keys_out[dst] = k;
    perm_out[dst] = src_s[j];
  }
}

// rowptr[1 + k] = the end (one past) of key k's run of sorted positions,
// for every kept key present (the caller zeroed rowptr; its inclusive
// max-scan is then the row pointer).
__global__ void __launch_bounds__(THREADS)
scatter_add_run_ends(const int* __restrict__ sid, int m, int num_rows, int* __restrict__ rowptr) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const int k = sid[i];
  if (k < num_rows && (i == m - 1 || sid[i + 1] != k)) rowptr[1 + k] = i + 1;
}

// ---------------------------------------------------------------- sums

// Sum of channel `lane` of the value rows of sorted positions [a, b), in
// order (lanes >= c give 0).
__device__ __forceinline__ float sum_piece(const int* __restrict__ perm,
                                           const float* __restrict__ vals, int c, int a,
                                           int b, int lane) {
  float acc = 0.0f;
  for (int q = a; q < b; q += LANES) {
    const int n = min(LANES, b - q);
    const int mine = lane < n ? perm[q + lane] : 0;
#pragma unroll 8
    for (int u = 0; u < n; ++u) {
      const long long s = __shfl_sync(FULL, mine, u);
      acc = __fadd_rn(acc, lane < c ? vals[s * c + lane] : 0.0f);
    }
  }
  return acc;
}

// One warp a chunk of CHUNK sorted positions [lo, hi), for the runs longer
// than CHUNK only: the sum of the piece of the run that began in an earlier
// chunk (its head piece) into head[chunk], and of the piece of the run that
// begins in this chunk and goes on past it (its tail piece) into
// tail[chunk]. Runs are read from the row pointer.
__global__ void __launch_bounds__(THREADS)
scatter_add_pieces(const int* __restrict__ sid, const int* __restrict__ perm,
              const float* __restrict__ vals, const int* __restrict__ rowptr, int m, int c,
              int num_rows, float* __restrict__ head, float* __restrict__ tail) {
  const int lane = threadIdx.x & 31;
  const long long chunk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const long long lo_l = chunk * CHUNK;
  if (lo_l >= m) return;
  const int lo = static_cast<int>(lo_l);
  const int hi = min(lo + CHUNK, m);
  const int id0 = sid[lo];
  if (id0 < num_rows) {
    const int s = rowptr[id0], e = rowptr[id0 + 1];
    if (e - s > CHUNK && s < lo) {
      const float v = sum_piece(perm, vals, c, lo, min(hi, e), lane);
      if (lane < c) head[chunk * c + lane] = v;
    }
  }
  const int idl = sid[hi - 1];
  if (idl < num_rows) {
    const int s = rowptr[idl], e = rowptr[idl + 1];
    if (e - s > CHUNK && s >= lo) {
      const float v = sum_piece(perm, vals, c, s, hi, lane);
      if (lane < c) tail[chunk * c + lane] = v;
    }
  }
}

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void add_vec(Vec<VEC>& a, const Vec<VEC>& b) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) a.v[u] = __fadd_rn(a.v[u], b.v[u]);
}

// Row owners: 2^lpr_shift lanes a row, VEC channels a lane. Each row's run
// [rowptr[row], rowptr[row + 1]) of sorted positions is summed in order
// when it holds at most CHUNK rows; a longer run adds its pieces in order:
// the tail piece of its first chunk, then the head piece of each later
// chunk (a whole chunk where the run covers it). Rows without ids get
// zeros.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
scatter_add_rows(const int* __restrict__ rowptr, const int* __restrict__ perm,
            const float* __restrict__ vals, int c, int num_rows, int lpr_shift,
            const float* __restrict__ head, const float* __restrict__ tail,
            float* __restrict__ out) {
  const long long gt = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long row = gt >> lpr_shift;
  const int ch = static_cast<int>(gt & ((1 << lpr_shift) - 1)) * VEC;
  if (row >= num_rows || ch >= c) return;
  const int s = rowptr[row], e = rowptr[row + 1];
  Vec<VEC> acc;
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc.v[u] = 0.0f;
  if (e - s <= CHUNK) {
    int p = s;
    for (; p + 4 <= e; p += 4) {
      const long long s0 = perm[p], s1 = perm[p + 1], s2 = perm[p + 2], s3 = perm[p + 3];
      const Vec<VEC> v0 = load_vec<VEC>(vals + s0 * c + ch);
      const Vec<VEC> v1 = load_vec<VEC>(vals + s1 * c + ch);
      const Vec<VEC> v2 = load_vec<VEC>(vals + s2 * c + ch);
      const Vec<VEC> v3 = load_vec<VEC>(vals + s3 * c + ch);
      add_vec(acc, v0);
      add_vec(acc, v1);
      add_vec(acc, v2);
      add_vec(acc, v3);
    }
    for (; p < e; ++p) add_vec(acc, load_vec<VEC>(vals + static_cast<long long>(perm[p]) * c + ch));
  } else {
    const int ks = s / CHUNK, ke = (e - 1) / CHUNK;
    acc = load_vec<VEC>(tail + static_cast<long long>(ks) * c + ch);
    int k = ks + 1;
    for (; k + 4 <= ke + 1; k += 4) {
      const Vec<VEC> v0 = load_vec<VEC>(head + static_cast<long long>(k) * c + ch);
      const Vec<VEC> v1 = load_vec<VEC>(head + static_cast<long long>(k + 1) * c + ch);
      const Vec<VEC> v2 = load_vec<VEC>(head + static_cast<long long>(k + 2) * c + ch);
      const Vec<VEC> v3 = load_vec<VEC>(head + static_cast<long long>(k + 3) * c + ch);
      add_vec(acc, v0);
      add_vec(acc, v1);
      add_vec(acc, v2);
      add_vec(acc, v3);
    }
    for (; k <= ke; ++k) add_vec(acc, load_vec<VEC>(head + static_cast<long long>(k) * c + ch));
  }
  float* o = out + row * c + ch;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc.v[0], acc.v[1], acc.v[2], acc.v[3]);
  } else {
    *o = acc.v[0];
  }
}

// ---------------------------------------------------------------- workspace

struct Workspace {
  int *keys_a, *keys_b, *perm_a, *perm_b, *rowptr, *bsum, *hist, *totals;
  float *head, *tail;
  size_t bytes;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The caller's workspace, carved in 16-byte aligned pieces (base may be null
// to size it).
Workspace carve(void* base, long long m, int c, int num_rows, int digit_bits) {
  Workspace w{};
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](long long bytes) {
    char* at = p + off;
    off += static_cast<size_t>(ceil_div(bytes, 16) * 16);
    return at;
  };
  const long long mm = m > 0 ? m : 1;
  const long long n = static_cast<long long>(num_rows) + 1;
  const long long tiles = ceil_div(mm, RADIX_TILE);
  const long long chunks = ceil_div(mm, CHUNK);
  w.keys_a = reinterpret_cast<int*>(take(mm * 4));
  w.keys_b = reinterpret_cast<int*>(take(mm * 4));
  w.perm_a = reinterpret_cast<int*>(take(mm * 4));
  w.perm_b = reinterpret_cast<int*>(take(mm * 4));
  w.rowptr = reinterpret_cast<int*>(take(n * 4));
  w.bsum = reinterpret_cast<int*>(take(ceil_div(n, SCAN_TILE) * 4));
  w.hist = reinterpret_cast<int*>(take((1LL << digit_bits) * tiles * 4));
  w.totals = reinterpret_cast<int*>(take((1LL << digit_bits) * 4));
  w.head = reinterpret_cast<float*>(take(chunks * c * 4));
  w.tail = reinterpret_cast<float*>(take(chunks * c * 4));
  w.bytes = off;
  return w;
}

bool fits(long long m, int c, int num_rows, int passes, int digit_bits) {
  if (c < 1 || c > LANES || m < 0 || m > 0x7fffffffLL - 2 * RADIX_TILE || num_rows < 1 ||
      num_rows == 0x7fffffff || digit_bits < 1 || digit_bits > MAX_DIGIT_BITS || passes < 1)
    return false;
  int bits = 0;
  while (bits < 31 && (static_cast<long long>(num_rows) >> bits) != 0) ++bits;
  return passes * digit_bits >= bits;
}

}  // namespace

extern "C" {

// Bytes of workspace scatter_add needs for these shapes (0 where they do
// not fit the kernel).
long long scatter_add_workspace(long long m, int c, int num_rows, int passes, int digit_bits) {
  if (!fits(m, c, num_rows, passes, digit_bits)) return 0;
  return static_cast<long long>(carve(nullptr, m, c, num_rows, digit_bits).bytes);
}

// `ids` (m,) int32 (ids64 == 0) or int64, `vals` (m, c) float32, `out`
// (num_rows, c) float32, every row written (no need to zero it); ids
// outside [0, num_rows) are skipped. The keys are sorted in `passes` radix
// passes of `digit_bits` bits (passes * digit_bits >= bit_length(num_rows)).
// `ws`: scatter_add_workspace bytes. Returns 0 on success, a cudaError_t
// code after a failed launch, or -1 when the shapes do not fit this kernel.
int scatter_add(const void* ids, int ids64, const float* vals, long long m, int c,
                int num_rows, int passes, int digit_bits, void* ws, float* out,
                void* stream) {
  if (!fits(m, c, num_rows, passes, digit_bits)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w = carve(ws, m, c, num_rows, digit_bits);
  const int mi = static_cast<int>(m);
  const int n = num_rows + 1;
  cudaError_t err = cudaMemsetAsync(w.rowptr, 0, static_cast<size_t>(n) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* perm = w.perm_a;
  if (mi > 0) {
    const int tiles = static_cast<int>(ceil_div(mi, RADIX_TILE));
    const int mask = (1 << digit_bits) - 1;
    int *kout = w.keys_b, *pout = w.perm_b;
    const int *kin = nullptr, *pin = nullptr;
    for (int pass = 0; pass < passes; ++pass) {
      const int shift = pass * digit_bits;
      if (pass == 0 && ids64) {
        const long long* id = static_cast<const long long*>(ids);
        scatter_add_radix_hist<long long><<<tiles, THREADS, 0, s>>>(id, mi, num_rows, shift, mask,
                                                               tiles, w.hist);
        scatter_add_radix_scan<<<mask + 1, THREADS, 0, s>>>(w.hist, tiles, w.totals);
        scatter_add_radix_sort<long long><<<tiles, THREADS, 0, s>>>(
            id, nullptr, mi, num_rows, shift, mask, tiles, w.hist, w.totals, kout, pout);
      } else {
        const int* id = pass == 0 ? static_cast<const int*>(ids) : kin;
        scatter_add_radix_hist<int><<<tiles, THREADS, 0, s>>>(id, mi, num_rows, shift, mask, tiles,
                                                         w.hist);
        scatter_add_radix_scan<<<mask + 1, THREADS, 0, s>>>(w.hist, tiles, w.totals);
        scatter_add_radix_sort<int><<<tiles, THREADS, 0, s>>>(
            id, pin, mi, num_rows, shift, mask, tiles, w.hist, w.totals, kout, pout);
      }
      kin = kout;
      pin = pout;
      kout = (kout == w.keys_b) ? w.keys_a : w.keys_b;
      pout = (pout == w.perm_b) ? w.perm_a : w.perm_b;
    }
    perm = pin;
    scatter_add_run_ends<<<static_cast<int>(ceil_div(mi, THREADS)), THREADS, 0, s>>>(kin, mi, num_rows,
                                                                                w.rowptr);
    const int nb = static_cast<int>(ceil_div(n, SCAN_TILE));
    scatter_add_scan_reduce<<<nb, THREADS, 0, s>>>(w.rowptr, n, w.bsum);
    scatter_add_scan_top<<<1, THREADS, 0, s>>>(w.bsum, nb);
    scatter_add_scan_down<<<nb, THREADS, 0, s>>>(w.rowptr, n, w.bsum);
    const long long chunks = ceil_div(mi, CHUNK);
    scatter_add_pieces<<<static_cast<int>(ceil_div(chunks, WARPS)), THREADS, 0, s>>>(
        kin, perm, vals, w.rowptr, mi, c, num_rows, w.head, w.tail);
  }
  const bool vec4 = c % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_lane = vec4 ? 4 : 1;
  int lpr_shift = 0;
  while ((1 << lpr_shift) * per_lane < c) ++lpr_shift;
  const long long blocks = ceil_div(static_cast<long long>(num_rows) << lpr_shift, THREADS);
  if (blocks > 0x7fffffffLL) return -1;
  if (vec4)
    scatter_add_rows<4><<<static_cast<int>(blocks), THREADS, 0, s>>>(
        w.rowptr, perm, vals, c, num_rows, lpr_shift, w.head, w.tail, out);
  else
    scatter_add_rows<1><<<static_cast<int>(blocks), THREADS, 0, s>>>(
        w.rowptr, perm, vals, c, num_rows, lpr_shift, w.head, w.tail, out);
  return static_cast<int>(cudaGetLastError());
}

const char* scatter_add_error(int code) {
  if (code == -1)
    return "shapes do not fit the kernel (1 <= C <= 32 channels, M < 2^31 - 4096 rows, "
           "1 <= num_rows < 2^31 - 1, radix passes covering the row ids)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
