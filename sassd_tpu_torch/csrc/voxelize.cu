// K8: device voxelization of raw padded point clouds (serving path).
//
// Replaces: sassd_tpu/ops/voxelize.py voxelize_jax (B6).
//
// Each valid point in range gets the linear key (z * gy + y) * gx + x of
// its cell, c = floor((p - pcr) / vs) per axis; invalid points (index >=
// n_points[b] or a cell off the grid) get INVALID_KEY. The output keeps the
// max_voxels LOWEST keys, key-sorted: voxels [B, Vmax, T, F] (zero padded),
// coords [B, Vmax, 3] zyx int32 (-1 padded), num_points [B, Vmax]; a
// voxel's slots hold its first T points in scan order (first-come), as the
// stable key sort of the JAX version gives them.
//
// Design: no sort. One entry point clears its scratch (two memsets) and
// runs five kernels:
// - mark: one thread per point. The quantisation is a float32 subtract,
//   an IEEE divide (__fdiv_rn, never a reciprocal multiply) and floorf, so
//   a point on a cell boundary lands in the cell the plain version and JAX
//   give it (the library is built with -fmad=false). The point's key is
//   stored, and its cell's bit set with atomicOr in a one-bit-per-cell
//   bitmap of the grid, padded to whole 32,768-cell tiles; the one thread
//   that finds the bit clear adds one to its tile's count, so the counts
//   are the tiles' distinct cells whatever the order of the atomics;
// - scan: one block per sample, exclusive prefix sum of the tile counts
//   (the rank of each tile's first cell) and the sample's voxel total;
// - rank: one block per (tile, sample) that holds a cell ranked below the
//   cap ranks its words' set bits with a block scan and writes key
//   word * 32 + bit to rank base + r while that is below max_voxels: the
//   ascending distinct keys, capped. A voxel's row is its key's rank;
// - place: one thread per valid point finds its key in the capped list (a
//   binary search over <= max_voxels keys that sit in L2; a key past the
//   cap is not there and the point is dropped) and inserts its index into
//   the voxel's T slots, kept ascending: atomicMin at slot t keeps the
//   smaller index and the thread goes on to slot t + 1 with the larger,
//   until it fills an empty slot or passes slot T - 1. Slot t so ends with
//   the (t + 1)-th smallest index of the voxel's points, in any order of
//   the atomics: the stable sort's first-come slots;
// - write: one thread per (sample, voxel row, slot) copies the slot's
//   point or zeros; slot 0 also writes the row's count (its filled slots)
//   and its coords, decoded from the key, or -1 past the last voxel.
//
// Memory: the bitmap is gx * gy * gz / 8 bytes a sample, 11.26 MB at the
// car grid [40, 1600, 1408] (2,750 tiles) and 16.4 MB at long range's
// [40, 1600, 2048] (4,000 tiles): it stays in the H100's 50 MB L2 between
// the passes. The wrapper allocates it and the rest of the scratch with
// torch.empty; this file clears it.
//
// Bound on the H100: bytes, the valid points read and the voxel rows
// written once (65,536 points are 1 MB in, the car outputs 2.2 MB); the
// passes are latency bound, and the bitmap's clear and its read by the
// tiles that hold voxels follow the grid, not the points. Every value is a
// copy or an integer, so the result is bitwise equal to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;
constexpr unsigned kEmptySlot = 0xffffffffu;               // memset 0xff
constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;                          // one uint4
constexpr int kTileWords = kThreads * kWordsPerThread;      // 32,768 cells
constexpr int kTileShift = 15;
constexpr int kScanThreads = 1024;

__global__ void mark_kernel(const float* __restrict__ points,
                            const int* __restrict__ n_points, int p, int f,
                            float pc0, float pc1, float pc2, float vs0,
                            float vs1, float vs2, int gx, int gy, int gz,
                            int tiles, int* __restrict__ keys,
                            unsigned* __restrict__ bitmap,
                            int* __restrict__ tile_counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= p) return;
  const long long row = static_cast<long long>(b) * p + i;
  const float* pt = points + row * f;
  const int cx = __float2int_rz(floorf(__fdiv_rn(__fsub_rn(pt[0], pc0), vs0)));
  const int cy = __float2int_rz(floorf(__fdiv_rn(__fsub_rn(pt[1], pc1), vs1)));
  const int cz = __float2int_rz(floorf(__fdiv_rn(__fsub_rn(pt[2], pc2), vs2)));
  const bool ok = i < n_points[b] && cx >= 0 && cx < gx && cy >= 0 &&
                  cy < gy && cz >= 0 && cz < gz;
  const int key = ok ? (cz * gy + cy) * gx + cx : kInvalidKey;
  keys[row] = key;
  if (!ok) return;
  const unsigned bit = 1u << (key & 31);
  const unsigned old = atomicOr(
      bitmap + static_cast<long long>(b) * tiles * kTileWords + (key >> 5),
      bit);
  if (!(old & bit)) {
    atomicAdd(tile_counts + static_cast<long long>(b) * tiles +
                  (key >> kTileShift), 1);
  }
}

// Exclusive prefix sum of v over the block's THREADS threads in thread
// order; `red` holds THREADS / 32 ints.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += u;
  }
  if (lane == 31) red[warp] = s;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += red[i];
  return before + s - v;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ tile_counts, int tiles,
            int* __restrict__ tile_base, int* __restrict__ total) {
  __shared__ int red[kScanThreads / 32];
  const int b = blockIdx.x;
  const int* tc = tile_counts + static_cast<long long>(b) * tiles;
  int* tb = tile_base + static_cast<long long>(b) * tiles;
  const int chunk = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * chunk, tiles);
  const int hi = min(lo + chunk, tiles);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += tc[t];
  int before = block_exclusive_scan<kScanThreads>(sum, red);
  for (int t = lo; t < hi; ++t) {
    tb[t] = before;
    before += tc[t];
  }
  if (threadIdx.x == kScanThreads - 1) total[b] = before;
}

__device__ __forceinline__ int popc4(const uint4& q) {
  return __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
}

__global__ void __launch_bounds__(kThreads)
rank_kernel(const unsigned* __restrict__ bitmap,
            const int* __restrict__ tile_counts,
            const int* __restrict__ tile_base, int tiles, int vmax,
            int* __restrict__ ukeys) {
  __shared__ int red[kThreads / 32];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const long long ti = static_cast<long long>(b) * tiles + t;
  const int base = tile_base[ti];
  if (tile_counts[ti] == 0 || base >= vmax) return;     // uniform
  const long long word0 = static_cast<long long>(t) * kTileWords +
                          threadIdx.x * kWordsPerThread;
  const uint4 q = reinterpret_cast<const uint4*>(
      bitmap + static_cast<long long>(b) * tiles * kTileWords + word0)[0];
  int rank = base + block_exclusive_scan<kThreads>(popc4(q), red);
  int* o = ukeys + static_cast<long long>(b) * vmax;
  const unsigned words[kWordsPerThread] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    unsigned v = words[j];
    const int cell0 = static_cast<int>((word0 + j) * 32);
    while (v != 0u && rank < vmax) {
      o[rank++] = cell0 + __ffs(v) - 1;
      v &= v - 1u;
    }
  }
}

__global__ void place_kernel(const int* __restrict__ keys, int p,
                             const int* __restrict__ ukeys,
                             const int* __restrict__ total, int vmax,
                             int t_max, unsigned* __restrict__ slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= p) return;
  const int key = keys[static_cast<long long>(b) * p + i];
  if (key == kInvalidKey) return;
  const int nk = min(total[b], vmax);
  const int* u = ukeys + static_cast<long long>(b) * vmax;
  int lo = 0, hi = nk;                                  // lower bound
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo >= nk || u[lo] != key) return;                 // past the cap
  unsigned* s = slots + (static_cast<long long>(b) * vmax + lo) * t_max;
  unsigned cur = static_cast<unsigned>(i);
  for (int t = 0; t < t_max; ++t) {
    const unsigned old = atomicMin(s + t, cur);
    if (old == kEmptySlot) break;
    cur = max(old, cur);
  }
}

__global__ void write_kernel(const float* __restrict__ points,
                             const unsigned* __restrict__ slots,
                             const int* __restrict__ ukeys, int p, int f,
                             int vmax, int t_max, int gx, int gy,
                             float* __restrict__ voxels,
                             int* __restrict__ coords,
                             int* __restrict__ num_points) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (idx >= vmax * t_max) return;
  const int v = idx / t_max;
  const int t = idx - v * t_max;
  const long long vrow = static_cast<long long>(b) * vmax + v;
  const unsigned* s = slots + vrow * t_max;
  const unsigned src = s[t];
  float* out = voxels + (vrow * t_max + t) * f;
  if (src != kEmptySlot) {
    const float* pt = points + (static_cast<long long>(b) * p + src) * f;
    for (int c = 0; c < f; ++c) out[c] = pt[c];
  } else {
    for (int c = 0; c < f; ++c) out[c] = 0.0f;
  }
  if (t == 0) {
    int n = 0;
    for (int u = 0; u < t_max; ++u) n += s[u] != kEmptySlot ? 1 : 0;
    num_points[vrow] = n;
    int* co = coords + vrow * 3;
    if (n > 0) {
      const int key = ukeys[vrow];
      co[0] = key / (gx * gy);
      co[1] = (key / gx) % gy;
      co[2] = key % gx;
    } else {
      co[0] = co[1] = co[2] = -1;
    }
  }
}

}  // namespace

// points [batch, p, f] float32 (xyz first); n_points [batch] int32;
// tiles = ceil(gx * gy * gz / 32768); scratch: int32 words laid out as
// bitmap [batch, tiles * 1024], tile counts [batch, tiles] (both cleared
// here), tile bases [batch, tiles], totals [batch], keys [batch, p],
// sorted keys [batch, vmax], slots [batch, vmax, t_max] (cleared here);
// voxels [batch, vmax, t_max, f] float32; coords [batch, vmax, 3] and
// num_points [batch, vmax] int32.
extern "C" int sassd_voxelize(const float* points, const int* n_points,
                              int batch, int p, int f, float pc0, float pc1,
                              float pc2, float vs0, float vs1, float vs2,
                              int gx, int gy, int gz, int vmax, int t_max,
                              int tiles, int* scratch, float* voxels,
                              int* coords, int* num_points, void* stream) {
  if (batch <= 0 || vmax <= 0 || tiles <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bt = static_cast<long long>(batch) * tiles;
  unsigned* bitmap = reinterpret_cast<unsigned*>(scratch);
  int* tile_counts = scratch + bt * kTileWords;
  int* tile_base = tile_counts + bt;
  int* total = tile_base + bt;
  int* keys = total + batch;
  int* ukeys = keys + static_cast<long long>(batch) * p;
  unsigned* slots = reinterpret_cast<unsigned*>(
      ukeys + static_cast<long long>(batch) * vmax);
  cudaError_t err = cudaMemsetAsync(
      bitmap, 0, sizeof(int) * static_cast<size_t>(bt) * (kTileWords + 1),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(
      slots, 0xff,
      sizeof(unsigned) * static_cast<size_t>(batch) * vmax * t_max, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pgrid((p + kThreads - 1) / kThreads, batch);
  if (p > 0) {
    mark_kernel<<<pgrid, kThreads, 0, s>>>(points, n_points, p, f, pc0, pc1,
                                           pc2, vs0, vs1, vs2, gx, gy, gz,
                                           tiles, keys, bitmap, tile_counts);
  }
  scan_kernel<<<batch, kScanThreads, 0, s>>>(tile_counts, tiles, tile_base,
                                             total);
  rank_kernel<<<dim3(tiles, batch), kThreads, 0, s>>>(
      bitmap, tile_counts, tile_base, tiles, vmax, ukeys);
  if (p > 0) {
    place_kernel<<<pgrid, kThreads, 0, s>>>(keys, p, ukeys, total, vmax,
                                            t_max, slots);
  }
  const dim3 wgrid((vmax * t_max + kThreads - 1) / kThreads, batch);
  write_kernel<<<wgrid, kThreads, 0, s>>>(points, slots, ukeys, p, f, vmax,
                                          t_max, gx, gy, voxels, coords,
                                          num_points);
  return static_cast<int>(cudaGetLastError());
}
