// K9: the anchors mask of device-resident serving, an integral image kept
// on the compressed lattice of the anchors' corner rows and columns.
//
// Replaces: sassd_tpu/serve.py _integral_image + anchors_mask_jax and
// anchors_mask_jax_separable (B7).
//
// The mask counts the voxels in (x0, x1] x (y0, y1] of each anchor and
// compares the count with a threshold. Only the integral image's values at
// corner rows and columns are ever read, so the integral is kept on the
// lattice of the sorted distinct corner values (serve.anchor_lattice): grid
// cell (y, x) maps to lattice cell (ymap[y], xmap[x]), the first corner
// row and column at or past it; a cell past the last corner (-1) lies in no
// anchor and is dropped. x0 < x <= x1 holds exactly when
// x0 < X[xmap[x]] <= x1, so the lattice's integral at the corners' lattice
// indices is the grid's. Car: 583 x 518 int32 cells (1.2 MB) where the grid
// was 1600 x 1408 float32 (9 MB).
//
// One entry point, five device operations on the stream:
// 1. cudaMemsetAsync zeroes the [B, LY, LX] int32 lattice;
// 2. scatter: one thread a voxel row adds 1 at its lattice cell with an
//    integer atomicAdd; padding rows (z < 0), cells off the grid and cells
//    past the last corner add nothing;
// 3. row scan: one block a lattice row, one element a thread (segments of
//    the block's width beyond that, with a carry), a warp-shuffle scan and a
//    scan of the warp totals: every load and store coalesced, LY x B blocks
//    (583 at car batch 1);
// 4. column scan: one block 4 adjacent columns x 256 row chunks, so a
//    warp's load reads 4 adjacent ints of 8 rows; each thread sums its
//    chunk, one warp a column scans the 256 chunk sums, each thread
//    rewrites its chunk with running sums: ceil(LX / 4) x B blocks (130 at
//    car batch 1 on the H100's 132 SMs, where 8 columns a block would
//    leave half of them idle). A chunk's rows are loaded kChunkRegs at a
//    time into registers, so a chunk of up to kChunkRegs rows (every
//    lattice of up to 1024 rows) costs one round trip to the L2 for its sum
//    and none for its rewrite;
// 5. mask: one thread a (sample, anchor) reads its lattice corners (int4)
//    and writes area > threshold, area = C[y1, x1] - C[y0, x1] - C[y1, x0] +
//    C[y0, x0], converted to float32.
//
// Counts are integers below 2^24: exact in int32 in any order of the
// atomics, and exact as float32, so the mask is the plain version's bit for
// bit. Bound on the H100: the function's bytes (coords and corner indices
// in, the mask out), ~0.4 us at car batch 1; five dependent operations on a
// lattice that stays in the L2 make it a matter of latency, not bandwidth.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRowThreads = 1024;  // row scan: elements a pass
constexpr int kScanCols = 4;          // column scan: columns a block
constexpr int kScanChunks = 256;      // column scan: row chunks a column
// A column's chunk sums in shared memory, chunk c at c + c / 32: the warp
// that scans them reads 8 consecutive chunks a lane, and the skew puts the
// 32 lanes' reads in 32 banks (lane * 8 + lane / 4 is distinct mod 32).
constexpr int kSumsRow = kScanChunks + kScanChunks / 32;
constexpr int kChunkRegs = 4;         // column scan: rows loaded at a time

__global__ void lattice_scatter_kernel(const int* __restrict__ coords, int v,
                                       const int* __restrict__ ymap, int h,
                                       const int* __restrict__ xmap, int w,
                                       int ly, int lx,
                                       int* __restrict__ lattice) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= v) return;
  const int* c = coords + (static_cast<long long>(b) * v + row) * 3;
  const int z = c[0], y = c[1], x = c[2];
  if (z < 0 || y < 0 || y >= h || x < 0 || x >= w) return;
  const int my = ymap[y], mx = xmap[x];
  if (my < 0 || mx < 0) return;
  atomicAdd(lattice + (static_cast<long long>(b) * ly + my) * lx + mx, 1);
}

// Inclusive scan over the block (blockDim.x a multiple of 32); every thread
// gets its prefix, and `total` the block's sum.
__device__ __forceinline__ int block_inclusive_scan(int x, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next pass
  return x;
}

__global__ void __launch_bounds__(kMaxRowThreads)
lattice_row_scan_kernel(int* __restrict__ lattice, int ly, int lx) {
  __shared__ int warp_sums[32];
  int* line = lattice + (static_cast<long long>(blockIdx.y) * ly +
                         blockIdx.x) * lx;
  int carry = 0;
  for (int base = 0; base < lx; base += blockDim.x) {
    const int e = base + threadIdx.x;
    int total;
    const int x = block_inclusive_scan(e < lx ? line[e] : 0, warp_sums,
                                       total);
    if (e < lx) line[e] = x + carry;
    carry += total;
  }
}

// Rows [r0, min(r0 + K, hi)) of a lattice column into v (0 past hi): K
// independent loads.
template <int K>
__device__ __forceinline__ void load_rows(const int* col, int lx, int r0,
                                          int hi, int (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = r0 + k < hi ? col[static_cast<long long>(r0 + k) * lx] : 0;
  }
}

// Writes the running sums of v, starting from run, to the same rows;
// returns the last.
template <int K>
__device__ __forceinline__ int store_running(int* col, int lx, int r0,
                                             int hi, const int (&v)[K],
                                             int run) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    run += v[k];
    if (r0 + k < hi) col[static_cast<long long>(r0 + k) * lx] = run;
  }
  return run;
}

__global__ void __launch_bounds__(kScanCols * kScanChunks)
lattice_col_scan_kernel(int* __restrict__ lattice, int ly, int lx) {
  __shared__ int sums[kScanCols][kSumsRow];
  const int cl = threadIdx.x % kScanCols;
  const int ch = threadIdx.x / kScanCols;
  const int col = blockIdx.x * kScanCols + cl;
  const int chunk = (ly + kScanChunks - 1) / kScanChunks;
  const int lo = min(ch * chunk, ly);
  const int hi = min(lo + chunk, ly);
  int* base = lattice + static_cast<long long>(blockIdx.y) * ly * lx + col;
  const bool ok = col < lx;
  // the chunk's sum; its first kChunkRegs rows stay in registers for the
  // rewrite
  int head[kChunkRegs];
  int s = 0;
  if (ok) {
    load_rows(base, lx, lo, hi, head);
#pragma unroll
    for (int k = 0; k < kChunkRegs; ++k) s += head[k];
    for (int r0 = lo + kChunkRegs; r0 < hi; r0 += kChunkRegs) {
      int v[kChunkRegs];
      load_rows(base, lx, r0, hi, v);
#pragma unroll
      for (int k = 0; k < kChunkRegs; ++k) s += v[k];
    }
  }
  sums[cl][ch + ch / 32] = s;
  __syncthreads();
  // one warp a column: the exclusive scan of its chunk sums, 8 a lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kScanCols) {
    constexpr int kPerLane = kScanChunks / 32;
    int v[kPerLane];
    int t = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane * kPerLane + k;
      v[k] = sums[warp][c + c / 32];
      t += v[k];
    }
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - t;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane * kPerLane + k;
      sums[warp][c + c / 32] = run;
      run += v[k];
    }
  }
  __syncthreads();
  if (!ok) return;
  int run = store_running(base, lx, lo, hi, head, sums[cl][ch + ch / 32]);
  for (int r0 = lo + kChunkRegs; r0 < hi; r0 += kChunkRegs) {
    int v[kChunkRegs];
    load_rows(base, lx, r0, hi, v);
    run = store_running(base, lx, r0, hi, v, run);
  }
}

__global__ void lattice_mask_kernel(const int* __restrict__ lattice,
                                    const int4* __restrict__ corners, int a,
                                    int ly, int lx, float threshold,
                                    unsigned char* __restrict__ mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= a) return;
  const int4 c = corners[i];  // x0 y0 x1 y1 on the lattice
  const int* g = lattice + static_cast<long long>(b) * ly * lx;
  const int area = g[c.w * lx + c.z] - g[c.y * lx + c.z] -
                   g[c.w * lx + c.x] + g[c.y * lx + c.x];
  mask[static_cast<long long>(b) * a + i] =
      static_cast<float>(area) > threshold ? 1 : 0;
}

}  // namespace

// coords [batch, v, 3] int32 zyx (-1 rows = padding); ymap [h], xmap [w]
// int32 lattice row and column of each grid row and column (-1: past the
// last corner); corners [a, 4] int32 (x0, y0, x1, y1) on the [ly, lx]
// lattice, 16-byte aligned; lattice [batch, ly, lx] int32 scratch, written
// whole; mask [batch, a] bool (one byte each).
extern "C" int sassd_anchors_mask(const int* coords, int batch, int v,
                                  const int* ymap, int h, const int* xmap,
                                  int w, const int* corners, int a, int ly,
                                  int lx, float threshold, int* lattice,
                                  unsigned char* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || a <= 0) return 0;
  if (ly <= 0 || lx <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      lattice, 0, sizeof(int) * static_cast<size_t>(batch) * ly * lx, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  if (v > 0) {
    lattice_scatter_kernel<<<dim3((v + threads - 1) / threads, batch),
                             threads, 0, s>>>(coords, v, ymap, h, xmap, w,
                                              ly, lx, lattice);
  }
  const int row_threads =
      lx < kMaxRowThreads ? (lx + 31) / 32 * 32 : kMaxRowThreads;
  lattice_row_scan_kernel<<<dim3(ly, batch), row_threads, 0, s>>>(lattice,
                                                                  ly, lx);
  lattice_col_scan_kernel<<<dim3((lx + kScanCols - 1) / kScanCols, batch),
                            kScanCols * kScanChunks, 0, s>>>(lattice, ly, lx);
  lattice_mask_kernel<<<dim3((a + threads - 1) / threads, batch), threads, 0,
                        s>>>(lattice, reinterpret_cast<const int4*>(corners),
                             a, ly, lx, threshold, mask);
  return static_cast<int>(cudaGetLastError());
}
