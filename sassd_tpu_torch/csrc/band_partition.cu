// K16: partition of the level-0 active set into overlapping y-bands.
//
// Replaces: sassd_tpu/parallel/sparse_spatial.py partition (B15), the entry
// of the banded sparse stage.
//
// Band s of S keeps the valid rows (z >= 0) of each sample b whose y lies in
// [lo, hi) = [s * band_h - halo, (s + 1) * band_h + halo) and compacts them,
// in input order, into row block (s, b) of the outputs: coords with y - lo
// (band-local; -1 padding) and the F feature floats (0 padding). A row's
// slot is its running rank among the band's members, so key-sorted input
// stays key-sorted. Members beyond `cap` are dropped and counted:
// overflow[s, b] = max(members - cap, 0).
//
// Bound on the H100: bytes. At the long-range config (B = 1, M = 80,000,
// F = 4, S = 4, cap 39,608) the inputs are 1.3 MB and the outputs 4.4 MB:
// ~1.7 us at 3.35 TB/s. Design: the rows are cut into tiles of 1024, and
// every tile is read by one block for all bands at once, 4 consecutive
// rows a thread, in two kernels of grid (tile, sample):
// - count: each block counts its tile's members of every band (a warp
//   reduction, then integer adds in shared memory) into a [B, tiles, S]
//   scratch;
// - scatter: each block sums the counts of the tiles before its own (its
//   offset in every band) and of all tiles (the band's members), ranks its
//   members with a block-wide scan per band on top of the offset, writes
//   those with rank < cap (a row as one float4 where F = 4), fills its share
//   of every band's padding slots [members, cap) (grid-stride over the
//   sample's blocks) and, in the first tile, the overflow.
// The bands go 8 at a time (kBands) through registers, any S. Integer sums
// only, in a fixed order: the result is deterministic and equals the plain
// version, bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;   // rows a block
constexpr int kBands = 8;                          // bands a pass
constexpr int kWarps = kThreads / 32;

// the zyx coords of the thread's kRowsPerThread consecutive rows of tile
// `tile` of a sample (z = -1 past m)
__device__ __forceinline__ void load_rows(const int* __restrict__ cb, int m,
                                          int tile, int z[kRowsPerThread],
                                          int y[kRowsPerThread],
                                          int x[kRowsPerThread]) {
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = tile * kTile + threadIdx.x * kRowsPerThread + r;
    z[r] = i < m ? cb[3LL * i] : -1;
    y[r] = i < m ? cb[3LL * i + 1] : 0;
    x[r] = i < m ? cb[3LL * i + 2] : 0;
  }
}

// bit j: the row is a member of band s0 + j
__device__ __forceinline__ unsigned band_bits(int z, int y, int s0, int bands,
                                              int band_h, int halo) {
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < kBands; ++j) {
    const int lo = (s0 + j) * band_h - halo;
    const bool mem = z >= 0 && s0 + j < bands && y >= lo &&
                     y < lo + band_h + 2 * halo;
    bits |= mem ? 1u << j : 0u;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
partition_count_kernel(const int* __restrict__ coords, int m, int bands,
                       int band_h, int halo, int* __restrict__ counts) {
  __shared__ int s_cnt[kBands];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tiles = gridDim.x;
  int z[kRowsPerThread], y[kRowsPerThread], x[kRowsPerThread];
  load_rows(coords + 3LL * b * m, m, tile, z, y, x);
  for (int s0 = 0; s0 < bands; s0 += kBands) {
    if (threadIdx.x < kBands) s_cnt[threadIdx.x] = 0;
    __syncthreads();
    unsigned bits[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      bits[r] = band_bits(z[r], y[r], s0, bands, band_h, halo);
    }
#pragma unroll
    for (int j = 0; j < kBands; ++j) {
      int n = 0;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) n += (bits[r] >> j) & 1u;
      n = __reduce_add_sync(0xffffffffu, n);
      if ((threadIdx.x & 31) == 0 && n > 0) atomicAdd(&s_cnt[j], n);
    }
    __syncthreads();
    if (threadIdx.x < kBands && s0 + threadIdx.x < bands) {
      counts[(static_cast<long long>(b) * tiles + tile) * bands + s0 +
             threadIdx.x] = s_cnt[threadIdx.x];
    }
    __syncthreads();                   // s_cnt is cleared next pass
  }
}

__global__ void __launch_bounds__(kThreads)
partition_scatter_kernel(const int* __restrict__ coords,
                         const float* __restrict__ rows, int batch, int m,
                         int f, int bands, int band_h, int halo, int cap,
                         const int* __restrict__ counts,
                         int* __restrict__ out_coords,
                         float* __restrict__ out_rows,
                         int* __restrict__ overflow) {
  __shared__ int s_off[kBands];        // members in the tiles before
  __shared__ int s_tot[kBands];        // members in every tile
  __shared__ int s_warp[kWarps][kBands];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tiles = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* rb = rows + static_cast<long long>(b) * m * f;
  const bool vec = f == 4 &&
      (reinterpret_cast<unsigned long long>(rows) & 15ull) == 0 &&
      (reinterpret_cast<unsigned long long>(out_rows) & 15ull) == 0;
  int z[kRowsPerThread], y[kRowsPerThread], x[kRowsPerThread];
  load_rows(coords + 3LL * b * m, m, tile, z, y, x);
  for (int s0 = 0; s0 < bands; s0 += kBands) {
    // the tiles' counts: this block's offset and the band's members
    int off[kBands], tot[kBands];
#pragma unroll
    for (int j = 0; j < kBands; ++j) off[j] = tot[j] = 0;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int* ct = counts + (static_cast<long long>(b) * tiles + t) * bands;
#pragma unroll
      for (int j = 0; j < kBands; ++j) {
        const int v = s0 + j < bands ? ct[s0 + j] : 0;
        tot[j] += v;
        off[j] += t < tile ? v : 0;
      }
    }
    if (threadIdx.x < kBands) s_off[threadIdx.x] = s_tot[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBands; ++j) {
      const int o = __reduce_add_sync(0xffffffffu, off[j]);
      const int a = __reduce_add_sync(0xffffffffu, tot[j]);
      if (lane == 0 && a > 0) {
        atomicAdd(&s_off[j], o);
        atomicAdd(&s_tot[j], a);
      }
    }
    // the rows' ranks: an inclusive scan of the threads' member counts in
    // each warp, then the warps' totals
    unsigned bits[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      bits[r] = band_bits(z[r], y[r], s0, bands, band_h, halo);
    }
    int incl[kBands];
#pragma unroll
    for (int j = 0; j < kBands; ++j) {
      int n = 0;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) n += (bits[r] >> j) & 1u;
      incl[j] = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl[j], d);
        if (lane >= d) incl[j] += u;
      }
      if (lane == 31) s_warp[warp][j] = incl[j];
      incl[j] -= n;                    // exclusive within the warp
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBands; ++j) {
      if (s0 + j >= bands) break;
      int rank = s_off[j] + incl[j];
      for (int w = 0; w < warp; ++w) rank += s_warp[w][j];
      const int lo = (s0 + j) * band_h - halo;
      const long long blk = static_cast<long long>(s0 + j) * batch + b;
      int* oc = out_coords + 3LL * blk * cap;
      float* orow = out_rows + blk * cap * f;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (!((bits[r] >> j) & 1u)) continue;
        if (rank < cap) {
          const long long i =
              static_cast<long long>(tile) * kTile + threadIdx.x *
              kRowsPerThread + r;
          oc[3LL * rank] = z[r];
          oc[3LL * rank + 1] = y[r] - lo;
          oc[3LL * rank + 2] = x[r];
          if (vec) {
            reinterpret_cast<float4*>(orow)[rank] =
                reinterpret_cast<const float4*>(rb)[i];
          } else {
            for (int k = 0; k < f; ++k) {
              orow[static_cast<long long>(rank) * f + k] = rb[i * f + k];
            }
          }
        }
        ++rank;
      }
      // padding: the sample's blocks share the slots [members, cap)
      const int tot_j = s_tot[j];
      for (int r = min(tot_j, cap) + tile * kThreads + threadIdx.x; r < cap;
           r += tiles * kThreads) {
        oc[3LL * r] = -1;
        oc[3LL * r + 1] = -1;
        oc[3LL * r + 2] = -1;
        if (vec) {
          reinterpret_cast<float4*>(orow)[r] =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          for (int k = 0; k < f; ++k) {
            orow[static_cast<long long>(r) * f + k] = 0.0f;
          }
        }
      }
      if (tile == 0 && threadIdx.x == 0) {
        overflow[blk] = tot_j > cap ? tot_j - cap : 0;
      }
    }
    __syncthreads();                   // the shared sums are reset next pass
  }
}

}  // namespace

// rows a tile of the two kernels' grids: the wrapper sizes the counts
// scratch from it
extern "C" int sassd_band_partition_tile_rows() { return kTile; }

// coords [batch, m, 3] int32 zyx (-1 padding); rows [batch, m, f] float32;
// counts [batch, max(1, ceil(m / tile rows)), bands] int32 scratch.
// Writes out_coords [bands, batch, cap, 3] int32, out_rows [bands, batch,
// cap, f] float32 and overflow [bands, batch] int32.
extern "C" int sassd_band_partition(const int* coords, const float* rows,
                                    int batch, int m, int f, int bands,
                                    int band_h, int halo, int cap,
                                    int* counts, int* out_coords,
                                    float* out_rows, int* overflow,
                                    void* stream) {
  if (bands > 0 && batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(m > 0 ? (m + kTile - 1) / kTile : 1, batch);
    partition_count_kernel<<<grid, kThreads, 0, s>>>(coords, m, bands,
                                                     band_h, halo, counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    partition_scatter_kernel<<<grid, kThreads, 0, s>>>(
        coords, rows, batch, m, f, bands, band_h, halo, cap, counts,
        out_coords, out_rows, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}
