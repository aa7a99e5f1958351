// K5: scatter of the last sparse level into the dense tail's NCHW canvas;
// K5b: its backward, the gather of the canvas gradient at the active rows.
//
// Replaces: sassd_tpu/ops/sparse.py to_dense (twice: features and
// occupancy) and the d-major transpose of sassd_tpu/models/backbone.py
// densify_bev / the dense-tail entry (channel z * C + c).
//
// Row m of sample b with key (z * H + y) * W + x puts feats[b, m, c] at
// canvas[b, z * C + c, y, x] for every c, and 1 at occ[b, z, 0, y, x]; every
// other element of both is 0. INVALID_KEY padding rows (and any key outside
// the grid) put nothing. Keys are unique, so the result does not depend on
// the order of the writes and the card check is bitwise.
//
// Bound on the H100: bytes. At the car config the canvas ([5 * 64, 200,
// 176], 45 MB) is written once, ~0.0135 ms at 3.35 TB/s; the 10240 rows x
// 64 channels (2.6 MB) are read once. Design: output-stationary, so the
// canvas and occupancy come out of one pass that writes every element
// exactly once (the wrapper allocates them uninitialised):
// - row map: a memset of a [B, D * H * W] int32 map to -1 and one thread per
//   row writing its row index at its key (K6's index map, kept here so that
//   K5's launch count and time cover the whole op; 0.7 MB at the car L3);
// - canvas pass: one thread per (sample, z, y, four consecutive x, a chunk of
//   16 channels) reads the four map entries and, for each channel of its
//   chunk, stores the four pixels as one 16-byte store (0 where the map holds
//   -1); a warp writes 512 contiguous bytes per channel. The chunk-0 thread
//   writes the four occupancy values. When W % 4 != 0 the rows of the canvas
//   are not 16-byte aligned and the thread stores its pixels one by one,
//   masked at the grid's edge.
// The rows' features are read at ~6% of the cells at the car L3 and stay in
// L2.
//
// K5b reads d_canvas at the same addresses into d_feats (0 for padding rows
// and keys off the grid); a copy, so bitwise equal to the plain autograd
// gather. Bound on the H100: bytes, counted two ways. Useful bytes: the
// keys, one float per active (row, channel) and d_feats written once, ~5.2
// MB at the car L3 (batch 2, ~20,000 active rows x 64 channels), 0.0032 ms
// at 3.35 TB/s. At sector granularity, an estimate for a cold L2: the
// canvas values of one row lie H*W floats apart, so each active (row,
// channel) costs one 32-byte sector unless an x-neighbour shares it: ~41
// MB, 0.012 ms (calls repeated on one canvas find those sectors in the
// 50 MB L2 and run under it). Design:
// row-stationary through shared memory, one block per tile of 32
// consecutive rows of one sample and up to 64 channels:
// - one thread per row reads its key and decodes it to its canvas offset
//   once (padding and off-grid keys marked);
// - read phase: lanes run over the tile's rows, the 8 warps over channels,
//   so a warp reads one channel of 32 key-sorted rows, and x-adjacent
//   active cells share a sector; the values go into a [32][65] tile (the
//   padding column keeps lanes on distinct banks);
// - write phase: the tile's rows are one contiguous run of d_feats when
//   C <= 64, written with lanes over consecutive floats, 16-byte stores
//   when C % 4 == 0 (0 for marked rows).
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;
constexpr int kChanChunk = 16;
// K5b's tile: rows (one per lane) by channels, read by kBwdThreads / 32 warps
constexpr int kBwdRows = 32;
constexpr int kBwdChans = 64;
constexpr int kBwdThreads = 256;

__global__ void densify_map_kernel(const int* __restrict__ keys, int m,
                                   long long total, int* __restrict__ map) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= m) return;
  const int key = keys[static_cast<long long>(b) * m + row];
  if (key == kInvalidKey || key < 0 || key >= total) return;
  map[static_cast<long long>(b) * total + key] = row;
}

// blockIdx.y: channel chunk; blockIdx.z: sample; x over (z, y, x / 4).
__global__ void densify_kernel(const int* __restrict__ map,
                               const float* __restrict__ feats, int m, int c,
                               int d, int h, int w,
                               float* __restrict__ canvas,
                               float* __restrict__ occ) {
  const int wq = (w + 3) / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(d) * h * wq) return;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const int x = 4 * static_cast<int>(i % wq);
  const int y = static_cast<int>((i / wq) % h);
  const int z = static_cast<int>(i / (static_cast<long long>(wq) * h));
  const long long hw = static_cast<long long>(h) * w;
  const long long pix = static_cast<long long>(y) * w + x;
  const long long cell = (static_cast<long long>(b) * d + z) * hw + pix;
  const bool vec = (w & 3) == 0;
  int r[4];
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(map + cell);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = x + k < w ? map[cell + k] : -1;
  }
  const float* fb = feats + static_cast<long long>(b) * m * c;
  float* cb = canvas + (static_cast<long long>(b) * d + z) * c * hw + pix;
  const int c0 = chunk * kChanChunk;
  const int c1 = min(c0 + kChanChunk, c);
  for (int ch = c0; ch < c1; ++ch) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = r[k] >= 0 ? fb[static_cast<long long>(r[k]) * c + ch] : 0.0f;
    }
    float* dst = cb + static_cast<long long>(ch) * hw;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (x + k < w) dst[k] = v[k];
      }
    }
  }
  if (chunk == 0) {
    float* ob = occ + cell;
    if (vec) {
      *reinterpret_cast<float4*>(ob) = make_float4(
          r[0] >= 0 ? 1.0f : 0.0f, r[1] >= 0 ? 1.0f : 0.0f,
          r[2] >= 0 ? 1.0f : 0.0f, r[3] >= 0 ? 1.0f : 0.0f);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (x + k < w) ob[k] = r[k] >= 0 ? 1.0f : 0.0f;
      }
    }
  }
}

// grid (ceil(m / kBwdRows), ceil(c / kBwdChans), batch), kBwdThreads
__global__ void __launch_bounds__(kBwdThreads) densify_bwd_kernel(
    const int* __restrict__ keys, const float* __restrict__ d_canvas, int m,
    int c, int d, int h, int w, float* __restrict__ d_feats) {
  __shared__ long long s_off[kBwdRows];            // -1: write 0
  __shared__ float s_tile[kBwdRows][kBwdChans + 1];
  const int r0 = blockIdx.x * kBwdRows;
  const int c0 = blockIdx.y * kBwdChans;
  const int b = blockIdx.z;
  const int rows = min(kBwdRows, m - r0);
  const int cc = min(kBwdChans, c - c0);
  const long long hw = static_cast<long long>(h) * w;
  const int tid = threadIdx.x;
  if (tid < kBwdRows) {
    long long off = -1;
    if (tid < rows) {
      const int key = keys[static_cast<long long>(b) * m + r0 + tid];
      if (key != kInvalidKey && key >= 0 && key < d * hw) {
        const int x = key % w;
        const int y = (key / w) % h;
        const int z = static_cast<int>(key / hw);
        off = ((static_cast<long long>(b) * d + z) * c + c0) * hw +
              static_cast<long long>(y) * w + x;
      }
    }
    s_off[tid] = off;
  }
  __syncthreads();
  const int lane = tid & 31;
  const long long off = s_off[lane];
  for (int ch = tid >> 5; ch < cc; ch += kBwdThreads / 32) {
    s_tile[lane][ch] = off >= 0 ? d_canvas[off + ch * hw] : 0.0f;
  }
  __syncthreads();
  float* dst = d_feats + (static_cast<long long>(b) * m + r0) * c + c0;
  if ((c & 3) == 0) {
    // c0 is a multiple of 64, so cc and every row's run are 16-byte aligned
    const int n4 = rows * cc / 4;
    for (int j = tid; j < n4; j += kBwdThreads) {
      const int r = 4 * j / cc;
      const int col = 4 * j - r * cc;
      const float* t = &s_tile[r][col];
      *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * c + col) =
          make_float4(t[0], t[1], t[2], t[3]);
    }
  } else {
    for (int j = tid; j < rows * cc; j += kBwdThreads) {
      const int r = j / cc;
      const int col = j - r * cc;
      dst[static_cast<long long>(r) * c + col] = s_tile[r][col];
    }
  }
}

}  // namespace

// keys [batch, m] int32; feats [batch, m, c] float32; map [batch, d * h * w]
// int32 scratch; canvas [batch, d * c, h, w] and occ [batch, d, 1, h, w]
// float32, every element written here.
extern "C" int sassd_densify(const int* keys, const float* feats, int batch,
                             int m, int c, int d, int h, int w, int* map,
                             float* canvas, float* occ, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(d) * h * w;
  if (batch <= 0 || total <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(
      map, 0xff, sizeof(int) * static_cast<size_t>(batch) * total, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  if (m > 0) {
    const dim3 grid((m + threads - 1) / threads, batch);
    densify_map_kernel<<<grid, threads, 0, s>>>(keys, m, total, map);
  }
  const long long quads = static_cast<long long>(d) * h * ((w + 3) / 4);
  const int chunks = (c + kChanChunk - 1) / kChanChunk;
  const dim3 grid(static_cast<unsigned>((quads + threads - 1) / threads),
                  chunks > 0 ? chunks : 1, batch);
  densify_kernel<<<grid, threads, 0, s>>>(map, feats, m, c, d, h, w, canvas,
                                          occ);
  return static_cast<int>(cudaGetLastError());
}

// keys [batch, m] int32; d_canvas [batch, d * c, h, w] float32 (contiguous);
// d_feats [batch, m, c] float32.
extern "C" int sassd_densify_bwd(const int* keys, const float* d_canvas,
                                 int batch, int m, int c, int d, int h, int w,
                                 float* d_feats, void* stream) {
  if (batch > 0 && m > 0 && c > 0) {
    const dim3 grid((m + kBwdRows - 1) / kBwdRows,
                    (c + kBwdChans - 1) / kBwdChans, batch);
    densify_bwd_kernel<<<grid, kBwdThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        keys, d_canvas, m, c, d, h, w, d_feats);
  }
  return static_cast<int>(cudaGetLastError());
}
