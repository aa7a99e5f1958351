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
// L2. K5b reads d_canvas at the same addresses into d_feats (0 for padding
// rows), one thread per (row, channel); a copy, so bitwise equal to the
// plain autograd gather.
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;
constexpr int kChanChunk = 16;

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

__global__ void densify_bwd_kernel(const int* __restrict__ keys,
                                   const float* __restrict__ d_canvas, int m,
                                   int c, int d, int h, int w,
                                   float* __restrict__ d_feats) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int b = blockIdx.y;
  if (i >= static_cast<long long>(m) * c) return;
  const int row = static_cast<int>(i / c);
  const int ch = static_cast<int>(i - static_cast<long long>(row) * c);
  const int key = keys[static_cast<long long>(b) * m + row];
  const long long hw = static_cast<long long>(h) * w;
  float v = 0.0f;
  if (key != kInvalidKey && key >= 0 && key < d * hw) {
    const int x = key % w;
    const int y = (key / w) % h;
    const int z = static_cast<int>(key / hw);
    v = d_canvas[((static_cast<long long>(b) * d + z) * c + ch) * hw +
                 static_cast<long long>(y) * w + x];
  }
  d_feats[(static_cast<long long>(b) * m + row) * c + ch] = v;
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
  const long long n = static_cast<long long>(m) * c;
  if (batch > 0 && n > 0) {
    const int threads = 256;
    const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads),
                    batch);
    densify_bwd_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        keys, d_canvas, m, c, d, h, w, d_feats);
  }
  return static_cast<int>(cudaGetLastError());
}
