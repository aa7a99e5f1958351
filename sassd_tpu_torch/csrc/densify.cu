// K5: scatter of the last sparse level into the dense tail's NCHW canvas.
//
// Replaces: sassd_tpu/ops/sparse.py to_dense (twice: features and
// occupancy) and the d-major transpose of sassd_tpu/models/backbone.py
// densify_bev / the dense-tail entry (channel z * C + c).
//
// Row m of sample b with key (z * H + y) * W + x writes feats[b, m, c] to
// canvas[b, z * C + c, y, x] for every c, and 1 to occ[b, z, 0, y, x].
// INVALID_KEY padding rows (and any key outside the grid) write nothing.
// The caller zeroes both outputs; keys are unique, so the result does not
// depend on the order of the writes and the card check is bitwise.
//
// Bound on the H100: bytes. At the car config 10240 rows x 64 channels are
// 2.6 MB read and written once; the canvas ([5 * 64, 200, 176], 45 MB) is
// only zeroed. Design: one thread per (row, channel); consecutive threads
// read consecutive channels of a row, so the reads are coalesced, while the
// writes land H * W floats apart. The plain version instead builds an
// NDHWC canvas and then copies it through a permute; this pass writes the
// NCHW layout the convolutions read directly.
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;

__global__ void densify_kernel(const int* __restrict__ keys,
                               const float* __restrict__ feats, int m, int c,
                               int d, int h, int w,
                               float* __restrict__ canvas,
                               float* __restrict__ occ) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int b = blockIdx.y;
  if (i >= static_cast<long long>(m) * c) return;
  const int row = static_cast<int>(i / c);
  const int ch = static_cast<int>(i - static_cast<long long>(row) * c);
  const int key = keys[static_cast<long long>(b) * m + row];
  const long long hw = static_cast<long long>(h) * w;
  if (key == kInvalidKey || key < 0 || key >= d * hw) return;
  const int x = key % w;
  const int y = (key / w) % h;
  const int z = static_cast<int>(key / hw);
  const long long pix = static_cast<long long>(y) * w + x;
  canvas[((static_cast<long long>(b) * d + z) * c + ch) * hw + pix] =
      feats[(static_cast<long long>(b) * m + row) * c + ch];
  if (ch == 0) occ[(static_cast<long long>(b) * d + z) * hw + pix] = 1.0f;
}

}  // namespace

// keys [batch, m] int32; feats [batch, m, c] float32; canvas
// [batch, d * c, h, w] and occ [batch, d, 1, h, w] float32, zeroed.
extern "C" int sassd_densify(const int* keys, const float* feats, int batch,
                             int m, int c, int d, int h, int w,
                             float* canvas, float* occ, void* stream) {
  const long long n = static_cast<long long>(m) * c;
  if (batch > 0 && n > 0) {
    const int threads = 256;
    const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads),
                    batch);
    densify_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, feats, m, c, d, h, w, canvas, occ);
  }
  return static_cast<int>(cudaGetLastError());
}
