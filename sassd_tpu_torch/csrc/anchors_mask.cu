// K9: the anchors mask of device-resident serving: a BEV occupancy
// integral image and a 4-corner box sum per anchor.
//
// Replaces: sassd_tpu/serve.py _integral_image + anchors_mask_jax and
// anchors_mask_jax_separable (B7).
//
// Step 1 (scatter): cudaMemsetAsync zeroes the [B, H, W] float32 grid and
// one thread per voxel row adds 1 at (y, x) with atomicAdd; padding rows
// (z < 0) are dropped. Step 2 (scan): the inclusive integral image, a scan
// along each row, then along each column. A block owns 32 lines; each line
// is cut into 32 chunks, one thread per (line, chunk): the thread sums its
// chunk, the 32 chunk sums of a line are scanned in shared memory, and the
// thread writes its chunk's running sums. For the column scan the 32 lines
// of a block are adjacent columns, so a warp's loads coalesce. Step 3
// (mask): one thread per (sample, anchor) reads the anchor's static corner
// cells (x0, y0, x1, y1) and writes area > threshold, area =
// I[y1, x1] - I[y0, x1] - I[y1, x0] + I[y0, x0].
//
// Every sum is a count of voxels (at most 20,000 < 2^24), so float32 holds
// it exactly in any order: atomics and the chunked scan give the plain
// version's bits. Bound on the H100: bytes and latency. The car grid is
// 1600 x 1408 = 2.25M cells (9 MB), read and written once per scan; the
// mask reads 4 cells for each of 70,400 anchors.
#include <cuda_runtime.h>

namespace {

constexpr int kLines = 32;     // lines per block (threadIdx.x)
constexpr int kChunks = 32;    // chunks per line (threadIdx.y)

__global__ void scatter_kernel(const int* __restrict__ coords, int v, int h,
                               int w, float* __restrict__ grid) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= v) return;
  const int* c = coords + (static_cast<long long>(b) * v + row) * 3;
  if (c[0] < 0) return;
  atomicAdd(grid + (static_cast<long long>(b) * h + c[1]) * w + c[2], 1.0f);
}

// Inclusive scan of n_lines lines of `len` elements each; element e of line
// l is at grid[b * plane + l * line_stride + e * elem_stride].
__global__ void __launch_bounds__(kLines * kChunks)
scan_kernel(float* __restrict__ grid, long long plane, int n_lines, int len,
            int line_stride, int elem_stride) {
  __shared__ float sums[kChunks][kLines + 1];
  const int line = blockIdx.x * kLines + threadIdx.x;
  const int ch = threadIdx.y;
  const int chunk = (len + kChunks - 1) / kChunks;
  const int lo = min(ch * chunk, len);
  const int hi = min(lo + chunk, len);
  float* base = grid + blockIdx.y * plane +
                static_cast<long long>(line) * line_stride;
  float s = 0.0f;
  if (line < n_lines) {
    for (int e = lo; e < hi; ++e)
      s += base[static_cast<long long>(e) * elem_stride];
  }
  sums[ch][threadIdx.x] = s;
  __syncthreads();
  if (ch == 0) {                            // exclusive scan over chunks
    float run = 0.0f;
    for (int k = 0; k < kChunks; ++k) {
      const float t = sums[k][threadIdx.x];
      sums[k][threadIdx.x] = run;
      run += t;
    }
  }
  __syncthreads();
  if (line >= n_lines) return;
  float run = sums[ch][threadIdx.x];
  for (int e = lo; e < hi; ++e) {
    float* q = base + static_cast<long long>(e) * elem_stride;
    run += *q;
    *q = run;
  }
}

__global__ void mask_kernel(const float* __restrict__ integral,
                            const int* __restrict__ corners, int a, int h,
                            int w, float threshold,
                            unsigned char* __restrict__ mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= a) return;
  const int4 c = reinterpret_cast<const int4*>(corners)[i];  // x0 y0 x1 y1
  const float* g = integral + static_cast<long long>(b) * h * w;
  const float area = g[c.w * w + c.z] - g[c.y * w + c.z] -
                     g[c.w * w + c.x] + g[c.y * w + c.x];
  mask[static_cast<long long>(b) * a + i] = area > threshold ? 1 : 0;
}

}  // namespace

// coords [batch, v, 3] int32 zyx (-1 rows = padding); grid [batch, h, w]
// float32, written whole: the integral image of the voxel counts.
extern "C" int sassd_integral_image(const int* coords, int batch, int v,
                                    int h, int w, float* grid,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const long long plane = static_cast<long long>(h) * w;
  cudaError_t err = cudaMemsetAsync(grid, 0, sizeof(float) * batch * plane,
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (v > 0) {
    const int threads = 256;
    scatter_kernel<<<dim3((v + threads - 1) / threads, batch), threads, 0,
                     s>>>(coords, v, h, w, grid);
  }
  const dim3 block(kLines, kChunks);
  // along each row (h lines of w elements), then each column
  scan_kernel<<<dim3((h + kLines - 1) / kLines, batch), block, 0, s>>>(
      grid, plane, h, w, w, 1);
  scan_kernel<<<dim3((w + kLines - 1) / kLines, batch), block, 0, s>>>(
      grid, plane, w, h, 1, w);
  return static_cast<int>(cudaGetLastError());
}

// integral [batch, h, w] float32; corners [a, 4] int32 (x0, y0, x1, y1),
// 16-byte aligned; mask [batch, a] bool (one byte each).
extern "C" int sassd_anchors_mask(const float* integral, const int* corners,
                                  int batch, int a, int h, int w,
                                  float threshold, unsigned char* mask,
                                  void* stream) {
  if (batch > 0 && a > 0) {
    const int threads = 256;
    mask_kernel<<<dim3((a + threads - 1) / threads, batch), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        integral, corners, a, h, w, threshold, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
