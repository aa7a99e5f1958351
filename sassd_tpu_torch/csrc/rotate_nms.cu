// K2: exact greedy rotated NMS keep flags from K1's IoU matrix.
//
// Replaces: sassd_tpu/core/riou.py rotate_nms + _fixpoint_keep (the TPU
// version iterates a [N, N] masked reduction to the greedy fixpoint).
//
// Input: iou [N, N] float32 over score-sorted boxes, iou[i, j] = IoU with
// box i as K1's subject (a) and box j as the clip box (b); keep0 [N] (valid
// and finite score). Output: keep [N], exact greedy: box c is dropped when
// a kept box r < c has iou[c, r] > thr (strict), the orientation the JAX
// path uses (the later box is the subject).
//
// Bound on the H100: latency. The mask pass reads 4*N^2 bytes (16 MB at
// N = 2000) once, a few microseconds; the sweep is inherently serial over
// the N rows. Design: the mask kernel packs `iou > thr` for c > r into a
// [N, ceil(N/64)] uint64 bitmask, one thread per (row, 64-column block),
// threads on consecutive rows reading consecutive addresses. The sweep is
// one block that walks the rows in score order with the running
// "removed" bits and the keep0 flags in shared memory and ORs in the mask
// row of each kept box; no mask travels to the host.
// The mask kernel reads K1's matrix rather than evaluating the overlap for
// c > r itself, as the JAX path computes the matrix and then the fixpoint.
// The keep flags are then a function of the matrix alone, so they can be
// held bit for bit against the plain greedy on the same matrix; a fused
// mask kernel would save half of K1's pairs and the 16 MB round trip,
// roughly 0.07 ms of an H100's time at N = 2000.
#include <cuda_runtime.h>

namespace {

__global__ void nms_mask_kernel(const float* __restrict__ iou, int n,
                                float thr, int col_blocks,
                                unsigned long long* __restrict__ mask) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int cb = blockIdx.y;
  if (r >= n) return;
  unsigned long long bits = 0ull;
  const int c0 = cb * 64;
  for (int t = 0; t < 64; ++t) {
    const int c = c0 + t;
    if (c < n && c > r &&
        iou[static_cast<long long>(c) * n + r] > thr) {
      bits |= 1ull << t;
    }
  }
  mask[static_cast<long long>(r) * col_blocks + cb] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const unsigned char* __restrict__ keep0,
                                 int n, int col_blocks,
                                 unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                      // [col_blocks]
  unsigned char* cand = reinterpret_cast<unsigned char*>(smem + col_blocks);
  for (int c = threadIdx.x; c < col_blocks; c += blockDim.x) removed[c] = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cand[i] = keep0[i];
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int w = i >> 6;
    const bool k = cand[i] && !((removed[w] >> (i & 63)) & 1ull);
    __syncthreads();  // every thread has read removed[w] before it changes
    if (k) {
      const unsigned long long* row =
          mask + static_cast<long long>(i) * col_blocks;
      for (int c = w + threadIdx.x; c < col_blocks; c += blockDim.x) {
        removed[c] |= row[c];
      }
    }
    if (threadIdx.x == 0) keep[i] = k ? 1 : 0;
    __syncthreads();
  }
}

}  // namespace

// mask: caller-allocated scratch of n * ceil(n/64) uint64.
extern "C" int sassd_nms_keep(const float* iou, const unsigned char* keep0,
                              int n, float thr, unsigned long long* mask,
                              unsigned char* keep, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int col_blocks = (n + 63) / 64;
    const int threads = 128;
    const dim3 grid((n + threads - 1) / threads, col_blocks);
    nms_mask_kernel<<<grid, threads, 0, s>>>(iou, n, thr, col_blocks, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = sizeof(unsigned long long) * col_blocks + n;
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    nms_sweep_kernel<<<1, 64, smem, s>>>(mask, keep0, n, col_blocks, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
