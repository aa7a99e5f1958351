// K7: the active output set of a stride-2, kernel-3, pad-1 sparse conv.
//
// Replaces: sassd_tpu/ops/sparse.py _downsample_candidates, _unique_sorted
// and downsample_keys (the sort-based, key-sorted device downsample), with
// the optional per-row output-y limit `y_limit_out` of the banded sparse
// stage (B9': backbone.vxnet_apply(y_top=...)).
//
// Input voxel coordinate i feeds outputs o with 2o - 1 <= i <= 2o + 1, so
// per axis o is i // 2 or (i + 1) // 2: at most 8 parents per voxel, cut
// at the output grid's upper edge; with a limit array, a parent at output
// y >= min(y_limit[b], oh) is cut too (a band whose grid runs past the
// global grid's top clips there, as the replicated grid does; without the
// array the candidates are those of the unlimited kernel, bit for bit).
// The output level is the sorted union of
// the parents, capped at `cap` rows: the lowest keys win the cap, the tail
// is INVALID_KEY. This equals the C++ host rulebook's level arrays.
//
// Two kernels around a stock sort (torch.sort, as the TPU version uses
// jnp.sort): `candidates` writes the [B, 8 * M] parent keys (INVALID_KEY
// where the voxel is padding or the parent is off the grid); `unique`
// takes the sorted candidates of one sample per block, marks the first of
// each run of equal valid keys, ranks the marks with a block-wide scan and
// writes each marked key to its rank if the rank is below the cap.
//
// Bound on the H100: latency. 8 x 20000 candidates at L0 are 640 KB; the
// sort dominates. One block of 1024 threads per sample walks 160k sorted
// keys in contiguous chunks of ~157, so the scan is one pass of counts,
// one block scan of 1024 partial sums and one pass of writes, with no
// atomics and a deterministic result.
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;
constexpr int kUniqueThreads = 1024;

__global__ void candidates_kernel(const int* __restrict__ keys, int m, int h,
                                  int w, int od, int oh, int ow,
                                  const int* __restrict__ y_limit,
                                  int* __restrict__ cands) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= m) return;
  const int y_hi = y_limit != nullptr ? min(y_limit[b], oh) : oh;
  const int key = keys[static_cast<long long>(b) * m + row];
  int* cb = cands + static_cast<long long>(b) * 8 * m + row;
  if (key == kInvalidKey) {
    for (int s = 0; s < 8; ++s) cb[static_cast<long long>(s) * m] = kInvalidKey;
    return;
  }
  const int x = key % w;
  const int y = (key / w) % h;
  const int z = key / (w * h);
  for (int s = 0; s < 8; ++s) {           // (sz, sy, sx) row-major
    const int cz = (s & 4) ? (z + 1) / 2 : z / 2;
    const int cy = (s & 2) ? (y + 1) / 2 : y / 2;
    const int cx = (s & 1) ? (x + 1) / 2 : x / 2;
    const bool ok = cz < od && cy < y_hi && cx < ow;
    cb[static_cast<long long>(s) * m] = ok ? (cz * oh + cy) * ow + cx
                                           : kInvalidKey;
  }
}

__device__ __forceinline__ bool is_first(const int* s, int i) {
  return s[i] != kInvalidKey && (i == 0 || s[i] != s[i - 1]);
}

__global__ void __launch_bounds__(kUniqueThreads)
unique_kernel(const int* __restrict__ sorted, int n, int cap,
              int* __restrict__ out) {
  __shared__ int warp_sums[kUniqueThreads / 32];
  const int b = blockIdx.x;
  const int* s = sorted + static_cast<long long>(b) * n;
  int* o = out + static_cast<long long>(b) * cap;
  const int tid = threadIdx.x;
  const int chunk = (n + kUniqueThreads - 1) / kUniqueThreads;
  const int lo = min(tid * chunk, n);
  const int hi = min(lo + chunk, n);
  int count = 0;
  for (int i = lo; i < hi; ++i) count += is_first(s, i) ? 1 : 0;

  // block-wide inclusive scan of the per-thread counts
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int v = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = warp_sums[lane];              // kUniqueThreads / 32 == 32 warps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    warp_sums[lane] = t;
  }
  __syncthreads();
  int rank = v - count + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[kUniqueThreads / 32 - 1];

  for (int i = lo; i < hi && rank < cap; ++i) {
    if (is_first(s, i)) {
      o[rank] = s[i];
      ++rank;
    }
  }
  for (int i = total + tid; i < cap; i += kUniqueThreads) o[i] = kInvalidKey;
}

}  // namespace

// keys [batch, m] int32 on the input grid (d, h, w); y_limit [batch] int32
// exclusive output-y bounds, or null for none; cands [batch, 8 * m] int32 on
// the output grid (od, oh, ow).
extern "C" int sassd_downsample_candidates(const int* keys, int batch, int m,
                                           int h, int w, int od, int oh,
                                           int ow, const int* y_limit,
                                           int* cands, void* stream) {
  if (batch > 0 && m > 0) {
    const int threads = 256;
    const dim3 grid((m + threads - 1) / threads, batch);
    candidates_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        keys, m, h, w, od, oh, ow, y_limit, cands);
  }
  return static_cast<int>(cudaGetLastError());
}

// sorted [batch, n] int32 ascending per sample; out [batch, cap] int32.
extern "C" int sassd_unique_sorted(const int* sorted, int batch, int n,
                                   int cap, int* out, void* stream) {
  if (batch > 0 && cap > 0) {
    unique_kernel<<<batch, kUniqueThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(sorted, n, cap, out);
  }
  return static_cast<int>(cudaGetLastError());
}
