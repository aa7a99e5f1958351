// K8: device voxelization of raw padded point clouds (serving path).
//
// Replaces: sassd_tpu/ops/voxelize.py voxelize_jax (B6).
//
// Each valid point in range gets the linear key (z * gy + y) * gx + x of
// its cell, c = floor((p - pcr) / vs) per axis; invalid points (index >=
// n_points[b] or a cell off the grid) get INVALID_KEY. A stable sort of the
// keys (torch.sort, as the TPU version uses jnp.argsort) keeps scan order
// inside a cell, so a voxel's slots are first-come. The output keeps the
// max_voxels LOWEST keys, key-sorted: voxels [B, Vmax, T, F] (zero padded),
// coords [B, Vmax, 3] zyx int32 (-1 padded), num_points [B, Vmax].
//
// Three kernels around the sort:
// - keys: one thread per point. The quantisation is a float32 subtract, an
//   IEEE divide (__fdiv_rn, never a reciprocal multiply) and floorf, so a
//   point on a cell boundary lands in the cell the plain version and JAX
//   give it; the library is built with -fmad=false.
// - runs: one block of 1024 threads per sample walks the sorted keys in
//   contiguous chunks, counts run heads (first of each run of equal valid
//   keys), scans the counts and writes each head's index i to start[vox]
//   for vox <= Vmax; start[v] for v past the last voxel is the number of
//   valid points. This replaces the TPU version's associative max-scan:
//   slot = i - start[vox] and count = start[vox + 1] - start[vox].
// - write: one thread per (sample, voxel row, slot) copies point
//   perm[start[v] + t] when t < min(count, T), zero otherwise; slot 0 also
//   writes the row's count and its coords, decoded from the key.
//
// Bound on the H100: latency. 65,536 points are 1 MB in and the outputs
// 2.2 MB; the sort of 65,536 int32 keys dominates. Every value is a copy or
// an integer, so the result is bitwise equal to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;
constexpr int kRunThreads = 1024;

__global__ void keys_kernel(const float* __restrict__ points,
                            const int* __restrict__ n_points, int p, int f,
                            float pc0, float pc1, float pc2, float vs0,
                            float vs1, float vs2, int gx, int gy, int gz,
                            int* __restrict__ keys) {
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
  keys[row] = ok ? (cz * gy + cy) * gx + cx : kInvalidKey;
}

__device__ __forceinline__ bool is_head(const int* s, int i) {
  return s[i] != kInvalidKey && (i == 0 || s[i] != s[i - 1]);
}

__global__ void __launch_bounds__(kRunThreads)
runs_kernel(const int* __restrict__ sorted, int p, int vmax,
            int* __restrict__ start) {
  __shared__ int warp_sums[kRunThreads / 32];
  __shared__ int n_valid;
  const int b = blockIdx.x;
  const int* s = sorted + static_cast<long long>(b) * p;
  int* st = start + static_cast<long long>(b) * (vmax + 1);
  const int tid = threadIdx.x;
  if (tid == 0) n_valid = 0;
  const int chunk = (p + kRunThreads - 1) / kRunThreads;
  const int lo = min(tid * chunk, p);
  const int hi = min(lo + chunk, p);
  int heads = 0, valid = 0;
  for (int i = lo; i < hi; ++i) {
    heads += is_head(s, i) ? 1 : 0;
    valid += s[i] != kInvalidKey ? 1 : 0;
  }
  __syncthreads();                         // n_valid = 0 is visible
  atomicAdd(&n_valid, valid);

  // block-wide inclusive scan of the per-thread head counts
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int v = heads;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = warp_sums[lane];               // kRunThreads / 32 == 32 warps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    warp_sums[lane] = t;
  }
  __syncthreads();
  int vox = v - heads + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[kRunThreads / 32 - 1];

  for (int i = lo; i < hi && vox <= vmax; ++i) {
    if (is_head(s, i)) {
      st[vox] = i;
      ++vox;
    }
  }
  for (int r = total + tid; r <= vmax; r += kRunThreads) st[r] = n_valid;
}

__global__ void write_kernel(const float* __restrict__ points,
                             const long long* __restrict__ perm,
                             const int* __restrict__ sorted,
                             const int* __restrict__ start, int p, int f,
                             int vmax, int t_max, int gx, int gy,
                             float* __restrict__ voxels,
                             int* __restrict__ coords,
                             int* __restrict__ num_points) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (idx >= vmax * t_max) return;
  const int v = idx / t_max;
  const int t = idx - v * t_max;
  const int* st = start + static_cast<long long>(b) * (vmax + 1);
  const int s0 = st[v];
  const int n = min(st[v + 1] - s0, t_max);
  const long long vrow = static_cast<long long>(b) * vmax + v;
  float* out = voxels + (vrow * t_max + t) * f;
  if (t < n) {
    const long long src = perm[static_cast<long long>(b) * p + s0 + t];
    const float* pt = points + (static_cast<long long>(b) * p + src) * f;
    for (int c = 0; c < f; ++c) out[c] = pt[c];
  } else {
    for (int c = 0; c < f; ++c) out[c] = 0.0f;
  }
  if (t == 0) {
    num_points[vrow] = n;
    int* co = coords + vrow * 3;
    if (n > 0) {
      const int key = sorted[static_cast<long long>(b) * p + s0];
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
// keys [batch, p] int32.
extern "C" int sassd_voxel_keys(const float* points, const int* n_points,
                                int batch, int p, int f, float pc0, float pc1,
                                float pc2, float vs0, float vs1, float vs2,
                                int gx, int gy, int gz, int* keys,
                                void* stream) {
  if (batch > 0 && p > 0) {
    const int threads = 256;
    const dim3 grid((p + threads - 1) / threads, batch);
    keys_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        points, n_points, p, f, pc0, pc1, pc2, vs0, vs1, vs2, gx, gy, gz,
        keys);
  }
  return static_cast<int>(cudaGetLastError());
}

// sorted [batch, p] int32 ascending per sample; start [batch, vmax + 1].
extern "C" int sassd_voxel_runs(const int* sorted, int batch, int p,
                                int vmax, int* start, void* stream) {
  if (batch > 0) {
    runs_kernel<<<batch, kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        sorted, p, vmax, start);
  }
  return static_cast<int>(cudaGetLastError());
}

// perm [batch, p] int64 (the stable sort's indices); voxels
// [batch, vmax, t_max, f] float32; coords [batch, vmax, 3] and num_points
// [batch, vmax] int32.
extern "C" int sassd_voxel_write(const float* points, const long long* perm,
                                 const int* sorted, const int* start,
                                 int batch, int p, int f, int vmax, int t_max,
                                 int gx, int gy, float* voxels, int* coords,
                                 int* num_points, void* stream) {
  if (batch > 0 && vmax > 0) {
    const int threads = 256;
    const int n = vmax * t_max;
    const dim3 grid((n + threads - 1) / threads, batch);
    write_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        points, perm, sorted, start, p, f, vmax, t_max, gx, gy, voxels,
        coords, num_points);
  }
  return static_cast<int>(cudaGetLastError());
}
