// K11: ring 3-NN feature interpolation of the aux branch, forward and
// backward.
//
// Replaces: sassd_tpu/ops/interpolate.py neighborhood_interpolate_cells
// (B13, aux_interp="ring") and its autodiff transpose.
//
// For query n of sample b (an input-voxel centroid q with level-0 cell
// (z, y, x)), tap k of the host rulebook's aux plan names the level-L row
// of the cell ((z, y, x) >> L) + off_k, off_k = (dz, dy, dx) row-major over
// {-1, 0, 1}, or -1 where that cell is inactive. The candidate centre is
// ((cell + 0.5) * vs + pcr) in xyz, its squared distance d2 (1e10 where the
// tap is missing); the 3 smallest d2 win (the lower tap on ties, as
// lax.top_k), w_i = 1 / (d2_i + 1e-8) for found winners (0 otherwise),
// normalised by their sum, and out = sum_i w_i * feats[row_i]. The float32
// operations and their order are those of the plain version
// (ops/interpolate.py), so with -fmad=false the output, the rows and the
// weights are bitwise equal to it.
//
// Bound on the H100: bytes. At the car config a level holds 2 x 20,000
// queries; the forward reads their plans (27 x 2 bytes each), centroids and
// cells, and 3 feature rows (C = 32 or 64 floats), and writes C floats:
// ~1 KB a query, ~40 MB in all, ~12 us at 3.35 TB/s. Design: a thread
// selects the 3 winners of its query; then the warp walks its 32 queries
// and spreads each one's channels over the lanes (shuffled rows and
// weights), so feature reads and writes are coalesced. The selected rows
// and weights are kept for the backward, which adds w_i * d_out into
// d_feats[row_i] with atomicAdd (their order changes from run to run).
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e10f;

template <typename IdxT>
__global__ void ring_interp_fwd_kernel(
    const float* __restrict__ query, const int* __restrict__ cell0,
    const IdxT* __restrict__ plan, int batch, int n, int level,
    const float* __restrict__ feats, int m, int c, float vsx, float vsy,
    float vsz, float px, float py, float pz, float* __restrict__ out,
    int* __restrict__ rows, float* __restrict__ weights) {
  const int lane = threadIdx.x & 31;
  const int total = batch * n;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int r[3] = {0, 0, 0};
  float w[3] = {0.0f, 0.0f, 0.0f};
  if (q < total) {
    const int b = q / n;
    const int i = q - b * n;
    const float qx = query[3LL * q], qy = query[3LL * q + 1],
                qz = query[3LL * q + 2];
    const int cz = cell0[3LL * q] >> level, cy = cell0[3LL * q + 1] >> level,
              cx = cell0[3LL * q + 2] >> level;
    const IdxT* pb = plan + static_cast<long long>(b) * 27 * n + i;
    float best[3] = {3e38f, 3e38f, 3e38f};
    int tap[3] = {0, 0, 0};
    int found[3] = {0, 0, 0};
    int idx[3] = {0, 0, 0};
    for (int k = 0; k < 27; ++k) {
      const int p = static_cast<int>(pb[static_cast<long long>(k) * n]);
      const float ex = (static_cast<float>(cx + k % 3 - 1) + 0.5f) * vsx + px;
      const float ey =
          (static_cast<float>(cy + (k / 3) % 3 - 1) + 0.5f) * vsy + py;
      const float ez = (static_cast<float>(cz + k / 9 - 1) + 0.5f) * vsz + pz;
      const float dx = ex - qx, dy = ey - qy, dz = ez - qz;
      const float d2 = p >= 0 ? dx * dx + dy * dy + dz * dz : kBig;
      // insertion keeping ascending d2; strict < keeps the lower tap first
      if (d2 < best[2]) {
        int pos = 2;
        if (d2 < best[1]) pos = 1;
        if (d2 < best[0]) pos = 0;
        for (int j = 2; j > pos; --j) {
          best[j] = best[j - 1];
          tap[j] = tap[j - 1];
          found[j] = found[j - 1];
          idx[j] = idx[j - 1];
        }
        best[pos] = d2;
        tap[pos] = k;
        found[pos] = p >= 0;
        idx[pos] = p >= 0 ? p : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[j] = found[j] ? 1.0f / (best[j] + 1e-8f) : 0.0f;
      r[j] = b * m + idx[j];
    }
    const float denom = w[0] + w[1] + w[2];
    const float safe = denom > 0.0f ? denom : 1.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[j] = w[j] / safe;
      rows[3LL * q + j] = r[j];
      weights[3LL * q + j] = w[j];
    }
  }
  const int q0 = q - lane;
  for (int j = 0; j < 32; ++j) {
    const int qj = q0 + j;
    if (qj >= total) break;                        // warp-uniform
    const int r0 = __shfl_sync(0xffffffffu, r[0], j);
    const int r1 = __shfl_sync(0xffffffffu, r[1], j);
    const int r2 = __shfl_sync(0xffffffffu, r[2], j);
    const float w0 = __shfl_sync(0xffffffffu, w[0], j);
    const float w1 = __shfl_sync(0xffffffffu, w[1], j);
    const float w2 = __shfl_sync(0xffffffffu, w[2], j);
    for (int ch = lane; ch < c; ch += 32) {
      out[static_cast<long long>(qj) * c + ch] =
          feats[static_cast<long long>(r0) * c + ch] * w0 +
          feats[static_cast<long long>(r1) * c + ch] * w1 +
          feats[static_cast<long long>(r2) * c + ch] * w2;
    }
  }
}

__global__ void ring_interp_bwd_kernel(const float* __restrict__ d_out,
                                       const int* __restrict__ rows,
                                       const float* __restrict__ weights,
                                       int total, int c,
                                       float* __restrict__ d_feats) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int r[3] = {0, 0, 0};
  float w[3] = {0.0f, 0.0f, 0.0f};
  if (q < total) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[j] = rows[3LL * q + j];
      w[j] = weights[3LL * q + j];
    }
  }
  const int q0 = q - lane;
  for (int j = 0; j < 32; ++j) {
    const int qj = q0 + j;
    if (qj >= total) break;                        // warp-uniform
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int rt = __shfl_sync(0xffffffffu, r[t], j);
      const float wt = __shfl_sync(0xffffffffu, w[t], j);
      if (wt == 0.0f) continue;                    // warp-uniform
      for (int ch = lane; ch < c; ch += 32) {
        atomicAdd(d_feats + static_cast<long long>(rt) * c + ch,
                  wt * d_out[static_cast<long long>(qj) * c + ch]);
      }
    }
  }
}

}  // namespace

// query [batch * n, 3] float32 xyz; cell0 [batch * n, 3] int32 zyx (-1
// padding); plan [batch, 27, n] int16 (plan_is_i16 != 0) or int32, rows
// into each sample's m feature rows; feats [batch * m, c] float32; vs and
// pc the level's voxel size and the grid origin, xyz. Writes out [batch *
// n, c], rows [batch * n, 3] (flat feature rows) and weights [batch * n, 3].
extern "C" int sassd_ring_interp_fwd(const float* query, const int* cell0,
                                     const void* plan, int plan_is_i16,
                                     int batch, int n, int level,
                                     const float* feats, int m, int c,
                                     float vsx, float vsy, float vsz,
                                     float px, float py, float pz, float* out,
                                     int* rows, float* weights,
                                     void* stream) {
  const int total = batch * n;
  if (total > 0) {
    const int threads = 128;
    const int blocks = (total + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (plan_is_i16) {
      ring_interp_fwd_kernel<short><<<blocks, threads, 0, s>>>(
          query, cell0, static_cast<const short*>(plan), batch, n, level,
          feats, m, c, vsx, vsy, vsz, px, py, pz, out, rows, weights);
    } else {
      ring_interp_fwd_kernel<int><<<blocks, threads, 0, s>>>(
          query, cell0, static_cast<const int*>(plan), batch, n, level,
          feats, m, c, vsx, vsy, vsz, px, py, pz, out, rows, weights);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// d_out [total, c]; rows, weights [total, 3] from the forward; d_feats
// [batch * m, c] float32, zeroed by the caller.
extern "C" int sassd_ring_interp_bwd(const float* d_out, const int* rows,
                                     const float* weights, int total, int c,
                                     float* d_feats, void* stream) {
  if (total > 0) {
    const int threads = 128;
    const int blocks = (total + threads - 1) / threads;
    ring_interp_bwd_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        d_out, rows, weights, total, c, d_feats);
  }
  return static_cast<int>(cudaGetLastError());
}
