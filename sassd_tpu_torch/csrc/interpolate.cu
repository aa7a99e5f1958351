// K11: ring 3-NN feature interpolation of the aux branch, forward and
// backward. K15: the exact 3-NN forward (aux_interp="exact"), whose
// backward is K11's.
//
// Replaces: sassd_tpu/ops/interpolate.py neighborhood_interpolate_cells
// (B13, aux_interp="ring") and its autodiff transpose, also with a grid
// origin per sample row (B13': the banded stage's per-band origins,
// sassd_tpu/parallel/sparse_spatial.py _banded_aux); K15
// three_nn_interpolate (B13, aux_interp="exact").
//
// For query n of sample b (an input-voxel centroid q with level-0 cell
// (z, y, x)), tap k of the host rulebook's aux plan names the level-L row
// of the cell ((z, y, x) >> L) + off_k, off_k = (dz, dy, dx) row-major over
// {-1, 0, 1}, or -1 where that cell is inactive. The candidate centre is
// ((cell + 0.5) * vs + pcr) in xyz (pcr: the one grid origin, or row b's
// of the [batch, 3] origins), its squared distance d2 (1e10 where the
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
//
// K15, exact 3-NN: query u of sample b against every known point k of the
// sample's level (M_L rows, validity v_k): d2 = max((u2 + k2) - 2 * dot, 0)
// + (v_k ? 0 : 1e10), with u2 = (ux*ux + uy*uy) + uz*uz, k2 likewise and
// dot = (ux*kx + uy*ky) + uz*kz (the JAX package's expanded form; the plain
// version computes it in this order, so with -fmad=false the selections
// are bitwise equal); the 3 smallest d2 win, the lower index on ties
// (lax.top_k's order); w_i = 1 / (d2_i + 1e-8) normalised by (w_0 + w_1) +
// w_2, every winner weighted (a padded known row weighs ~1e-10, as in
// JAX); out = sum_i w_i * feats[row_i]. The gradient goes to the features
// only, so the backward is K11's scatter of w_i * d_out.
// Bound on the H100: operations. At the car config level 1 has 2 x 20,000
// queries against 18,432 known rows: 737M pairs of ~12 float32 operations
// and a compare, ~0.13 ms at 67 TFLOP/s. Design: a thread per query keeps
// its top 3 by insertion with strict <; the block stages tiles of the known
// points (x, y, z, k2 and the validity bias, computed once per tile) in
// shared memory, which every thread reads at the same address (a
// broadcast); then the warp gathers the winners' features as K11 does.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e10f;

// out[q] = sum_i w_i * feats[rows_i] for the warp's 32 consecutive queries
// (flat rows below `total`), each query's channels spread over the lanes;
// r and w are this lane's query's winners.
__device__ void warp_gather_sum(const float* __restrict__ feats, int c,
                                const int r[3], const float w[3], int q,
                                int total, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
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

template <typename IdxT>
__global__ void ring_interp_fwd_kernel(
    const float* __restrict__ query, const int* __restrict__ cell0,
    const IdxT* __restrict__ plan, int batch, int n, int level,
    const float* __restrict__ feats, int m, int c, float vsx, float vsy,
    float vsz, float px, float py, float pz,
    const float* __restrict__ origins, float* __restrict__ out,
    int* __restrict__ rows, float* __restrict__ weights) {
  const int total = batch * n;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int r[3] = {0, 0, 0};
  float w[3] = {0.0f, 0.0f, 0.0f};
  if (q < total) {
    const int b = q / n;
    const int i = q - b * n;
    if (origins != nullptr) {
      px = origins[3 * b];
      py = origins[3 * b + 1];
      pz = origins[3 * b + 2];
    }
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
  warp_gather_sum(feats, c, r, w, q, total, out);
}

constexpr int kTile = 1024;

// grid (ceil(n / 128), batch), 128 threads: a block's queries belong to one
// sample and share its known tiles.
__global__ void three_nn_fwd_kernel(
    const float* __restrict__ query, int n, const float* __restrict__ known,
    const unsigned char* __restrict__ kvalid, int m,
    const float* __restrict__ feats, int c, float* __restrict__ out,
    int* __restrict__ rows, float* __restrict__ weights) {
  __shared__ float4 s_k[kTile];                    // x, y, z, k2
  __shared__ float s_bias[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const int q = b * n + i;
  float ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (active) {
    ux = query[3LL * q];
    uy = query[3LL * q + 1];
    uz = query[3LL * q + 2];
  }
  const float u2 = ux * ux + uy * uy + uz * uz;
  float best[3] = {3.4e38f, 3.4e38f, 3.4e38f};
  int idx[3] = {0, 0, 0};
  const float* kb = known + 3LL * b * m;
  const unsigned char* vb = kvalid + static_cast<long long>(b) * m;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const float kx = kb[3LL * (t0 + j)], ky = kb[3LL * (t0 + j) + 1],
                  kz = kb[3LL * (t0 + j) + 2];
      s_k[j] = make_float4(kx, ky, kz, kx * kx + ky * ky + kz * kz);
      s_bias[j] = vb[t0 + j] ? 0.0f : kBig;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < len; ++j) {
        const float4 k = s_k[j];
        const float dot = ux * k.x + uy * k.y + uz * k.z;
        float d2 = (u2 + k.w) - 2.0f * dot;
        d2 = (d2 < 0.0f ? 0.0f : d2) + s_bias[j];
        // insertion keeping ascending d2; strict < keeps the lower index
        if (d2 < best[2]) {
          const int kk = t0 + j;
          if (d2 < best[1]) {
            best[2] = best[1];
            idx[2] = idx[1];
            if (d2 < best[0]) {
              best[1] = best[0];
              idx[1] = idx[0];
              best[0] = d2;
              idx[0] = kk;
            } else {
              best[1] = d2;
              idx[1] = kk;
            }
          } else {
            best[2] = d2;
            idx[2] = kk;
          }
        }
      }
    }
  }
  int r[3] = {0, 0, 0};
  float w[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[j] = 1.0f / (best[j] + 1e-8f);
      r[j] = b * m + idx[j];
    }
    const float denom = w[0] + w[1] + w[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[j] = w[j] / denom;
      rows[3LL * q + j] = r[j];
      weights[3LL * q + j] = w[j];
    }
  }
  // the warp's queries are consecutive rows of sample b (n rows from b * n)
  warp_gather_sum(feats, c, r, w, q, b * n + n, out);
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
// pc the level's voxel size and the grid origin, xyz, or origins [batch, 3]
// float32 xyz, one origin per sample row (then pc is not read). Writes out
// [batch * n, c], rows [batch * n, 3] (flat feature rows) and weights
// [batch * n, 3].
extern "C" int sassd_ring_interp_fwd(const float* query, const int* cell0,
                                     const void* plan, int plan_is_i16,
                                     int batch, int n, int level,
                                     const float* feats, int m, int c,
                                     float vsx, float vsy, float vsz,
                                     float px, float py, float pz,
                                     const float* origins, float* out,
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
          feats, m, c, vsx, vsy, vsz, px, py, pz, origins, out, rows,
          weights);
    } else {
      ring_interp_fwd_kernel<int><<<blocks, threads, 0, s>>>(
          query, cell0, static_cast<const int*>(plan), batch, n, level,
          feats, m, c, vsx, vsy, vsz, px, py, pz, origins, out, rows,
          weights);
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

// query [batch * n, 3] float32 xyz; known [batch * m, 3] float32 xyz with
// validity kvalid [batch * m] (bool bytes); feats [batch * m, c] float32.
// Writes out [batch * n, c], rows [batch * n, 3] (flat feature rows, the
// input of sassd_ring_interp_bwd) and weights [batch * n, 3].
extern "C" int sassd_three_nn_fwd(const float* query, int batch, int n,
                                  const float* known,
                                  const unsigned char* kvalid, int m,
                                  const float* feats, int c, float* out,
                                  int* rows, float* weights, void* stream) {
  if (batch > 0 && n > 0 && m > 0) {
    const int threads = 128;
    const dim3 grid((n + threads - 1) / threads, batch);
    three_nn_fwd_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        query, n, known, kvalid, m, feats, c, out, rows, weights);
  }
  return static_cast<int>(cudaGetLastError());
}
