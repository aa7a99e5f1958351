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
// queries; the forward reads their points, cells and plans (27 x 2 bytes)
// and each selected feature row once, and writes C floats and 3 rows and
// weights a query; the backward reads d_out, the rows and the weights and
// writes d_feats: 7-12 us a level at 3.35 TB/s (chip_smoke.py counts it
// from the run's data). A padded query (cell z < 0) needs only its cell
// and its output row; in the banded stage three quarters of the queries
// are padding.
//
// Design, a block of 64 queries (626 blocks at car level 1 balance the SMs
// better than 313 of 128, 4.7 a SM against 2.4; on the H100 that took the
// backward kernel at levels 2 and 3 from 0.0077-0.0090 to 0.0069-0.0080
// ms, chip_smoke.py):
// - selection, a thread a query: the 27 plan loads issued together, the
//   candidates' squared offsets computed once an axis (3 values each, the
//   float32 values the plain version computes per tap), every tap inserted
//   with selects. A padded query reads neither its plan nor its point:
//   every maker of the aux plans writes -1 for all 27 of its taps (K14
//   and the banded plans through it, the C++ host plans past the
//   voxelizer's compact rows; tests pin each), so its result is the
//   all-missing one, rows b * m and weights 0, whose output the gather
//   still computes as (f * 0 + f * 0) + f * 0 for the sign of each zero;
// - gather: the block's rows and weights staged in shared memory, threads
//   laid over flat (query, 4-channel group) items, 4 items a thread with
//   their 12 float4 loads in flight, float4 stores (single floats where
//   c % 4 != 0 or a pointer is not 16-byte aligned);
// - backward: the same items; d_out read only for a query with a nonzero
//   weight, one float4 atomicAdd (CUDA 12, sm_90) per nonzero weight, in an
//   order that changes from run to run; d_feats zeroed by a memset in the
//   same entry point.
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
// queries against 18,432 known rows: 737M pairs of 9 float32 operations
// (dot 5, u2 + k2, 2 * dot, the difference, the validity bias), ~0.10 ms
// at 67 TFLOP/s (a rate that counts an FMA as two). Built with -fmad=false
// each operation issues alone, and a pair also takes a compare and the
// bit it sets (and a quarter of a shared load): ~10 instructions a pair
// at 128 lanes x 132 SMs x 1.98 GHz gives an estimated floor of ~0.22 ms
// at level 1.
//
// Why the known rows may be split and visited in any order: the plain
// version's repeated first argmin (lax.top_k's lower index on ties)
// selects the 3 smallest (d2, index) pairs in lexicographic order, and
// every insertion here (bubble3) compares (d2, index) explicitly, so it
// keeps that top 3 whatever order the rows arrive in. The lexicographic top 3 of a
// union is the top 3 of the union of its parts' top 3s: an element of the
// global top 3 has at most 2 elements before it, so at most 2 in its own
// part. So each slice of the known rows keeps its own top 3, and a merge
// of the partials returns the same rows in the same order, and so the
// same weights, bit for bit.
//
// Why every part may start from the same 3 seed rows: a part's top 3 of
// its slice and the seeds still holds every global winner of its slice
// (at most 2 rows come before one anywhere), and the merge drops the
// seeds' copies (an entry equal to one kept is the same row). Seeds from
// a strided sample of the known rows and their neighbours in the known
// order (their d2 computed by the same float32 operations) sit near each
// query, so few rows of a slice beat them. Started from nothing, and in key order, the rows of a slice beat
// a query's third best a few times a row of cells as the scan nears it,
// and the insertion ran for most warps at most known points (on an H100
// the split search with a plain per-point branch was no faster than one
// thread a query).
//
// Design, three kernels in the one entry point:
// - seed: a block stages every ceil(M / 256)-th known row (at most 256);
//   four threads a query take the (d2, index) top 3 of a quarter each,
//   with selects and no branch, and merge them by shuffles; then the same
//   over those 3 and the 8 rows on each side of each of them in the
//   known order (which keeps a cell's x-neighbours there when the rows
//   are key-sorted); into a [B * N, 3] scratch;
// - search: grid (query tile, known slice, sample), 128 threads, 4 queries
//   a thread (512 a block, sassd_three_nn_queries_per_block); the wrapper
//   picks the slice count S that gives 4 blocks an SM (6 fit at once on
//   each), each slice of at least 256 rows.
//   A thread keeps the top 3 of each of its queries in registers, starting
//   from its seeds; one broadcast float4 load of a staged known point (x,
//   y, z, k2) feeds 4 pairs, 4 independent chains. For each chunk of 32
//   staged rows a query sets one bit per row whose unclamped difference is
//   at most its third best (a superset of the rows the insertion takes:
//   the clamp and the validity bias only raise d2), with no branch; then
//   it visits the set bits, computes d2 as the plain version does and
//   inserts, with selects. A tile's 16 chunks go in bit-reversed order, so that the
//   third best tightens before the scan walks up to the query. Slice-local
//   top 3s go to a [B, S, N, 3] scratch of (d2, index);
// - merge: one thread per query merges its S partials, weights the
//   winners as above and gathers their features as K11 does.
// Seed slots that no row fills (fewer than 3 known rows) stay (inf, 0),
// which weigh 0 (the plain version's argmin of an all-inf row is 0 as
// well).
#include <cuda_runtime.h>
#include <math.h>

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

constexpr int kRingQueries = 64;                   // a block: a thread each
constexpr int kRingUnroll = 4;                     // gather items in flight

// 16-byte alignment of a pointer (the float4 paths)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// four channels at once, each product and sum rounded on its own
__device__ __forceinline__ float4 mul4(float4 a, float w) {
  return make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The block's queries [q0, q0 + nq) gathered from their staged winners:
// out[q] = (f0 * w0 + f1 * w1) + f2 * w2 over flat (query, item) pairs, an
// item 4 channels (kVec) or one, kRingUnroll items a thread in flight.
template <bool kVec>
__device__ __forceinline__ void block_gather_sum(
    const float* __restrict__ feats, int c, int (*s_row)[kRingQueries],
    float (*s_w)[kRingQueries], long long q0, int nq,
    float* __restrict__ out) {
  const int per = kVec ? c >> 2 : c;               // items a query
  const int items = nq * per;
  for (int base = threadIdx.x; base < items;
       base += kRingQueries * kRingUnroll) {
    int lq[kRingUnroll], ch[kRingUnroll];
    float4 f[kRingUnroll][3];
#pragma unroll
    for (int u = 0; u < kRingUnroll; ++u) {
      const int it = base + u * kRingQueries;
      lq[u] = it / per;
      ch[u] = (it - lq[u] * per) * (kVec ? 4 : 1);
      if (it < items) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float* src = feats +
              static_cast<long long>(s_row[j][lq[u]]) * c + ch[u];
          f[u][j] = kVec ? *reinterpret_cast<const float4*>(src)
                         : make_float4(*src, 0.0f, 0.0f, 0.0f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRingUnroll; ++u) {
      if (base + u * kRingQueries < items) {
        const float4 v = add4(add4(mul4(f[u][0], s_w[0][lq[u]]),
                                   mul4(f[u][1], s_w[1][lq[u]])),
                              mul4(f[u][2], s_w[2][lq[u]]));
        float* dst = out + (q0 + lq[u]) * c + ch[u];
        if (kVec) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          *dst = v.x;
        }
      }
    }
  }
}

// One block of kRingQueries flat queries q = b * n + i. Selection, a
// thread a query: the 27 plan loads issued together, then the taps in
// order, each inserted with selects (strict <: the lower tap first on
// ties). A padded query (cell z < 0), whose plan every maker fills with
// -1, takes the all-missing result without reading its plan or point:
// taps 0-2, rows b * m, weights 0. Gather: the winners staged in shared
// memory, then block_gather_sum.
template <typename IdxT, bool kVec>
__global__ void __launch_bounds__(kRingQueries) ring_interp_fwd_kernel(
    const float* __restrict__ query, const int* __restrict__ cell0,
    const IdxT* __restrict__ plan, int batch, int n, int level,
    const float* __restrict__ feats, int m, int c, float vsx, float vsy,
    float vsz, float px, float py, float pz,
    const float* __restrict__ origins, float* __restrict__ out,
    int* __restrict__ rows, float* __restrict__ weights) {
  __shared__ int s_row[3][kRingQueries];
  __shared__ float s_w[3][kRingQueries];
  const int total = batch * n;
  const long long q0 = static_cast<long long>(blockIdx.x) * kRingQueries;
  const int q = static_cast<int>(q0) + threadIdx.x;
  if (q < total) {
    const int b = q / n;
    const int i = q - b * n;
    const int z0 = cell0[3LL * q];
    float best[3] = {3e38f, 3e38f, 3e38f};
    int val[3] = {-1, -1, -1};                    // plan entries, -1 missing
    if (z0 >= 0) {
      const IdxT* pb = plan + static_cast<long long>(b) * 27 * n + i;
      int p[27];
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        p[k] = static_cast<int>(pb[static_cast<long long>(k) * n]);
      }
      if (origins != nullptr) {
        px = origins[3 * b];
        py = origins[3 * b + 1];
        pz = origins[3 * b + 2];
      }
      const float qx = query[3LL * q], qy = query[3LL * q + 1],
                  qz = query[3LL * q + 2];
      const int cz = z0 >> level, cy = cell0[3LL * q + 1] >> level,
                cx = cell0[3LL * q + 2] >> level;
      // squared offsets of the 3 candidate centres on each axis, d - 1 .. 1
      float sx[3], sy[3], sz[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float dx = (static_cast<float>(cx + d - 1) + 0.5f) * vsx + px
                         - qx;
        const float dy = (static_cast<float>(cy + d - 1) + 0.5f) * vsy + py
                         - qy;
        const float dz = (static_cast<float>(cz + d - 1) + 0.5f) * vsz + pz
                         - qz;
        sx[d] = dx * dx;
        sy[d] = dy * dy;
        sz[d] = dz * dz;
      }
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const float d2 =
            p[k] >= 0 ? sx[k % 3] + sy[(k / 3) % 3] + sz[k / 9] : kBig;
        const bool a0 = d2 < best[0], a1 = d2 < best[1], a2 = d2 < best[2];
        best[2] = a1 ? best[1] : (a2 ? d2 : best[2]);
        val[2] = a1 ? val[1] : (a2 ? p[k] : val[2]);
        best[1] = a0 ? best[0] : (a1 ? d2 : best[1]);
        val[1] = a0 ? val[0] : (a1 ? p[k] : val[1]);
        best[0] = a0 ? d2 : best[0];
        val[0] = a0 ? p[k] : val[0];
      }
    }
    float w[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[j] = val[j] >= 0 ? 1.0f / (best[j] + 1e-8f) : 0.0f;
    }
    const float denom = w[0] + w[1] + w[2];
    const float safe = denom > 0.0f ? denom : 1.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int r = b * m + (val[j] >= 0 ? val[j] : 0);
      w[j] = w[j] / safe;
      rows[3LL * q + j] = r;
      weights[3LL * q + j] = w[j];
      s_row[j][threadIdx.x] = r;
      s_w[j][threadIdx.x] = w[j];
    }
  }
  __syncthreads();
  block_gather_sum<kVec>(feats, c, s_row, s_w, q0,
                         min(kRingQueries, total - static_cast<int>(q0)),
                         out);
}

// 6 blocks of 4 warps an SM: up to 80 registers a thread
constexpr int kNnThreads = 128;
constexpr int kNnQueries = 4;                      // a thread
constexpr int kNnTile = 512;                       // known rows staged
constexpr int kNnChunk = 32;                       // rows a filter mask
constexpr int kNnChunks = kNnTile / kNnChunk;      // 16 = 2^4
constexpr int kNnSample = 256;                     // rows of the seed
constexpr int kNnRefine = 8;                       // rows each side
constexpr int kNnBoundLanes = 4;                   // threads a query

// (d, k) carried down the (d2, index)-ordered triple, the smaller kept at
// each place: an insertion with selects and no branch
__device__ __forceinline__ void bubble3(float best[3], int idx[3], float d,
                                        int k) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float bd = best[j];
    const int bk = idx[j];
    const bool lt = (d < bd) | ((d == bd) & (k < bk));
    best[j] = lt ? d : bd;
    idx[j] = lt ? k : bk;
    d = lt ? bd : d;
    k = lt ? bk : k;
  }
}

// bubble3 of a row not yet kept (a kept copy goes in as inf, which stays
// out)
__device__ __forceinline__ void bubble3_new(float best[3], int idx[3],
                                            float d, int k) {
  const bool dup = ((k == idx[0]) & (d == best[0])) |
                   ((k == idx[1]) & (d == best[1])) |
                   ((k == idx[2]) & (d == best[2]));
  bubble3(best, idx, dup ? INFINITY : d, k);
}

// the kNnBoundLanes lanes' top 3s of one query merged by shuffles, in
// every one of them
__device__ __forceinline__ void merge_lanes(float best[3], int idx[3]) {
#pragma unroll
  for (int off = 1; off < kNnBoundLanes; off <<= 1) {
    float od[3];
    int ok[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      od[j] = __shfl_xor_sync(0xffffffffu, best[j], off);
      ok[j] = __shfl_xor_sync(0xffffffffu, idx[j], off);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) bubble3_new(best, idx, od[j], ok[j]);
  }
}

// grid (ceil(n * kNnBoundLanes / kNnThreads), batch), kNnBoundLanes
// neighbouring threads per query i of sample b: the (d2, index) top 3 of
// known rows 0, stride, 2 * stride, ... (at most kNnSample, staged once a
// block, a quarter a thread, the quarters merged by shuffles), then of
// those 3 and the rows within kNnRefine places of each of them (in key
// order a cell's x-neighbours), into seed[b * n + i] ((inf, 0) where
// there are fewer than 3 rows)
__global__ void three_nn_seed_kernel(const float* __restrict__ query, int n,
                                     const float* __restrict__ known,
                                     const unsigned char* __restrict__ kvalid,
                                     int m, int stride,
                                     float2* __restrict__ seed) {
  __shared__ float4 s_k[kNnSample];                // x, y, z, k2
  __shared__ float s_bias[kNnSample];
  const int b = blockIdx.y;
  const int count = (m + stride - 1) / stride;     // <= kNnSample
  const float* kb = known + 3LL * b * m;
  const unsigned char* vb = kvalid + static_cast<long long>(b) * m;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const long long k = static_cast<long long>(j) * stride;
    const float kx = kb[3 * k], ky = kb[3 * k + 1], kz = kb[3 * k + 2];
    s_k[j] = make_float4(kx, ky, kz, kx * kx + ky * ky + kz * kz);
    s_bias[j] = vb[k] ? 0.0f : kBig;
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / kNnBoundLanes;
  const bool active = i < n;
  const long long q = static_cast<long long>(b) * n + i;
  const float ux = active ? query[3 * q] : 0.0f;
  const float uy = active ? query[3 * q + 1] : 0.0f;
  const float uz = active ? query[3 * q + 2] : 0.0f;
  const float u2 = ux * ux + uy * uy + uz * uz;
  float best[3] = {INFINITY, INFINITY, INFINITY};
  int idx[3] = {0, 0, 0};
#pragma unroll 4
  for (int j = t % kNnBoundLanes; j < count; j += kNnBoundLanes) {
    const float4 k = s_k[j];
    const float dot = ux * k.x + uy * k.y + uz * k.z;
    const float d = (u2 + k.w) - 2.0f * dot;
    bubble3(best, idx, (d < 0.0f ? 0.0f : d) + s_bias[j], j * stride);
  }
  merge_lanes(best, idx);
  int near[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) near[j] = idx[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    for (int o = t % kNnBoundLanes - kNnRefine; o <= kNnRefine;
         o += kNnBoundLanes) {
      const int k = near[j] + o;
      if (k < 0 || k >= m) continue;
      const float kx = kb[3LL * k], ky = kb[3LL * k + 1], kz = kb[3LL * k + 2];
      const float k2 = kx * kx + ky * ky + kz * kz;
      const float dot = ux * kx + uy * ky + uz * kz;
      const float d = (u2 + k2) - 2.0f * dot;
      bubble3_new(best, idx, (d < 0.0f ? 0.0f : d) + (vb[k] ? 0.0f : kBig),
                  k);
    }
  }
  merge_lanes(best, idx);
  if (active && t % kNnBoundLanes == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      seed[3 * q + j] = make_float2(best[j], __int_as_float(idx[j]));
    }
  }
}

// grid (ceil(n / (kNnThreads * kNnQueries)), slices, batch): for each
// query, the lexicographic top 3 of the rows of known slice [s * per,
// (s + 1) * per) of sample b and its 3 seed rows, into part [batch,
// slices, n, 3] as (d2, index bits)
__global__ void __launch_bounds__(kNnThreads, 6) three_nn_search_kernel(
    const float* __restrict__ query, int n, const float* __restrict__ known,
    const unsigned char* __restrict__ kvalid, int m, int slices,
    const float2* __restrict__ seed, float2* __restrict__ part) {
  __shared__ float4 s_k[kNnTile];                  // x, y, z, k2
  __shared__ float s_bias[kNnTile];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int per = (m + slices - 1) / slices;
  const int k0 = min(m, s * per);
  const int k1 = min(m, k0 + per);
  const int i0 = blockIdx.x * (kNnThreads * kNnQueries) + threadIdx.x;
  float ux[kNnQueries], uy[kNnQueries], uz[kNnQueries], u2[kNnQueries];
  float best[kNnQueries][3];
  int idx[kNnQueries][3];
#pragma unroll
  for (int a = 0; a < kNnQueries; ++a) {
    const int i = i0 + a * kNnThreads;
    const long long q = static_cast<long long>(b) * n + i;
    ux[a] = i < n ? query[3 * q] : 0.0f;
    uy[a] = i < n ? query[3 * q + 1] : 0.0f;
    uz[a] = i < n ? query[3 * q + 2] : 0.0f;
    u2[a] = ux[a] * ux[a] + uy[a] * uy[a] + uz[a] * uz[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // a query past n admits no row
      const float2 e = i < n ? seed[3 * q + j] : make_float2(-INFINITY, 0.0f);
      best[a][j] = e.x;
      idx[a][j] = __float_as_int(e.y);
    }
  }
  const float* kb = known + 3LL * b * m;
  const unsigned char* vb = kvalid + static_cast<long long>(b) * m;
  for (int t0 = k0; t0 < k1; t0 += kNnTile) {
    const int len = min(kNnTile, k1 - t0);
    const int padded = (len + kNnChunk - 1) / kNnChunk * kNnChunk;
    __syncthreads();                               // the last tile is read
    for (int j = threadIdx.x; j < padded; j += kNnThreads) {
      if (j < len) {
        const float kx = kb[3LL * (t0 + j)], ky = kb[3LL * (t0 + j) + 1],
                    kz = kb[3LL * (t0 + j) + 2];
        s_k[j] = make_float4(kx, ky, kz, kx * kx + ky * ky + kz * kz);
        s_bias[j] = vb[t0 + j] ? 0.0f : kBig;
      } else {                                     // t = inf: never passes
        s_k[j] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
        s_bias[j] = 0.0f;
      }
    }
    __syncthreads();
    // the tile's chunks in bit-reversed order, so that a query's best
    // tighten early and fewer rows pass the filter
    for (int r = 0; r < kNnChunks; ++r) {
      const int c0 = (__brev(r) >> (32 - 4)) * kNnChunk;  // log2(kNnChunks)
      if (c0 >= padded) continue;
      // the filter: bit jj of mask[a] marks a row whose unclamped,
      // unbiased difference is at most the query's third best so far, a
      // superset of the rows the insertion would take
      unsigned mask[kNnQueries];
#pragma unroll
      for (int a = 0; a < kNnQueries; ++a) mask[a] = 0u;
#pragma unroll
      for (int jj = 0; jj < kNnChunk; ++jj) {
        const float4 k = s_k[c0 + jj];
#pragma unroll
        for (int a = 0; a < kNnQueries; ++a) {
          const float dot = ux[a] * k.x + uy[a] * k.y + uz[a] * k.z;
          const float t = (u2[a] + k.w) - 2.0f * dot;
          if (t <= best[a][2]) mask[a] |= 1u << jj;
        }
      }
      // the marked rows: d2 as the plain version computes it, and the
      // insertion
#pragma unroll
      for (int a = 0; a < kNnQueries; ++a) {
        while (mask[a]) {
          const int j = c0 + __ffs(mask[a]) - 1;
          mask[a] &= mask[a] - 1u;
          const float4 k = s_k[j];
          const float dot = ux[a] * k.x + uy[a] * k.y + uz[a] * k.z;
          const float t = (u2[a] + k.w) - 2.0f * dot;
          bubble3_new(best[a], idx[a], (t < 0.0f ? 0.0f : t) + s_bias[j],
                      t0 + j);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kNnQueries; ++a) {
    const int i = i0 + a * kNnThreads;
    if (i < n) {
      float2* p = part + ((static_cast<long long>(b) * slices + s) * n + i) * 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        p[j] = make_float2(best[a][j], __int_as_float(idx[a][j]));
      }
    }
  }
}

// one thread per flat query q = b * n + i (total = batch * n): the
// lexicographic top 3 of its sample's slices' partials, normalised
// inverse-distance weights, and the warp's gather of the winners' features
__global__ void three_nn_merge_kernel(const float2* __restrict__ part, int n,
                                      int m, int slices, int total,
                                      const float* __restrict__ feats, int c,
                                      float* __restrict__ out,
                                      int* __restrict__ rows,
                                      float* __restrict__ weights) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int r[3] = {0, 0, 0};
  float w[3] = {0.0f, 0.0f, 0.0f};
  if (q < total) {
    const int b = q / n;
    const int i = q - b * n;
    float best[3] = {INFINITY, INFINITY, INFINITY};
    int idx[3] = {0, 0, 0};
    for (int s = 0; s < slices; ++s) {
      const float2* p =
          part + ((static_cast<long long>(b) * slices + s) * n + i) * 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 e = p[j];
        bubble3_new(best, idx, e.x, __float_as_int(e.y));
      }
    }
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
  warp_gather_sum(feats, c, r, w, q, total, out);
}

// d_feats[rows[q, j]] += w[q, j] * d_out[q], for the block's kRingQueries
// flat queries: their rows and weights staged in shared memory, then flat
// (query, item) pairs as in the forward, kRingUnroll items a thread in
// flight; a zero weight adds nothing and a query whose weights are all
// zero (padding) reads no d_out. Vector (kVec) or scalar atomic adds, in
// an order that changes from run to run.
template <bool kVec>
__global__ void __launch_bounds__(kRingQueries) ring_interp_bwd_kernel(
    const float* __restrict__ d_out, const int* __restrict__ rows,
    const float* __restrict__ weights, int total, int c,
    float* __restrict__ d_feats) {
  __shared__ int s_row[3][kRingQueries];
  __shared__ float s_w[3][kRingQueries];
  const long long q0 = static_cast<long long>(blockIdx.x) * kRingQueries;
  const int nq = min(kRingQueries, total - static_cast<int>(q0));
  if (threadIdx.x < nq) {
    const long long q = q0 + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s_row[j][threadIdx.x] = rows[3 * q + j];
      s_w[j][threadIdx.x] = weights[3 * q + j];
    }
  }
  __syncthreads();
  const int per = kVec ? c >> 2 : c;
  const int items = nq * per;
  for (int base = threadIdx.x; base < items;
       base += kRingQueries * kRingUnroll) {
    int lq[kRingUnroll], ch[kRingUnroll];
    float4 g[kRingUnroll];
#pragma unroll
    for (int u = 0; u < kRingUnroll; ++u) {
      const int it = base + u * kRingQueries;
      lq[u] = it / per;
      ch[u] = (it - lq[u] * per) * (kVec ? 4 : 1);
      if (it < items && (s_w[0][lq[u]] != 0.0f || s_w[1][lq[u]] != 0.0f ||
                         s_w[2][lq[u]] != 0.0f)) {
        const float* src = d_out + (q0 + lq[u]) * c + ch[u];
        g[u] = kVec ? *reinterpret_cast<const float4*>(src)
                    : make_float4(*src, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kRingUnroll; ++u) {
      if (base + u * kRingQueries >= items) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float w = s_w[j][lq[u]];
        if (w == 0.0f) continue;
        float* dst =
            d_feats + static_cast<long long>(s_row[j][lq[u]]) * c + ch[u];
        if (kVec) {
          // CUDA 12's vector atomic (sm_90, global memory): one
          // reduction of four floats
          atomicAdd(reinterpret_cast<float4*>(dst), mul4(g[u], w));
        } else {
          atomicAdd(dst, g[u].x * w);
        }
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
// [batch * n, 3]. The gather moves float4s where c % 4 == 0 and feats and
// out are 16-byte aligned, single floats otherwise.
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
    const int blocks = (total + kRingQueries - 1) / kRingQueries;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = c % 4 == 0 && aligned16(feats) && aligned16(out);
#define SASSD_RING_FWD(IDX, VEC)                                          \
  ring_interp_fwd_kernel<IDX, VEC><<<blocks, kRingQueries, 0, s>>>(       \
      query, cell0, static_cast<const IDX*>(plan), batch, n, level, feats, \
      m, c, vsx, vsy, vsz, px, py, pz, origins, out, rows, weights)
    if (plan_is_i16) {
      if (vec) SASSD_RING_FWD(short, true); else SASSD_RING_FWD(short, false);
    } else {
      if (vec) SASSD_RING_FWD(int, true); else SASSD_RING_FWD(int, false);
    }
#undef SASSD_RING_FWD
  }
  return static_cast<int>(cudaGetLastError());
}

// d_out [total, c]; rows, weights [total, 3] from the forward; d_feats
// [feat_rows, c] float32, zeroed here (a memset on the stream) before the
// kernel adds into it. Vector adds where c % 4 == 0 and d_out and d_feats
// are 16-byte aligned, scalar ones otherwise.
extern "C" int sassd_ring_interp_bwd(const float* d_out, const int* rows,
                                     const float* weights, int total, int c,
                                     float* d_feats, int feat_rows,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * static_cast<size_t>(feat_rows) * c;
  if (bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(d_feats, 0, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (total > 0 && c > 0) {
    const int blocks = (total + kRingQueries - 1) / kRingQueries;
    if (c % 4 == 0 && aligned16(d_out) && aligned16(d_feats)) {
      ring_interp_bwd_kernel<true><<<blocks, kRingQueries, 0, s>>>(
          d_out, rows, weights, total, c, d_feats);
    } else {
      ring_interp_bwd_kernel<false><<<blocks, kRingQueries, 0, s>>>(
          d_out, rows, weights, total, c, d_feats);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// the queries a block of the search grid takes: the wrapper sizes the
// slice count from it
extern "C" int sassd_three_nn_queries_per_block() {
  return kNnThreads * kNnQueries;
}

// query [batch * n, 3] float32 xyz; known [batch * m, 3] float32 xyz with
// validity kvalid [batch * m] (bool bytes); feats [batch * m, c] float32;
// part [batch, slices, n, 3] and seed [batch * n, 3] pairs of 4-byte words,
// scratch (slices >= 1). Writes out [batch * n, c], rows
// [batch * n, 3] (flat feature rows, the input of sassd_ring_interp_bwd)
// and weights [batch * n, 3].
extern "C" int sassd_three_nn_fwd(const float* query, int batch, int n,
                                  const float* known,
                                  const unsigned char* kvalid, int m,
                                  int slices, const float* feats, int c,
                                  void* part, void* seed, float* out,
                                  int* rows, float* weights, void* stream) {
  if (batch > 0 && n > 0 && m > 0 && slices > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float2* p = static_cast<float2*>(part);
    const int total = batch * n;
    const int blocks = (total + kNnThreads - 1) / kNnThreads;
    const int stride = (m + kNnSample - 1) / kNnSample;
    const long long lanes = static_cast<long long>(n) * kNnBoundLanes;
    float2* sd = static_cast<float2*>(seed);
    three_nn_seed_kernel<<<dim3(static_cast<unsigned>(
                                    (lanes + kNnThreads - 1) / kNnThreads),
                                batch),
                           kNnThreads, 0, st>>>(query, n, known, kvalid, m,
                                                stride, sd);
    const int per_block = kNnThreads * kNnQueries;
    const dim3 grid((n + per_block - 1) / per_block, slices, batch);
    three_nn_search_kernel<<<grid, kNnThreads, 0, st>>>(
        query, n, known, kvalid, m, slices, sd, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    three_nn_merge_kernel<<<blocks, kNnThreads, 0, st>>>(
        p, n, m, slices, total, feats, c, out, rows, weights);
  }
  return static_cast<int>(cudaGetLastError());
}
