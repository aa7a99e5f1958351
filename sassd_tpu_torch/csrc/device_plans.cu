// K6: the device-built rulebook of the sparse backbone: per-level dense
// index maps and the 27-tap gather plans resolved through them. K13 and
// K14: the rulebook's train-only plans, the stride convs' transpose plans
// and the aux branch's ring plans.
//
// Replaces: sassd_tpu/ops/sparse.py build_index_map, lookup_dense3,
// _window_plan, build_subm_plan and build_stride_plan (the dense-index,
// windowed path that vxnet_apply takes without host plans); K13
// build_stride_plan_T, K14 build_aux_plan.
//
// Index map: map[b, key] = row for every valid row of sample b's
// key-sorted level, -1 elsewhere; [B, D * H * W] int32.
//
// Plan: for output row m with coords o on the output grid, the base cell is
// scale * o on the input grid (scale 1 for a submanifold plan, 2 for a
// stride-2 plan; padding rows have o = -1, so the base is negative). Tap
// (dz, dy, dx), row-major over {-1, 0, 1}, reads map[base + (dz, dy, dx)]
// when every coordinate of that cell is inside the input grid, and is -1
// (missing) otherwise. The x bounds are checked per tap: an x step off the
// grid would alias the neighbouring y row's cell (sparse.py:350-352). The
// output is the host rulebook's wire format, [B, 27, M_out] int32.
//
// Bound on the H100: bytes. The L0 map is 40 x 1600 x 1408 = 90.1M cells
// (360 MB per sample): the memset writes it once at ~3.35 TB/s (~0.1 ms);
// the scatter and the lookups touch only ~20000 rows x 27 taps of it.
// Design: a cudaMemsetAsync and one thread per valid row for the map; one
// thread per (sample, tap group (dz, dy), output row) for the plan, which
// reads the three x-consecutive cells of its group directly from the map.
// That is the TPU version's SASSD_WINDOW_TABLE=0 form, identical in result
// to its window-table form; the [total + 1, 3] table (~1 GB at L0) is never
// built.
//
// K13, transpose plans of levels 1-3: for input row i of level L - 1
// (cell c on its grid) and tap k (offset off_k), the row of the output
// cell (c - off_k) / 2 in level L's index map when every axis of c - off_k
// is even, non-negative and on level L's grid, else -1; [B, 27, M_{L-1}]
// int32 a level. The same function as the forward stride plan inverted
// (input row i is the tap-k input of output row o exactly when
// c = 2 * o + off_k), read from the output level's map instead: output
// rows past the level's cap are absent from it, so the cap and the banded
// stage's y limit hold. The x axis is checked on its own: a parent off the
// grid in x would alias the neighbouring y row's cell. Per axis one offset
// (c even) or two (c odd) give an integer parent, so a row has at most 8
// live taps of 27. Bound on the H100: bytes, the plans' write once (27 x 4
// B a row slot, 11.4 MB at batch 2 of the car caps, 0.0034 ms), the keys
// and the map sectors the live taps touch. Design: one launch for the
// three levels, one thread a (level, sample, input row): it decodes its
// key once, loads the map only for its live taps, then writes its 27
// entries, each store coalesced along M_{L-1}. A padding key writes -1 and
// reads no map. No memset, no forward plan: each entry is written once.

// K14, aux plans of levels 1-3: for level-0 row n with cell c0 (-1 on
// padding), the window plan of the base cell c0 >> L through level L's
// index map (-1 >> L stays -1, so padding rows are all -1); one [3, B, 27,
// M0] int32 buffer, level L at [L - 1]. It runs the window plan's lookup
// with another base cell. Bound: bytes, the plans' write (3 x 27 x M0 x 4
// B a sample, 6.5 MB at the car cap); the map reads of key-sorted
// neighbours share most of their cells. Design: one launch for the three
// levels, one thread a row (sample on the grid's y): it reads its cell
// once, and for each level issues the 27 map loads together, then writes
// the 27 taps, each store coalesced along M0. A padded row writes -1 and
// reads no map. (Issuing all 81 loads before any store took 96 registers
// and was no faster on the H100.)
//
// K17, the index-map delta update of persistent-plan serving: a map that
// lives across scans holds the previous scan's rows; the update sets
// map[prev_key] = -1 for every valid key of the previous scan, then
// map[key] = row for every valid key of this scan, ignoring INVALID_KEY and
// keys off the grid as the index map does. A key present in both scans
// must end set, so the clear is ordered before the scatter: two kernels
// in stream order in one entry point, as sassd_index_map orders its memset
// and its scatter. After the update the map is bit for bit the index map
// of this scan's keys built afresh, given that it was that of the previous
// scan's before. Replaces: sassd_tpu/serve.py _plans_from_carry's
// update_map (two scatters with mode="drop"). Bound on the H100: bytes,
// the two key arrays read once and one 32-byte sector written for each
// cleared or set key (~0.0004 ms for 20,000 + 20,000 keys at L0), where a
// fresh map writes the whole grid (360 MB at L0). Design: one thread a
// key, for the clear and for the scatter; no memset.
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;

__global__ void index_map_kernel(const int* __restrict__ keys, int m,
                                 long long total, int* __restrict__ map) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= m) return;
  const int key = keys[static_cast<long long>(b) * m + row];
  if (key == kInvalidKey || key < 0 || key >= total) return;
  map[static_cast<long long>(b) * total + key] = row;
}

// K17's clear: map[b, key] = -1 for every valid key of the previous scan.
__global__ void index_map_clear_kernel(const int* __restrict__ keys, int m,
                                       long long total, int* __restrict__ map) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (row >= m) return;
  const int key = keys[static_cast<long long>(b) * m + row];
  if (key == kInvalidKey || key < 0 || key >= total) return;
  map[static_cast<long long>(b) * total + key] = -1;
}

// The rows r[0..2] of the three x-consecutive taps of tap group g (dz, dy)
// around the base cell (z, y, x) in one sample's map mb, -1 where missing.
__device__ __forceinline__ void window_rows(const int* __restrict__ mb, int z,
                                            int y, int x, int g, int d, int h,
                                            int w, int* r) {
  r[0] = r[1] = r[2] = -1;
  const int zq = z + g / 3 - 1;
  const int yq = y + g % 3 - 1;
  if (z >= 0 && x >= 0 && x < w && zq >= 0 && zq < d && yq >= 0 && yq < h) {
    const long long q = (static_cast<long long>(zq) * h + yq) * w + x;
    if (x >= 1) r[0] = mb[q - 1];
    r[1] = mb[q];
    if (x + 1 < w) r[2] = mb[q + 1];
  }
}

// The three x-consecutive taps of tap group g (dz, dy) around the base
// cell (z, y, x) of sample b, written to plan rows 3g..3g+2 at column m.
__device__ void window_taps(const int* __restrict__ map, int b, int z, int y,
                           int x, int g, int d, int h, int w,
                           int* __restrict__ plan, int m, int m_out) {
  int r[3];
  window_rows(map + static_cast<long long>(b) * d * h * w, z, y, x, g, d, h,
              w, r);
  int* pb = plan + (static_cast<long long>(b) * 27 + 3 * g) * m_out + m;
  pb[0] = r[0];
  pb[m_out] = r[1];
  pb[2 * m_out] = r[2];
}

__global__ void window_plan_kernel(const int* __restrict__ out_keys,
                                   int m_out, int oh, int ow, int scale,
                                   const int* __restrict__ map, int d, int h,
                                   int w, int* __restrict__ plan) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;                       // tap group (dz, dy)
  const int b = blockIdx.z;
  if (m >= m_out) return;
  const int key = out_keys[static_cast<long long>(b) * m_out + m];
  int x = -1, y = -1, z = -1;
  if (key != kInvalidKey) {
    x = scale * (key % ow);
    y = scale * ((key / ow) % oh);
    z = scale * (key / (ow * oh));
  }
  window_taps(map, b, z, y, x, g, d, h, w, plan, m, m_out);
}

// The three levels' index maps and grids, passed by value.
struct AuxLevels {
  const int* map[3];
  int d[3], h[3], w[3];
};

constexpr int kAuxThreads = 128;

__global__ void __launch_bounds__(kAuxThreads)
    aux_plans_kernel(const int* __restrict__ cell0, int batch, int m0,
                     AuxLevels lv, int* __restrict__ plan) {
  const int m = blockIdx.x * kAuxThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (m >= m0) return;
  const int* c = cell0 + 3 * (static_cast<long long>(b) * m0 + m);
  const int z0 = c[0], y0 = c[1], x0 = c[2];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int d = lv.d[l], h = lv.h[l], w = lv.w[l];
    const int* mb = lv.map[l] + static_cast<long long>(b) * d * h * w;
    int r[27];
#pragma unroll
    for (int g = 0; g < 9; ++g)
      window_rows(mb, z0 >> (l + 1), y0 >> (l + 1), x0 >> (l + 1), g, d, h,
                  w, r + 3 * g);
    int* pb = plan + (static_cast<long long>(l) * batch + b) * 27 * m0 + m;
#pragma unroll
    for (int k = 0; k < 27; ++k) pb[static_cast<long long>(k) * m0] = r[k];
  }
}

// The three levels' input keys, output maps and grids, passed by value;
// level l's blocks start at block first[l] of the grid's x.
struct StrideTLevels {
  const int* keys[3];
  const int* map[3];
  int m[3], first[3];
  int d[3], h[3], w[3];
  int od[3], oh[3], ow[3];
  int* out[3];
};

constexpr int kStrideTThreads = 128;

// The parents (c - off) / 2 of axis coordinate c for off = -1, 0, 1, and
// a 3-bit mask of the live ones: even, non-negative, under n.
__device__ __forceinline__ unsigned parents(int c, int n, int* p) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int q = c - (j - 1);
    p[j] = q >> 1;
    if (q >= 0 && (q & 1) == 0 && (q >> 1) < n) live |= 1u << j;
  }
  return live;
}

__global__ void __launch_bounds__(kStrideTThreads)
    stride_plans_t_kernel(StrideTLevels lv) {
  const int blk = blockIdx.x;
  const int l = blk >= lv.first[2] ? 2 : (blk >= lv.first[1] ? 1 : 0);
  const int i = (blk - lv.first[l]) * kStrideTThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int m = lv.m[l];
  if (i >= m) return;
  const int d = lv.d[l], h = lv.h[l], w = lv.w[l];
  const int oh = lv.oh[l], ow = lv.ow[l];
  const int key = lv.keys[l][static_cast<long long>(b) * m + i];
  unsigned lz = 0, ly = 0, lx = 0;
  int pz[3], py[3], px[3];
  if (key >= 0 && static_cast<long long>(key) <
                      static_cast<long long>(d) * h * w) {
    lz = parents(key / (w * h), lv.od[l], pz);
    ly = parents((key / w) % h, oh, py);
    lx = parents(key % w, ow, px);
  }
  const int* mb =
      lv.map[l] + static_cast<long long>(b) * lv.od[l] * oh * ow;
  int r[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int jz = k / 9, jy = (k / 3) % 3, jx = k % 3;
    r[k] = -1;
    if ((lz >> jz) & (ly >> jy) & (lx >> jx) & 1u)
      r[k] = mb[(static_cast<long long>(pz[jz]) * oh + py[jy]) * ow +
                px[jx]];
  }
  int* pb = lv.out[l] + static_cast<long long>(b) * 27 * m + i;
#pragma unroll
  for (int k = 0; k < 27; ++k) pb[static_cast<long long>(k) * m] = r[k];
}

}  // namespace

// keys [batch, m] int32 (INVALID_KEY padded); map [batch, total] int32.
extern "C" int sassd_index_map(const int* keys, int batch, int m,
                               long long total, int* map, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch > 0 && total > 0) {
    cudaError_t err = cudaMemsetAsync(
        map, 0xff, sizeof(int) * static_cast<size_t>(batch) * total, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (m > 0) {
      const int threads = 256;
      const dim3 grid((m + threads - 1) / threads, batch);
      index_map_kernel<<<grid, threads, 0, s>>>(keys, m, total, map);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K17. prev_keys [batch, m_prev] and keys [batch, m] int32 (INVALID_KEY
// padded); map [batch, total] int32, the index map of prev_keys, updated
// in place to that of keys.
extern "C" int sassd_index_map_update(const int* prev_keys, int m_prev,
                                      const int* keys, int m, int batch,
                                      long long total, int* map,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (batch > 0 && total > 0) {
    if (m_prev > 0) {
      const dim3 grid((m_prev + threads - 1) / threads, batch);
      index_map_clear_kernel<<<grid, threads, 0, s>>>(prev_keys, m_prev,
                                                      total, map);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (m > 0) {
      const dim3 grid((m + threads - 1) / threads, batch);
      index_map_kernel<<<grid, threads, 0, s>>>(keys, m, total, map);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out_keys [batch, m_out] int32 on the output grid (od, oh, ow); map
// [batch, d * h * w] int32 of the input grid; plan [batch, 27, m_out].
extern "C" int sassd_window_plan(const int* out_keys, int batch, int m_out,
                                 int oh, int ow, int scale, const int* map,
                                 int d, int h, int w, int* plan,
                                 void* stream) {
  if (batch > 0 && m_out > 0) {
    const int threads = 256;
    const dim3 grid((m_out + threads - 1) / threads, 9, batch);
    window_plan_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        out_keys, m_out, oh, ow, scale, map, d, h, w, plan);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys0..2 [batch, mL] int32 input keys of levels 0-2 (INVALID_KEY
// padded) on the grids (dL, hL, wL); map1..3 [batch, dL * hL * wL] int32
// index maps of levels 1-3; plan_t1..3 [batch, 27, m_{L-1}] int32.
extern "C" int sassd_stride_plans_t(const int* keys0, const int* keys1,
                                    const int* keys2, const int* map1,
                                    const int* map2, const int* map3,
                                    int batch, int m0, int m1, int m2, int d0,
                                    int h0, int w0, int d1, int h1, int w1,
                                    int d2, int h2, int w2, int d3, int h3,
                                    int w3, int* plan_t1, int* plan_t2,
                                    int* plan_t3, void* stream) {
  StrideTLevels lv = {{keys0, keys1, keys2}, {map1, map2, map3}, {m0, m1, m2},
                      {0, 0, 0}, {d0, d1, d2}, {h0, h1, h2}, {w0, w1, w2},
                      {d1, d2, d3}, {h1, h2, h3}, {w1, w2, w3},
                      {plan_t1, plan_t2, plan_t3}};
  int blocks = 0;
  for (int l = 0; l < 3; ++l) {
    lv.first[l] = blocks;
    blocks += (lv.m[l] + kStrideTThreads - 1) / kStrideTThreads;
  }
  if (batch > 0 && blocks > 0) {
    const dim3 grid(blocks, batch);
    stride_plans_t_kernel<<<grid, kStrideTThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(lv);
  }
  return static_cast<int>(cudaGetLastError());
}

// cell0 [batch, m0, 3] int32 level-0 zyx cells (-1 padding); map1..map3
// [batch, dL * hL * wL] int32 of levels 1-3; plan [3, batch, 27, m0].
extern "C" int sassd_aux_plans(const int* cell0, int batch, int m0,
                               const int* map1, const int* map2,
                               const int* map3, int d1, int h1, int w1,
                               int d2, int h2, int w2, int d3, int h3, int w3,
                               int* plan, void* stream) {
  if (batch > 0 && m0 > 0) {
    const AuxLevels lv = {{map1, map2, map3}, {d1, d2, d3}, {h1, h2, h3},
                          {w1, w2, w3}};
    const dim3 grid((m0 + kAuxThreads - 1) / kAuxThreads, batch);
    aux_plans_kernel<<<grid, kAuxThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(cell0, batch, m0,
                                                            lv, plan);
  }
  return static_cast<int>(cudaGetLastError());
}
